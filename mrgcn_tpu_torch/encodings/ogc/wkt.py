"""OGC wktLiteral vectorizer (geometries as point sequences).

The port's copy of :mod:`mrgcn_tpu.encodings.ogc.wkt`.

The reference vectorizes WKT with the ``deep_geometry`` package into per-point
7-dim vectors, prepends two rows holding the geometry's mean x/y, caps at 64
points, and scales coordinates by a localized-mean / std-of-minmax scheme
(reference: mrgcn/encodings/ogc/wktLiteral.py:20-21, 60-113, 129-197).

Without ``deep_geometry``, this module implements its own WKT parser and an equivalent 7-dim point layout::

    [x, y, is_point, is_exterior_ring, is_interior_ring, sub_stop, full_stop]

with the properties the downstream scaler and CNN rely on: coordinates in the
first two dims and the full-stop flag (1.0 on the geometry's final point) in
the last dim. After prepending the two mean dims the final layout is
``(9, L)`` with coordinates at rows 2:4 — identical in shape and semantics to
the reference's CNN input (time on the last axis).
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mrgcn_tpu_torch.data.rdf import OGC
from mrgcn_tpu_torch.encodings.common import literal_nodes

logger = logging.getLogger(__name__)

MAX_POINTS = 64
VEC_LENGTH = 7  # per-point dims before the two prepended mean rows
FULL_STOP_INDEX = -1

_NUM = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"
_COORD_RE = re.compile(rf"({_NUM})\s+({_NUM})")


def _parse_rings(body: str) -> List[List[Tuple[float, float]]]:
    """Split a parenthesized coordinate body into rings of (x, y) pairs."""
    rings: List[List[Tuple[float, float]]] = []
    depth_buf = ""
    depth = 0
    for ch in body:
        if ch == "(":
            depth += 1
            depth_buf = ""
        elif ch == ")":
            depth -= 1
            if depth_buf.strip():
                rings.append([(float(x), float(y))
                              for x, y in _COORD_RE.findall(depth_buf)])
            depth_buf = ""
        else:
            depth_buf += ch
    if not rings and body.strip():
        rings.append([(float(x), float(y))
                      for x, y in _COORD_RE.findall(body)])
    return rings


def vectorize_wkt(wkt: str) -> np.ndarray:
    """WKT string → ``(L, 7)`` float array (own deep_geometry equivalent)."""
    wkt = wkt.strip()
    # strip an optional CRS prefix: "<IRI> POINT(...)"
    if wkt.startswith("<"):
        wkt = wkt.split(">", 1)[1].strip()

    m = re.match(r"([A-Za-z]+)\s*(\(.*\))\s*$", wkt, re.DOTALL)
    if m is None:
        raise ValueError(f"unparseable WKT: {wkt[:80]!r}")
    geom_type = m.group(1).upper()
    body = m.group(2)

    rows: List[List[float]] = []
    if geom_type in ("POINT", "MULTIPOINT"):
        rings = _parse_rings(body)
        points = [pt for ring in rings for pt in ring]
        for x, y in points:
            rows.append([x, y, 1.0, 0.0, 0.0, 0.0, 0.0])
    elif geom_type in ("LINESTRING", "MULTILINESTRING"):
        rings = _parse_rings(body)
        for ring in rings:
            for j, (x, y) in enumerate(ring):
                sub = 1.0 if j == len(ring) - 1 else 0.0
                rows.append([x, y, 0.0, 1.0, 0.0, sub, 0.0])
    elif geom_type in ("POLYGON", "MULTIPOLYGON"):
        rings = _parse_rings(body)
        for k, ring in enumerate(rings):
            exterior = 1.0 if k == 0 else 0.0
            for j, (x, y) in enumerate(ring):
                sub = 1.0 if j == len(ring) - 1 else 0.0
                rows.append([x, y, 0.0, exterior, 1.0 - exterior, sub, 0.0])
    else:
        raise ValueError(f"unsupported WKT geometry: {geom_type}")

    if not rows:
        raise ValueError("empty geometry")

    rows[-1][5] = 0.0  # final point carries the full stop, not a sub stop
    rows[-1][6] = 1.0
    return np.asarray(rows, dtype=np.float32)


class GeomScaler:
    """Localized-mean + std-of-minmax scaling over dense ``(9, L)`` arrays
    (reference: wktLiteral.py:129-197, time_dim == 1 layout: coordinates at
    rows 2:4, full stop at the last row)."""

    def __init__(self):
        self.scale_factor = 1.0

    @staticmethod
    def full_stop_index(geometry: np.ndarray) -> int:
        stops = np.flatnonzero(geometry[FULL_STOP_INDEX, :] == 1.0)
        idx = int(stops[0]) if stops.size else geometry.shape[1]
        return 1 if idx == 0 else idx

    def localized_mean(self, geometry: np.ndarray) -> np.ndarray:
        stop = self.full_stop_index(geometry)
        return geometry[2:4, :stop].mean(axis=1, keepdims=True)

    def fit(self, geometries: Sequence[np.ndarray]) -> List[np.ndarray]:
        means = [self.localized_mean(g) for g in geometries]
        min_maxs = []
        for g, mean in zip(geometries, means):
            stop = self.full_stop_index(g)
            coords = g[2:4, :stop]
            min_maxs.append([float((coords - mean).min()),
                             float((coords - mean).max())])
        self.scale_factor = float(np.std(min_maxs))
        return means

    def transform(self, geometries: Sequence[np.ndarray],
                  means: Sequence[np.ndarray]) -> List[np.ndarray]:
        out = []
        for g, mean in zip(geometries, means):
            stop = self.full_stop_index(g) + 1
            g = g.copy()
            g[2:4, :stop] -= mean
            g[2:4, :stop] /= self.scale_factor
            out.append(g)
        return out


def generate_features(nodes_map: Dict, node_predicate_map: Dict,
                      config: Dict) -> Optional[List]:
    wkt_datatype = OGC + "wktLiteral"

    data: Dict[object, List[np.ndarray]] = {}
    node_idx: Dict[object, List[int]] = {}
    lengths: Dict[object, List[int]] = {}

    failed = 0
    for node, i in literal_nodes(nodes_map, wkt_datatype):
        try:
            vec = vectorize_wkt(str(node))[:MAX_POINTS, :]
        except (ValueError, IndexError):
            failed += 1
            continue
        L = vec.shape[0]
        if L <= 0:
            failed += 1
            continue

        # prepend mean-x / mean-y rows, transpose to (9, L) CNN layout
        # (reference: wktLiteral.py:73-81)
        mean_xy = np.tile(vec[:, :2].mean(axis=0), (L, 1))
        a = np.hstack([mean_xy, vec]).T.astype(np.float32)

        for p in node_predicate_map.get(node, ()):
            data.setdefault(p, []).append(a)
            node_idx.setdefault(p, []).append(i)
            lengths.setdefault(p, []).append(L)

    total = sum(len(v) for v in data.values())
    logger.debug("Generated %d unique wktLiteral features (%d failed)",
                 total, failed)
    if total <= 0:
        return None

    out = []
    for p, geoms in data.items():
        scaler = GeomScaler()
        means = scaler.fit(geoms)
        scaled = scaler.transform(geoms, means)
        ragged = np.empty(len(scaled), dtype=object)
        for j, g in enumerate(scaled):
            ragged[j] = g
        out.append([ragged,
                    np.asarray(node_idx[p], dtype=np.int32),
                    np.asarray(lengths[p], dtype=np.int32)])
    return out
