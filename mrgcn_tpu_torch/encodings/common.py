"""Shared machinery for the per-datatype vectorizers.

The port's copy of :mod:`mrgcn_tpu.encodings.common`.

Every vectorizer produces the reference's *encoding-set contract*
(reference: mrgcn/encodings/graph_features.py:52-57): for each predicate that
links to nodes of the datatype, a triple ``[enc, node_idx, seq_lengths]``
where ``enc`` holds the vectorised features (dense ``(M, C)`` array for
fixed-width modalities; a ragged list for sequences), ``node_idx`` maps rows
to global node indices, and ``seq_lengths`` gives per-row sequence lengths.

The reference repeats the per-predicate grouping + min/max normalisation
boilerplate in every module; here it is factored into
:class:`RelationwiseCollector`.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from mrgcn_tpu_torch.data.rdf import Literal

logger = logging.getLogger(__name__)

EncodingSet = List  # [enc, node_idx, seq_lengths]


class IndexedNodesMap(dict):
    """``nodes_map`` plus a one-pass literal index (datatype IRI ->
    ``[(literal, node_index)]`` in node-index order; untyped literals
    under key ``None``), so that each selector reads its buckets instead
    of scanning the whole nodes_map. Built by ``construct_features``; the
    selectors take nothing else."""

    __slots__ = ("literal_index",)

    @classmethod
    def build(cls, nodes_map: Dict) -> "IndexedNodesMap":
        self = cls(nodes_map)
        index: Dict[Optional[str], List] = {}
        for node, i in nodes_map.items():
            if isinstance(node, Literal):
                index.setdefault(node.datatype, []).append((node, i))
        self.literal_index = index
        return self


def _merged_buckets(buckets) -> Iterator[Tuple[Literal, int]]:
    """Merge per-datatype buckets back into node-index order — the order
    the reference's full scan of ``nodes_map`` yields, and so the row order
    inside its encoding sets."""
    import heapq
    return heapq.merge(*buckets, key=lambda pair: pair[1])


def literal_nodes(nodes_map: IndexedNodesMap, datatypes
                  ) -> Iterator[Tuple[Literal, int]]:
    """Yield ``(literal, node_index)`` for literals whose datatype is in
    ``datatypes`` (a str or set of str IRIs)
    (reference: e.g. xsd/numeric.py:165-173)."""
    if isinstance(datatypes, str):
        datatypes = {datatypes}
    index = nodes_map.literal_index
    buckets = [index[dt] for dt in datatypes if dt in index]
    yield from (buckets[0] if len(buckets) == 1
                else _merged_buckets(buckets))


def plain_string_nodes(nodes_map: IndexedNodesMap, string_datatype: str
                       ) -> Iterator[Tuple[Literal, int]]:
    """String-literal selector: matches ``xsd:string``-typed literals *and*
    untyped literals carrying a language tag
    (reference: xsd/string.py:102-110)."""
    index = nodes_map.literal_index
    tagged = [pair for pair in index.get(None, ())
              if pair[0].language is not None]
    yield from _merged_buckets([index.get(string_datatype, ()), tagged])


class RelationwiseCollector:
    """Groups fixed-width feature vectors per linking predicate and applies
    optional per-predicate min/max scaling of one column to ``[-1, 1]``
    (reference: xsd/numeric.py:100-160, xsd/date.py:63-140)."""

    def __init__(self):
        self._rows: Dict[object, List[np.ndarray]] = {}
        self._idx: Dict[object, List[int]] = {}

    def add(self, predicates: Iterable, vector, node_index: int) -> None:
        vec = np.asarray(vector, dtype=np.float32)
        for p in predicates:
            self._rows.setdefault(p, []).append(vec)
            self._idx.setdefault(p, []).append(node_index)

    def __len__(self) -> int:
        return sum(len(v) for v in self._rows.values())

    def finalize(self, seq_length_value: float,
                 normalize_col: Optional[int] = None
                 ) -> Optional[List[EncodingSet]]:
        """Emit encoding sets, each row's sequence length
        ``seq_length_value``. ``normalize_col`` min/max-scales that column to
        [-1, 1] per predicate (constant columns map to 0.0); numeric passes
        0 for its single column."""
        if len(self) == 0:
            return None

        out: List[EncodingSet] = []
        for p, rows in self._rows.items():
            enc = np.stack(rows).astype(np.float32)
            if normalize_col is not None:
                col = enc[:, normalize_col]
                lo, hi = float(col.min()), float(col.max())
                if hi == lo:
                    enc[:, normalize_col] = 0.0
                else:
                    enc[:, normalize_col] = 2 * (col - lo) / (hi - lo) - 1.0
            node_idx = np.asarray(self._idx[p], dtype=np.int32)
            out.append([enc, node_idx,
                        np.full(enc.shape[0], seq_length_value,
                                dtype=np.float32)])
        return out
