"""Synthetic node-classification and link-prediction datasets written as
artifacts.

Stands in for a real dataset at its full width: the graph arrays come from
the caller (e.g. ``benchmarks/torch_baseline.build_workload``, the
DMG-scale bench graph), the training labels are the caller's, and
validation and test labels are drawn from the remaining nodes with a
seeded generator. :func:`multimodal_features` draws literal features in
the artifact's encoding-set layout (``[encodings, node_idx,
seq_lengths]`` per set): numbers, years at the temporal encoder's width,
byte-token strings and, when asked for, WKT geometries as ``(9, n)``
point sets and uint8 images. :func:`save_lp_artifact` draws a link-prediction
graph at FB15k-237's published sizes.
"""

from __future__ import annotations

import numpy as np

from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.encodings.structure import GraphStructure, compute_norm
from mrgcn_tpu_torch.encodings.xsd.string import ByteTokenizer

# feature width of an encoded xsd:gYear
# (mrgcn_tpu/encodings/xsd/temporal.py: sign, century, decade and year
# on the unit circle)
GYEAR_WIDTH = 6
# rows of an encoded WKT point (mrgcn_tpu/encodings/ogc/wkt.py: the
# geometry's mean x / y, then x, y, is_point, is_exterior_ring,
# is_interior_ring, sub_stop, full_stop) and the reference's cap on points
# (reference: wktLiteral.py:20)
WKT_ROWS, WKT_MAX_POINTS = 9, 64


def multimodal_features(num_nodes: int, seed: int = 0,
                        num_numeric: int = 20_000, num_years: int = 10_000,
                        num_strings: int = 8_000,
                        max_len: int = 128, num_geometries: int = 0,
                        num_images: int = 0, image_size: int = 224,
                        geometry_points=(4, WKT_MAX_POINTS)) -> dict:
    """``F`` with one encoding set each of ``xsd.numeric`` (one standard
    normal per node), ``xsd.gYear`` (``GYEAR_WIDTH`` values in [-1, 1])
    and ``xsd.string`` (byte tokens, lengths uniform in [1, max_len]), on
    distinct random nodes per set, from ``seed``. The default counts are
    ``benchmarks/bench_suite.multimodal_workload``'s.

    With ``num_geometries`` > 0, an ``ogc.wktLiteral`` set of polygons
    laid out as the vectorizer writes them: ``(WKT_ROWS, n)`` float32
    arrays of ``n`` points, uniform in ``geometry_points`` (a random walk
    in x / y, the mean rows, the exterior-ring flag, the full stop on the
    last point), lengths beside them; with ``num_images`` > 0, a
    ``blob.image`` set of ``(3, image_size, image_size)`` uint8 images.
    Both counts default to 0 and are drawn after the other sets, so those
    stay as they were."""
    rng = np.random.default_rng(seed)

    def nodes(k):
        return np.sort(rng.choice(num_nodes, k, replace=False)).astype(
            np.int32)

    numeric = rng.standard_normal((num_numeric, 1)).astype(np.float32)
    years = rng.uniform(-1.0, 1.0, (num_years, GYEAR_WIDTH)).astype(
        np.float32)
    lengths = rng.integers(1, max_len + 1, num_strings)
    tokens = rng.integers(0, ByteTokenizer.PAD, int(lengths.sum())).astype(
        np.int32)
    strings = np.empty(num_strings, dtype=object)
    for i, part in enumerate(np.split(tokens, np.cumsum(lengths)[:-1])):
        strings[i] = part
    F = {
        "xsd.numeric": [[numeric, nodes(num_numeric),
                         np.ones(num_numeric, np.int32)]],
        "xsd.gYear": [[years, nodes(num_years),
                       np.full(num_years, GYEAR_WIDTH, np.int32)]],
        "xsd.string": [[strings, nodes(num_strings),
                        lengths.astype(np.int32)]],
    }
    if num_geometries > 0:
        lo, hi = geometry_points
        points = rng.integers(lo, hi + 1, num_geometries)
        geometries = np.empty(num_geometries, dtype=object)
        for i, n in enumerate(points):
            g = np.zeros((WKT_ROWS, n), np.float32)
            g[2:4] = np.cumsum(rng.standard_normal((2, n)), axis=1) * 0.1
            g[0:2] = g[2:4].mean(axis=1, keepdims=True)
            g[5] = 1.0                          # exterior ring
            g[8, -1] = 1.0                      # full stop
            geometries[i] = g
        F["ogc.wktLiteral"] = [[geometries, nodes(num_geometries),
                                points.astype(np.int32)]]
    if num_images > 0:
        images = rng.integers(0, 256, (num_images, 3, image_size,
                                       image_size), dtype=np.uint8)
        F["blob.image"] = [[images, nodes(num_images),
                            -np.ones(num_images, np.float32)]]
    return F


def save_nc_artifact(path: str, num_nodes: int, num_relations: int,
                     src, dst, rel, norm, train_nodes, train_classes,
                     num_classes: int, seed: int = 0,
                     num_eval: int = 1000, F=None) -> None:
    """Write an NC artifact with ``train`` = the given labels and
    ``valid``/``test`` = ``num_eval`` unlabelled nodes each, classes
    uniform over ``num_classes``. ``F``: the literal features
    (e.g. :func:`multimodal_features`); none by default."""
    rng = np.random.default_rng(seed)
    train_nodes = np.asarray(train_nodes, dtype=np.int64)
    rest = np.setdiff1d(np.arange(num_nodes), train_nodes)
    picked = rng.choice(rest, 2 * num_eval, replace=False)
    classes = rng.integers(0, num_classes, 2 * num_eval)

    def rows(nodes, cls):
        return np.stack([nodes, cls], axis=1).astype(np.int32)

    Y = {"train": rows(train_nodes, np.asarray(train_classes)),
         "valid": rows(picked[:num_eval], classes[:num_eval]),
         "test": rows(picked[num_eval:], classes[num_eval:])}
    structure = GraphStructure(
        num_nodes=int(num_nodes), num_relations=int(num_relations),
        src=np.asarray(src, np.int32), dst=np.asarray(dst, np.int32),
        rel=np.asarray(rel, np.int32), norm=np.asarray(norm, np.float32))
    sample_map = {split: [f"node{int(i)}" for i in y[:, 0]]
                  for split, y in Y.items()}
    artifact_io.save(path, structure, F or {}, Y=Y, sample_map=sample_map,
                     class_map=[f"class{c}" for c in range(num_classes)])


# FB15k-237's published sizes (Toutanova and Chen 2015): entities,
# properties, and train / valid / test triples
FB15K237 = {"num_nodes": 14_541, "num_props": 237, "train": 272_115,
            "valid": 17_535, "test": 20_466}


def save_lp_artifact(path: str, num_nodes: int = FB15K237["num_nodes"],
                     num_props: int = FB15K237["num_props"],
                     num_train: int = FB15K237["train"],
                     num_valid: int = FB15K237["valid"],
                     num_test: int = FB15K237["test"],
                     seed: int = 0) -> None:
    """Write a link-prediction artifact of uniformly random triples at
    FB15k-237's sizes (the defaults) from a seeded numpy generator.

    The graph is built from the train triples as the ETL builds it: one
    relation per property, then the inverses, then the self-loop, so
    ``num_relations = 2 * num_props + 1`` (475), with the per-relation
    row normalisation. Valid and test triples are drawn the same way and
    stay out of the graph."""
    rng = np.random.default_rng(seed)

    def triples(count):
        return np.stack([rng.integers(0, num_nodes, count),
                         rng.integers(0, num_props, count),
                         rng.integers(0, num_nodes, count)],
                        axis=1).astype(np.int32)

    data = {"train": triples(num_train), "valid": triples(num_valid),
            "test": triples(num_test)}
    s, p, o = data["train"].T
    loops = np.arange(num_nodes, dtype=np.int32)
    num_relations = 2 * num_props + 1
    src = np.concatenate([s, o, loops]).astype(np.int32)
    dst = np.concatenate([o, s, loops]).astype(np.int32)
    rel = np.concatenate([p, p + num_props,
                          np.full(num_nodes, 2 * num_props)]
                         ).astype(np.int32)
    structure = GraphStructure(
        num_nodes=int(num_nodes), num_relations=num_relations, src=src,
        dst=dst, rel=rel,
        norm=compute_norm(src, rel, num_nodes, num_relations))
    artifact_io.save(path, structure, {}, data=data)
