"""Synthetic node-classification datasets written as artifacts.

Stands in for a real dataset at its full width: the graph arrays come from
the caller (e.g. ``benchmarks/torch_baseline.build_workload``, the
DMG-scale bench graph), the training labels are the caller's, and
validation and test labels are drawn from the remaining nodes with a
seeded generator. :func:`multimodal_features` draws literal features in
the artifact's encoding-set layout (``[encodings, node_idx,
seq_lengths]`` per set): numbers, years at the temporal encoder's width
and byte-token strings.
"""

from __future__ import annotations

import numpy as np

from mrgcn_tpu.data import artifact as artifact_io
from mrgcn_tpu.encodings.structure import GraphStructure
from mrgcn_tpu.encodings.xsd.string import ByteTokenizer

# feature width of an encoded xsd:gYear
# (mrgcn_tpu/encodings/xsd/temporal.py: sign, century, decade and year
# on the unit circle)
GYEAR_WIDTH = 6


def multimodal_features(num_nodes: int, seed: int = 0,
                        num_numeric: int = 20_000, num_years: int = 10_000,
                        num_strings: int = 8_000,
                        max_len: int = 128) -> dict:
    """``F`` with one encoding set each of ``xsd.numeric`` (one standard
    normal per node), ``xsd.gYear`` (``GYEAR_WIDTH`` values in [-1, 1])
    and ``xsd.string`` (byte tokens, lengths uniform in [1, max_len]), on
    distinct random nodes per set, from ``seed``. The default counts are
    ``benchmarks/bench_suite.multimodal_workload``'s."""
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
    return {
        "xsd.numeric": [[numeric, nodes(num_numeric),
                         np.ones(num_numeric, np.int32)]],
        "xsd.gYear": [[years, nodes(num_years),
                       np.full(num_years, GYEAR_WIDTH, np.int32)]],
        "xsd.string": [[strings, nodes(num_strings),
                        lengths.astype(np.int32)]],
    }


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
