"""Synthetic node-classification datasets written as artifacts.

Stands in for a real dataset at its full width: the graph arrays come from
the caller (e.g. ``benchmarks/torch_baseline.build_workload``, the
DMG-scale bench graph), the training labels are the caller's, and
validation and test labels are drawn from the remaining nodes with a
seeded generator.
"""

from __future__ import annotations

import numpy as np

from mrgcn_tpu.data import artifact as artifact_io
from mrgcn_tpu.encodings.structure import GraphStructure


def save_nc_artifact(path: str, num_nodes: int, num_relations: int,
                     src, dst, rel, norm, train_nodes, train_classes,
                     num_classes: int, seed: int = 0,
                     num_eval: int = 1000) -> None:
    """Write a featureless NC artifact (``F = {}``) with ``train`` =
    the given labels and ``valid``/``test`` = ``num_eval`` unlabelled
    nodes each, classes uniform over ``num_classes``."""
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
    artifact_io.save(path, structure, {}, Y=Y, sample_map=sample_map,
                     class_map=[f"class{c}" for c in range(num_classes)])
