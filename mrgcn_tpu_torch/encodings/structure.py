"""Graph structure: relation-partitioned COO adjacency.

The port's copy of the run-time part of
:mod:`mrgcn_tpu.encodings.structure`: :class:`GraphStructure`,
:func:`compute_norm` and :func:`group_by_relation`. Building the structure
from a parsed knowledge graph (``generate``) belongs to the ETL, which is
not ported; artifacts written by ``mrgcn_tpu.mkdataset`` carry it.

The graph is kept as flat edge arrays ``(src, dst, rel, norm)``; ``norm``
is the per-relation in-row degree normalisation ``D^-1 A``
(reference: mrgcn/encodings/graph_structure.py:162-169); the self-loop
relation comes last and has norm 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class GraphStructure:
    """Relation-partitioned COO adjacency with precomputed D^-1 weights.

    ``num_relations`` counts forward (+ inverse) property relations plus the
    trailing self-loop relation, i.e. it equals ``A.shape[1] / num_nodes`` of
    the reference's hstacked matrix
    (reference: mrgcn/tasks/node_classification.py:396).
    """

    num_nodes: int
    num_relations: int
    src: np.ndarray   # (E,) int32 — message destination row (triple subject)
    dst: np.ndarray   # (E,) int32 — message source column (triple object)
    rel: np.ndarray   # (E,) int32 — relation index in [0, num_relations)
    norm: np.ndarray  # (E,) float32 — 1/rowdegree within the relation
    nodes_map: Dict = field(repr=False, default_factory=dict)
    properties_map: Dict = field(repr=False, default_factory=dict)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def flat_col(self) -> np.ndarray:
        """Column index into the reference's flattened ``(R*n)`` layout:
        ``rel * num_nodes + dst``."""
        return self.rel.astype(np.int64) * self.num_nodes + \
            self.dst.astype(np.int64)

    def to_scipy_hstack(self):
        """Densifiable ``n x (R*n)`` CSR, for parity tests against the
        reference layout (reference: graph_structure.py:38)."""
        import scipy.sparse as sp
        return sp.csr_matrix(
            (self.norm, (self.src.astype(np.int64), self.flat_col())),
            shape=(self.num_nodes, self.num_relations * self.num_nodes))



def compute_norm(src: np.ndarray, rel: np.ndarray, num_nodes: int,
                 num_relations: int) -> np.ndarray:
    """Per-relation row normalisation ``1 / rowdegree``
    (reference: graph_structure.py:162-169), in O(E) memory."""
    key = rel.astype(np.int64) * num_nodes + src.astype(np.int64)
    _, inverse, counts = np.unique(key, return_inverse=True,
                                   return_counts=True)
    return (1.0 / counts[inverse]).astype(np.float32)



@dataclass
class RelationGrouping:
    """Edges reordered by relation and padded so every fixed-size group of
    ``group_size`` consecutive edges shares one relation.

    Lets the dense-feature R-GCN layer run as one batched matmul:
    ``H[dst]`` gathered per group, multiplied by the group's composed
    weight (see :func:`mrgcn_tpu_torch.ops.rspmm.transform_aggregate_grouped`).
    Padding slots carry ``norm == 0`` and scatter out of range.
    """

    src: np.ndarray        # (E',) int32, E' = num_groups * group_size
    dst: np.ndarray        # (E',) int32
    norm: np.ndarray       # (E',) float32 (0 on padding)
    group_rel: np.ndarray  # (num_groups,) int32 — relation of each group
    group_size: int

    @property
    def num_groups(self) -> int:
        return len(self.group_rel)


def group_by_relation(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
                      norm: np.ndarray, num_out: int,
                      group_size: int = 128) -> RelationGrouping:
    """Sort edges by relation; pad each relation's run to a multiple of
    ``group_size`` (the JAX package's defaults: 128 for full-batch edges,
    64 for restricted and sampled ones, which halves their padding)."""
    if len(src) == 0:
        # an empty hop (e.g. a neighbour-sampled frontier of leaves) keeps
        # degenerate-but-valid shapes; callers bucket the group count up
        return RelationGrouping(
            src=np.empty(0, dtype=np.int32), dst=np.empty(0, dtype=np.int32),
            norm=np.empty(0, dtype=np.float32),
            group_rel=np.empty(0, dtype=np.int32), group_size=group_size)

    order = np.argsort(rel, kind="stable")
    src, dst, rel, norm = src[order], dst[order], rel[order], norm[order]

    rels, counts = np.unique(rel, return_counts=True)
    out_src: List[np.ndarray] = []
    out_dst: List[np.ndarray] = []
    out_norm: List[np.ndarray] = []
    group_rel: List[np.ndarray] = []

    start = 0
    for r, count in zip(rels, counts):
        stop = start + int(count)
        padded = -(-int(count) // group_size) * group_size
        pad = padded - int(count)
        out_src.append(src[start:stop])
        out_dst.append(dst[start:stop])
        out_norm.append(norm[start:stop])
        if pad:
            out_src.append(np.full(pad, num_out, dtype=np.int32))  # dropped
            out_dst.append(np.zeros(pad, dtype=np.int32))
            out_norm.append(np.zeros(pad, dtype=np.float32))
        group_rel.append(np.full(padded // group_size, r, dtype=np.int32))
        start = stop

    return RelationGrouping(
        src=np.concatenate(out_src), dst=np.concatenate(out_dst),
        norm=np.concatenate(out_norm),
        group_rel=np.concatenate(group_rel), group_size=group_size)
