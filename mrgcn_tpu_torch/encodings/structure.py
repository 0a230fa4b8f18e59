"""Graph structure: relation-partitioned COO adjacency.

The port's copy of :mod:`mrgcn_tpu.encodings.structure`:
:class:`GraphStructure`, :func:`generate` (the ETL's build of it from a
parsed knowledge graph), :func:`compute_norm` and
:func:`group_by_relation`. The JAX copy's ``pad_edges`` has no
counterpart: no module calls it, and the device mesh pads its edges
through :func:`mrgcn_tpu_torch.parallel.mesh.pad_edges_for_mesh`.

Semantics preserved exactly:
  * deterministic node order: atoms in first-appearance order, then a
    stable sort by string form (reference: graph_structure.py:16-20);
  * relation order: properties sorted by string form; for each included
    property the forward relation, then (optionally) its inverse; the
    self-loop identity relation last (reference: graph_structure.py:33-38,
    78-106).

The graph is kept as flat edge arrays ``(src, dst, rel, norm)``; ``norm``
is the per-relation in-row degree normalisation ``D^-1 A``
(reference: mrgcn/encodings/graph_structure.py:162-169); the self-loop
relation comes last and has norm 1.
"""

from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from mrgcn_tpu_torch.data.kg import KnowledgeGraph

logger = logging.getLogger(__name__)


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


def generate(kg: KnowledgeGraph, config: dict) -> Tuple[GraphStructure,
                                                        Dict, Dict]:
    """Build the graph structure from a knowledge graph.

    Returns ``(structure, nodes_map, properties_map)`` where ``properties_map``
    enumerates *all* properties (including excluded ones) in sorted order —
    the reference does the same and uses it as the edge index for link
    prediction (reference: graph_structure.py:16-17, mkdataset.py:49-57).
    """
    structural = config["graph"]["structural"]
    separate_literals = structural["separate_literals"]
    include_inverse = structural["include_inverse_properties"]
    exclude_properties = set(structural.get("exclude_properties", []))

    # columnar scan: one zip over the triple set instead of per-triple
    # generators (~4x on the whole generate() at 160k triples)
    s_col, p_col, o_col = kg.columns()
    properties = sorted(set(p_col), key=str)
    properties_map = {p: i for i, p in enumerate(properties)}

    if separate_literals:
        atoms = KnowledgeGraph.sort_atoms(kg.atoms(True))
    else:
        # same dedup semantics AND ORDER as atoms(False) (s, o per triple,
        # first appearance), C-speed via dict.fromkeys. Order matters:
        # sort_atoms is a stable str-keyed sort, so atoms whose str() ties
        # (e.g. "2000"^^gYear vs "2000"^^integer) keep their encounter
        # order — a plain set here would make node indexing follow the
        # interpreter's randomized str hashing.
        interleaved = itertools.chain.from_iterable(zip(s_col, o_col))
        atoms = KnowledgeGraph.sort_atoms(dict.fromkeys(interleaved))
    nodes_map = {node: i for i, node in enumerate(atoms)}
    num_nodes = len(nodes_map)

    included = [p for p in properties if str(p) not in exclude_properties
                and p not in exclude_properties]
    included_rank = {p: k for k, p in enumerate(included)}
    rel_stride = 2 if include_inverse else 1
    num_relations = len(included) * rel_stride + 1  # + self-loop identity

    logger.debug("Generating %d relation partitions over %d nodes",
                 num_relations, num_nodes)

    # Single pass over the triples: map to (s, k, o) index rows, then group
    # per relation with numpy. (The reference re-scans the whole graph once
    # per property — reference: graph_structure.py:78-91 — and offers a
    # multiprocessing pool to compensate; one pass makes that moot, so the
    # flag is read and has no effect.)
    if structural.get("multiprocessing", False):
        logger.debug("multiprocessing = true has no effect: the structure "
                     "is built in one columnar pass")
    s_idx, k_idx, o_idx = _index_triples(kg, nodes_map, included_rank,
                                         separate_literals)

    src_parts: List[np.ndarray] = []
    dst_parts: List[np.ndarray] = []
    rel_parts: List[np.ndarray] = []
    if len(s_idx):
        order = np.argsort(k_idx, kind="stable")
        s_sorted, k_sorted, o_sorted = s_idx[order], k_idx[order], \
            o_idx[order]
        src_parts.append(s_sorted)
        dst_parts.append(o_sorted)
        rel_parts.append(k_sorted * rel_stride)
        if include_inverse:
            src_parts.append(o_sorted)
            dst_parts.append(s_sorted)
            rel_parts.append(k_sorted * rel_stride + 1)

    # Self-loop identity relation, normalised weight 1
    # (reference: graph_structure.py:33-35).
    loop = np.arange(num_nodes, dtype=np.int32)
    src_parts.append(loop)
    dst_parts.append(loop)
    rel_parts.append(np.full(num_nodes, num_relations - 1, dtype=np.int32))

    src = np.concatenate(src_parts)
    dst = np.concatenate(dst_parts)
    rel = np.concatenate(rel_parts)
    norm = compute_norm(src, rel, num_nodes, num_relations)

    structure = GraphStructure(num_nodes=num_nodes,
                               num_relations=num_relations,
                               src=src, dst=dst, rel=rel, norm=norm,
                               nodes_map=nodes_map,
                               properties_map=properties_map)
    return structure, nodes_map, properties_map


def _index_triples(kg: KnowledgeGraph, nodes_map: Dict, included_rank: Dict,
                   separate_literals: bool):
    """One pass: triples -> (s_idx, prop_rank, o_idx) int32 arrays.

    Dictionary lookups run as C-level maps over the zipped columns (no
    per-triple tuple unpack, no generator): ~3x a list-comprehension loop
    at 160k triples.
    """
    s_col, p_col, o_col = kg.columns()
    if separate_literals:
        from mrgcn_tpu_torch.data.rdf import Literal, UniqueLiteral
        o_col = tuple(UniqueLiteral(s, p, o)
                      if isinstance(o, Literal) else o
                      for s, p, o in zip(s_col, p_col, o_col))
    n = len(s_col)
    if n == 0:
        empty = np.empty(0, dtype=np.int32)
        return empty, empty, empty
    k_arr = np.fromiter(
        (v if v is not None else -1
         for v in map(included_rank.get, p_col)),
        dtype=np.int32, count=n)
    s_arr = np.fromiter(map(nodes_map.__getitem__, s_col),
                        dtype=np.int32, count=n)
    o_arr = np.fromiter(map(nodes_map.__getitem__, o_col),
                        dtype=np.int32, count=n)
    if (k_arr < 0).any():  # excluded properties
        keep = k_arr >= 0
        return s_arr[keep], k_arr[keep], o_arr[keep]
    return s_arr, k_arr, o_arr


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
