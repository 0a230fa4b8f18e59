"""Mini-batching: L-hop BFS neighbourhood expansion on the host.

Counterpart of :mod:`mrgcn_tpu.data.batching` (reference:
mrgcn/data/batch.py:152-315). Each hop becomes its own
:class:`..models.rgcn.EdgeBlock` with local (remapped) src/dst indices and
the global ``dst`` kept for the identity-weight gather. Every array is
built with numpy and padded to the same power-of-two buckets as the JAX
package's, so the two packages' arrays are equal element for element;
:func:`device_put_batches` then moves a whole split to the device at once.

Hop invariant (reference: mrgcn/models/rgcn.py:91-128): model layer ``l`` of
``L`` consumes the edges collected at hop ``L-1-l``: the input layer
aggregates the outermost neighbourhood, the final layer produces embeddings
for the batch nodes themselves. Modality encoders run only on the outermost
hop's nodes (reference: mrgcn/models/mrgcn.py:216-248).
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mrgcn_tpu_torch.data.native import get_sampler_lib
from mrgcn_tpu_torch.encodings.structure import group_by_relation
from mrgcn_tpu_torch.models.rgcn import EdgeBlock
from mrgcn_tpu_torch.ops.placement import build_rows

logger = logging.getLogger(__name__)


def bucket(n: int, minimum: int = 64) -> int:
    """Next power of two >= n (>= minimum), so shapes repeat across batches."""
    size = minimum
    while size < n:
        size *= 2
    return size


class EdgeIndex:
    """CSR-style index over the COO edge list, keyed by source row
    (the reference walks ``A.indptr``/``A.indices`` the same way,
    reference: batch.py:228-243)."""

    def __init__(self, structure):
        order = np.argsort(structure.src, kind="stable")
        self.src = structure.src[order]
        self.dst = np.ascontiguousarray(structure.dst[order],
                                        dtype=np.int32)
        self.rel = structure.rel[order]
        self.norm = structure.norm[order]
        self.indptr = np.ascontiguousarray(np.searchsorted(
            self.src, np.arange(structure.num_nodes + 1)), dtype=np.int64)
        self.num_nodes = structure.num_nodes
        self._mark = None                # native sampler scratch, lazy

    def _spans(self, nodes: np.ndarray):
        """(edge ids, per-node degree, position within the node's span) of
        the out-edges of ``nodes``, vectorised: no per-node Python loop."""
        nodes = np.asarray(nodes, dtype=np.int64)
        starts = self.indptr[nodes]
        counts = self.indptr[nodes + 1] - starts
        total = int(counts.sum())
        offsets = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(counts) - counts, counts)
        return np.repeat(starts, counts) + offsets, counts, offsets

    def out_edges(self, nodes: np.ndarray) -> np.ndarray:
        """Edge positions whose source is in ``nodes``."""
        return self._spans(nodes)[0]

    def hop(self, nodes: np.ndarray):
        """One BFS hop: (out-edge ids, sorted unique neighbour ids).

        Uses the native C++ sampler (``native/sampler.cpp``) when the
        shared library builds; the numpy path is the reference semantics.
        """
        lib = get_sampler_lib()
        if lib is None:
            eids = self.out_edges(nodes)
            return eids, np.unique(self.dst[eids]).astype(np.int32)

        frontier = np.ascontiguousarray(nodes, dtype=np.int32)
        if frontier.size and (frontier.min() < 0
                              or frontier.max() >= self.num_nodes):
            raise ValueError("frontier node id out of range")
        counts = self.indptr[frontier.astype(np.int64) + 1] \
            - self.indptr[frontier.astype(np.int64)]
        eids = np.empty(int(counts.sum()), dtype=np.int64)
        neigh = np.empty(self.num_nodes, dtype=np.int32)
        n_neigh = np.zeros(1, dtype=np.int64)
        if self._mark is None:
            self._mark = np.zeros(self.num_nodes, dtype=np.uint8)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        n_eids = lib.mg_bfs_hop(
            ptr(self.indptr, ctypes.c_int64), ptr(self.dst, ctypes.c_int32),
            self.num_nodes, ptr(frontier, ctypes.c_int32), len(frontier),
            ptr(eids, ctypes.c_int64), ptr(neigh, ctypes.c_int32),
            ptr(n_neigh, ctypes.c_int64), ptr(self._mark, ctypes.c_uint8))
        if n_eids < 0:
            raise ValueError("frontier node id out of range")
        return eids[:n_eids], neigh[:int(n_neigh[0])].copy()

    def hop_sampled(self, nodes: np.ndarray, fanout: int,
                    rng: np.random.Generator):
        """One BFS hop with at most ``fanout`` out-edges kept per frontier
        node (uniform, without replacement), GraphSAGE-style: bounding the
        per-hop fan-out bounds the sampled subgraph, and with it the batch
        shapes and the memory footprint, regardless of graph size.

        Returns ``(eids, neighbours, scale)`` where ``scale[i]`` is the
        importance weight ``deg(src_i) / kept(src_i)`` making the sampled
        aggregation an unbiased estimator of the full one: each out-edge of
        a node with degree ``d > fanout`` is kept with probability
        ``fanout/d``, so re-scaling its norm by ``d/fanout`` preserves
        ``E[sum] = full sum`` in ``out[src] += norm * (H[dst] @ W[rel])``.
        """
        eids, counts, offsets = self._spans(nodes)
        total = len(eids)
        if total == 0:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int32),
                    np.empty(0, dtype=np.float32))
        if int(counts.max()) <= fanout:
            # nothing to drop: identical to the full hop
            return (eids, np.unique(self.dst[eids]).astype(np.int32),
                    np.ones(total, dtype=np.float32))
        # shuffle within each node's span: stable lexsort by (segment,
        # random key) keeps segments contiguous, so "rank within span <
        # fanout" selects a uniform without-replacement sample per node
        seg = np.repeat(np.arange(len(counts)), counts)
        order = np.lexsort((rng.random(total), seg))
        keep = offsets < fanout            # rank within span, post-shuffle
        sel = order[keep]
        kept = np.minimum(counts, fanout)
        # zero-degree frontier nodes contribute no edges; guard the 0/0
        # (their scale entry is never indexed via seg[sel])
        scale = (counts / np.maximum(kept, 1)).astype(np.float32)
        return (eids[sel],
                np.unique(self.dst[eids[sel]]).astype(np.int32),
                scale[seg[sel]])


@dataclass
class MiniBatch:
    """One L-hop sampled subgraph, its arrays still numpy on the host."""

    layer_edges: Tuple[EdgeBlock, ...]   # ordered for model layers 0..L-1
    batch_nodes: np.ndarray              # global ids of the batch nodes
    outer_nodes: np.ndarray              # global ids of the outermost hop
    num_batch: int                       # un-padded batch node count


def normalize_fanout(fanout, num_layers: int) -> Optional[List[Optional[int]]]:
    """Per-hop fan-out caps from a config value: a positive int applies to
    every hop, a sequence gives hop-by-hop caps (hop 0 = the batch nodes'
    immediate neighbourhood), non-positive entries mean full expansion.
    Returns ``None`` when nothing is capped."""
    if fanout is None:
        return None
    if isinstance(fanout, (int, np.integer)):
        fanout = [int(fanout)] * num_layers
    # idempotent: None entries (an already-normalized list) stay None
    fanout = [int(f) if f is not None and int(f) > 0 else None
              for f in fanout]
    if len(fanout) != num_layers:
        raise ValueError(
            f"neighbor_fanout has {len(fanout)} entries for "
            f"{num_layers} layers")
    return fanout if any(f is not None for f in fanout) else None


def sample_minibatch(index: EdgeIndex, batch_nodes: np.ndarray,
                     num_layers: int,
                     edge_bucket: int = 256,
                     node_bucket: int = 64,
                     fanout=None,
                     rng: Optional[np.random.Generator] = None) -> MiniBatch:
    """BFS-expand ``batch_nodes`` for ``num_layers`` hops
    (reference: batch.py:185-197).

    ``fanout`` (int or per-hop sequence, see :func:`normalize_fanout`) caps
    each frontier node's expansion via :meth:`EdgeIndex.hop_sampled`; the
    kept edges' norms are importance-rescaled so the sampled aggregation is
    an unbiased estimator of the full one. A capped hop draws from ``rng``,
    which the caller must then give: there is no default seed."""
    batch_nodes = np.asarray(batch_nodes, dtype=np.int32)
    fanouts = normalize_fanout(fanout, num_layers) or [None] * num_layers
    if any(f is not None for f in fanouts) and rng is None:
        raise ValueError("sample_minibatch: a fan-out cap needs the "
                         "caller's rng (np.random.Generator)")

    hop_nodes: List[np.ndarray] = [batch_nodes]     # S_0 .. S_L
    hop_edges: List[np.ndarray] = []                # E_0 .. E_{L-1}
    hop_scales: List[Optional[np.ndarray]] = []
    sample = batch_nodes
    for cap in fanouts:
        if cap is not None:
            eids, neighbours, scale = index.hop_sampled(sample, cap, rng)
        else:
            eids, neighbours = index.hop(sample)    # sorted global ids
            scale = None
        hop_edges.append(eids)
        hop_scales.append(scale)
        hop_nodes.append(neighbours.astype(np.int32))
        sample = neighbours

    # model layer l uses hop L-1-l: rows = S_{L-1-l}, inputs = S_{L-l}
    layers: List[EdgeBlock] = []
    for layer in range(num_layers):
        hop = num_layers - 1 - layer
        eids = hop_edges[hop]
        out_nodes, in_nodes = hop_nodes[hop], hop_nodes[hop + 1]

        src_local = _local_ids(index.src[eids], out_nodes)
        dst_local = _local_ids(index.dst[eids], in_nodes)
        dst_global = index.dst[eids].astype(np.int32)
        norm = index.norm[eids]
        if hop_scales[hop] is not None:
            norm = norm * hop_scales[hop]
        rel = index.rel[eids]

        E = bucket(len(eids), edge_bucket)
        pad = E - len(eids)
        n_out = bucket(len(out_nodes), node_bucket)
        n_in = bucket(len(in_nodes), node_bucket)
        if pad:
            # padding edges scatter to an out-of-range row and are dropped
            src_local = np.concatenate(
                [src_local, np.full(pad, n_out, dtype=np.int32)])
            dst_local = np.concatenate(
                [dst_local, np.zeros(pad, dtype=np.int32)])
            dst_global = np.concatenate(
                [dst_global, np.zeros(pad, dtype=np.int32)])
            rel = np.concatenate([rel, np.zeros(pad, dtype=np.int32)])
            norm = np.concatenate(
                [norm, np.zeros(pad, dtype=np.float32)])

        grouping = group_by_relation(
            src_local[:len(eids)], dst_local[:len(eids)],
            index.rel[eids], norm[:len(eids)], n_out, group_size=64)
        # bucket the group count as well
        G = bucket(grouping.num_groups, 4)
        gpad = G - grouping.num_groups
        layers.append(EdgeBlock(
            src=src_local, dst=dst_local,
            rel=np.ascontiguousarray(rel), norm=np.ascontiguousarray(norm),
            num_out=n_out, num_in=n_in,
            dst_global=dst_global,
            grp_src=np.concatenate(
                [grouping.src,
                 np.full(gpad * grouping.group_size, n_out,
                         dtype=np.int32)]),
            grp_dst=np.concatenate(
                [grouping.dst,
                 np.zeros(gpad * grouping.group_size, dtype=np.int32)]),
            grp_norm=np.concatenate(
                [grouping.norm,
                 np.zeros(gpad * grouping.group_size, dtype=np.float32)]),
            group_rel=np.concatenate(
                [grouping.group_rel, np.zeros(gpad, dtype=np.int32)]),
            group_size=grouping.group_size))

    return MiniBatch(layer_edges=tuple(layers),
                     batch_nodes=batch_nodes,
                     outer_nodes=hop_nodes[-1],
                     num_batch=len(batch_nodes))


def _local_ids(global_ids: np.ndarray, universe: np.ndarray) -> np.ndarray:
    """Positions of ``global_ids`` within ``universe``, which holds every
    one of them (the first position where it repeats an id). A lookup
    table over the id range: the hop's hundreds of thousands of edge ends
    cost one pass, not a binary search each."""
    universe = np.asarray(universe)
    lut = np.zeros(int(universe.max()) + 1 if universe.size else 1,
                   dtype=np.int32)
    # written back to front, so the first of equal ids stays
    lut[universe[::-1]] = np.arange(universe.size - 1, -1, -1,
                                    dtype=np.int32)
    return lut[global_ids]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def subset_features(features: Dict, outer_nodes: np.ndarray,
                    row_bucket: int = 64,
                    num_rows: Optional[int] = None) -> Dict:
    """Restrict per-encoder feature rows to the outermost-hop nodes and remap
    their indices to hop-local positions
    (reference: batch.py:265-315 ``mksubset``). Keeps empty entries out:
    the model skips missing encoders, preserving module order by name.

    ``features``: encoder name -> ``(data, node_idx, ...)``, host arrays
    (:attr:`..tasks.common.RunInputs.features_host`). ``num_rows`` is the
    model's placement row count for this batch (the outermost EdgeBlock's
    ``num_in``); when given, each entry carries the inverse map of
    :func:`..ops.placement.build_rows`, so the step places encoder rows
    with a single gather."""
    outer_sorted = np.asarray(outer_nodes)
    out: Dict = {}
    for name, entry in features.items():
        data, node_idx_np = _host(entry[0]), _host(entry[1])
        mask = np.isin(node_idx_np, outer_sorted)
        count = int(mask.sum())
        if count == 0:
            continue
        rows = data[mask]
        local = _local_ids(node_idx_np[mask], outer_sorted)

        pad = bucket(count, row_bucket) - count
        if pad:
            rows = np.concatenate(
                [rows, np.zeros((pad, *rows.shape[1:]), dtype=rows.dtype)])
            # padded rows point far out of range (beyond any node-count
            # bucket) and the placement drops them
            local = np.concatenate(
                [local, np.full(pad, 2 ** 30, dtype=np.int32)])
        if num_rows is not None:
            out[name] = (rows, local, build_rows(local, num_rows))
        else:
            out[name] = (rows, local)
    return out


def device_put_batches(payloads, device):
    """Move a split's host-built batches to ``device``: every numpy array
    found in ``payloads`` (nested lists, tuples, dicts and
    :class:`EdgeBlock`s) becomes a tensor there, everything else stays.
    One copy per array, none of them waited for; on the CPU each array is
    wrapped in place. The move is a small part of building a split, so the
    arrays are not pooled into pinned buffers, which would hold the split
    on the host twice.
    """
    device = torch.device(device)

    def put(x):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)
        if isinstance(x, EdgeBlock):
            return EdgeBlock(**{f.name: put(getattr(x, f.name))
                                for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return x

    return put(payloads)


def make_label_batches(label_rows: np.ndarray,
                       batchsize: int) -> List[np.ndarray]:
    """Slice labelled nodes into batches
    (reference: node_classification.py:329-351)."""
    num_samples = label_rows.shape[0]
    if batchsize <= 0:
        batchsize = num_samples
    return [label_rows[b:min(b + batchsize, num_samples)]
            for b in range(0, num_samples, batchsize)]
