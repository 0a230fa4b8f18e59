"""Plan-driven featureless relational layer on sorted edge streams.

Counterpart of :mod:`mrgcn_tpu.ops.relational` for the featureless
full-batch path:

* **Host planning (numpy).** :func:`build_layer_plans` sorts the edge list
  into slab-padded streams whose slabs each address one ``row_block`` of
  the scatter target, then moves them to torch tensors on the chosen
  device. The arrays equal the JAX package's plans element for element.
* **Packing helpers.** Narrow rows are packed ``k`` to a 128-lane line.
* **The layer ops.** :func:`featureless_aggregate` gathers per-edge rows
  of the relation-major packed table and block-scatters them
  (:func:`..sorted_stream.fused_place_scatter`); its backward recomputes
  the per-edge cotangent on the (rel, dst)-sorted ``bwd_table`` stream and
  block-scatters it into the table gradient, which the compose's own
  backward (:func:`..rspmm.compose_packed`) reads once for both ``d_comp``
  and ``d_packed``. :func:`featureless_basis`
  composes the basis tables per edge instead, for graphs whose composed
  table is over budget; :func:`dense_aggregate` is the layer over node
  features. No E-sized tensor crosses between differently sorted streams.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mrgcn_tpu_torch.ops.rspmm import (compose_packed, packed_identity_shape,
                                       packing_factor)
from mrgcn_tpu_torch.ops.sorted_stream import (EDGE_BLOCK, ROW_BLOCK,
                                               expand_sub,
                                               fused_place_scatter,
                                               fused_scatter_dot,
                                               sorted_scatter)


# --------------------------------------------------------------------------
# host-side planning
# --------------------------------------------------------------------------

def _segment_layout(major, minor, block_of_edge, edge_block,
                    split_key=None):
    """Order edges by (major, minor), split where the block id (or, when
    given, ``split_key``) changes, pad each segment to a multiple of
    ``edge_block``. Returns ``(order, slots, E_pad, slab_blk)``."""
    E = len(block_of_edge)
    order = np.lexsort((minor, major))
    blk = np.asarray(block_of_edge)[order]
    if E == 0:
        return (order, np.zeros(0, np.int64), edge_block,
                np.zeros(1, np.int64))
    key = blk if split_key is None else np.asarray(split_key)[order]
    boundaries = np.flatnonzero(np.diff(key)) + 1
    seg_starts = np.concatenate([[0], boundaries, [E]]).astype(np.int64)
    lengths = np.diff(seg_starts)
    padded = -(-lengths // edge_block) * edge_block
    out_starts = np.concatenate([[0], np.cumsum(padded)])
    E_pad = int(out_starts[-1])
    seg_of_edge = np.repeat(np.arange(len(lengths)), lengths)
    slots = out_starts[seg_of_edge] + (np.arange(E)
                                       - seg_starts[seg_of_edge])
    slab_seg = np.repeat(np.arange(len(lengths)),
                         (padded // edge_block).astype(np.int64))
    slab_blk = blk[seg_starts[:-1]][slab_seg]
    return order, slots, E_pad, slab_blk


@dataclass
class Stream:
    """One sorted, slab-padded view of the edge list.

    ``scatter_local``/``scatter_blk`` address this stream's scatter target
    (the layer output for ``fwd``, the packed table for ``bwd_table``); the
    per-edge fields recompute messages from node-sized tensors:
    ``src_row``/``out_mod`` (packed output row of the edge),
    ``gather_row`` (packed input row without the relation offset),
    ``in_mod``, ``rel`` and ``norm`` (0 on padding).

    ``rows_sorted``: the real edges' scatter rows never decrease along the
    stream (within every run of equal block ids; across runs the block ids
    rise), so all edges of one scatter row are contiguous. The planner
    computes it; the scatters (:func:`..sorted_stream.sorted_scatter`,
    :func:`..sorted_stream.fused_place_scatter`,
    :func:`..sorted_stream.fused_scatter_dot`) take their row-segmented
    kernel on such a stream.
    """

    scatter_local: torch.Tensor  # (nslab, EB) int32; row_block on padding
    scatter_blk: torch.Tensor    # (nslab,) int32, non-decreasing
    src_row: torch.Tensor        # (E_pad,) int32
    out_mod: torch.Tensor        # (E_pad,) int32
    gather_row: torch.Tensor     # (E_pad,) int32
    in_mod: torch.Tensor         # (E_pad,) int32
    rel: torch.Tensor            # (E_pad,) int32
    norm: torch.Tensor           # (E_pad,) float32
    slab_rel: torch.Tensor       # (nslab,) int32 (exact when rel_const)
    edge_block: int
    row_block: int
    rel_const: bool = False
    rows_sorted: bool = False

    @property
    def num_padded_edges(self) -> int:
        return int(self.gather_row.shape[0])

    @property
    def num_slabs(self) -> int:
        return int(self.scatter_blk.shape[0])

    def to(self, device) -> "Stream":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclass
class LayerPlans:
    """The sorted streams one full-batch layer needs: ``fwd`` (src-sorted,
    scatters to the layer output), ``bwd_table`` ((rel, dst)-sorted,
    scatters into the relation-major table) and ``bwd_h`` (dst-sorted,
    scatters into packed H; aliases ``fwd`` for identity plans)."""

    fwd: Stream
    bwd_table: Stream
    bwd_h: Stream
    k_in: int
    k_out: int
    n_in_rows: int
    n_out_rows: int
    num_nodes: int
    kind: str = "dense"
    # rectangular (frontier-restricted) layers; 0 means num_nodes
    num_out_nodes: int = 0
    num_in_nodes: int = 0

    @property
    def out_nodes(self) -> int:
        return self.num_out_nodes or self.num_nodes

    @property
    def in_nodes(self) -> int:
        return self.num_in_nodes or self.num_nodes

    def to(self, device) -> "LayerPlans":
        fwd = self.fwd.to(device)
        bwd_h = fwd if self.bwd_h is self.fwd else self.bwd_h.to(device)
        return dataclasses.replace(self, fwd=fwd,
                                   bwd_table=self.bwd_table.to(device),
                                   bwd_h=bwd_h)


def _pad_rows(num_nodes: int, k: int, row_block: int) -> int:
    rows = -(-num_nodes // k)
    return max(1, -(-rows // row_block)) * row_block


def _rel_const_decisions(src, dst, rel, num_nodes: int, k_in: int,
                         k_out: int, row_block: int,
                         edge_block: int) -> dict:
    """Whether the fwd / bwd_h streams of a dense plan use the
    relation-constant slab layout, judged from padded sizes."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    rel = np.asarray(rel, dtype=np.int64)
    out_blk = (src // k_out) // row_block
    in_blk = (dst // k_in) // row_block
    R_num = int(rel.max()) + 1 if len(rel) else 1

    def padded_len(keys) -> int:
        _, counts = np.unique(keys, return_counts=True)
        return int((-(-counts // edge_block) * edge_block).sum())

    def allow_rc(composite, plain) -> bool:
        base = padded_len(plain)
        return padded_len(composite) <= max(int(1.35 * base),
                                            base + 8 * edge_block)

    return {"fwd": allow_rc(out_blk * R_num + rel, out_blk),
            "bwd_h": allow_rc(in_blk * R_num + rel, in_blk)}


def build_layer_plans(src, dst, rel, norm, num_nodes: int, k_in: int,
                      k_out: int, row_block: int = ROW_BLOCK,
                      edge_block: int = EDGE_BLOCK, kind: str = "dense",
                      num_out_nodes: Optional[int] = None,
                      num_in_nodes: Optional[int] = None,
                      device=None) -> LayerPlans:
    """The sorted edge streams for one layer shape, built in numpy and
    returned as tensors on ``device`` (CPU by default).

    ``k_in``/``k_out`` are the packing factors of the gathered table's and
    the output's row widths. ``kind="identity"`` builds the featureless
    variant (plain block splits, ``bwd_h`` aliases ``fwd``);
    ``"identity_basis"`` adds a real dst-sorted ``bwd_h``.
    ``num_out_nodes``/``num_in_nodes`` make the layer rectangular.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    rel = np.asarray(rel, dtype=np.int64)
    norm = np.asarray(norm, dtype=np.float32)

    n_in_rows = _pad_rows(num_in_nodes or num_nodes, k_in, row_block)
    n_out_rows = _pad_rows(num_out_nodes or num_nodes, k_out, row_block)
    in_row = dst // k_in
    out_row = src // k_out
    flat_row = rel * n_in_rows + in_row

    def mk(major, minor, scatter_row, split_key=None, rel_const=False):
        order, slots, E_pad, slab_blk = _segment_layout(
            major, minor, scatter_row // row_block, edge_block,
            split_key=split_key)
        nslab = E_pad // edge_block

        def place(arr, fill, dtype=np.int32):
            out = np.full(E_pad, fill, dtype=dtype)
            out[slots] = np.asarray(arr)[order]
            return torch.from_numpy(out)

        relp = place(rel, 0)
        rows = np.asarray(scatter_row)[order]
        return Stream(
            scatter_local=place(scatter_row % row_block,
                                row_block).reshape(nslab, edge_block),
            scatter_blk=torch.from_numpy(slab_blk.astype(np.int32)),
            src_row=place(out_row, 0),
            out_mod=place(src % k_out, 0),
            gather_row=place(in_row, 0),
            in_mod=place(dst % k_in, 0),
            rel=relp,
            norm=place(norm, 0.0, np.float32),
            slab_rel=relp.reshape(nslab, edge_block)[:, 0].clone(),
            edge_block=edge_block, row_block=row_block,
            rel_const=rel_const,
            rows_sorted=bool(np.all(rows[1:] >= rows[:-1])))

    R_num = int(rel.max()) + 1 if len(rel) else 1
    bwd_table = mk(rel, dst, flat_row)
    if kind == "identity":
        fwd = mk(src, flat_row, out_row)
        bwd_h = fwd
    elif kind == "identity_basis":
        fwd = mk(src, flat_row, out_row)
        bwd_h = mk(in_row, rel, in_row)
    else:
        rc = _rel_const_decisions(src, dst, rel, num_nodes, k_in, k_out,
                                  row_block, edge_block)
        if rc["fwd"]:
            fwd_key = (out_row // row_block) * R_num + rel
            fwd = mk(fwd_key, flat_row, out_row, split_key=fwd_key,
                     rel_const=True)
        else:
            fwd = mk(src, flat_row, out_row)
        if rc["bwd_h"]:
            bwdh_key = (in_row // row_block) * R_num + rel
            bwd_h = mk(bwdh_key, out_row, in_row, split_key=bwdh_key,
                       rel_const=True)
        else:
            bwd_h = mk(in_row, rel, in_row)
    plans = LayerPlans(fwd=fwd, bwd_table=bwd_table, bwd_h=bwd_h,
                       k_in=int(k_in), k_out=int(k_out),
                       n_in_rows=int(n_in_rows),
                       n_out_rows=int(n_out_rows),
                       num_nodes=int(num_nodes), kind=kind,
                       num_out_nodes=int(num_out_nodes or 0),
                       num_in_nodes=int(num_in_nodes or 0))
    return plans if device is None else plans.to(device)


def composed_table_elems(num_relations: int, num_nodes: int,
                         out_dim: int, row_block: int = ROW_BLOCK,
                         n_in_rows: Optional[int] = None) -> int:
    """Element count of the composed relation-major identity table."""
    k = packing_factor(out_dim)
    lanes = packed_identity_shape(1, num_nodes, out_dim)[0][2]
    rows = _pad_rows(num_nodes, k, row_block) if n_in_rows is None \
        else n_in_rows
    return num_relations * rows * lanes


COMPOSED_TABLE_MAX_ELEMS = 2 ** 29   # 2 GiB f32
MAX_BASIS_STREAMS = 4


def basis_stream_wanted(num_relations: int, num_nodes: int, out_dim: int,
                        num_bases: int) -> bool:
    """Whether the featureless input layer needs the basis-stream plans
    (the composed table would exceed its budget and the basis count is
    small): the JAX package's default decision."""
    return (0 < num_bases <= MAX_BASIS_STREAMS
            and composed_table_elems(num_relations, num_nodes, out_dim)
            > COMPOSED_TABLE_MAX_ELEMS)


def plans_for_layers(src, dst, rel, norm, num_nodes: int, layer_shapes,
                     row_block: int = ROW_BLOCK,
                     edge_block: int = EDGE_BLOCK,
                     identity_basis: bool = False,
                     num_out_nodes: Optional[int] = None,
                     num_in_nodes: Optional[int] = None,
                     device=None) -> dict:
    """One :class:`LayerPlans` per distinct (k_in, k_out) pair, keyed
    ``"kin:kout"`` (``":id"``/``":idb"`` suffix for identity plans).
    ``layer_shapes``: (in_width, out_width) pairs; ``in_width=None`` marks
    the featureless identity gather."""
    id_kind = "identity_basis" if identity_basis else "identity"
    id_key = "idb" if identity_basis else "id"
    pairs = set()
    for in_w, out_w in layer_shapes:
        k_out = packing_factor(int(out_w))
        if in_w is None:
            pairs.add((k_out, k_out, id_kind))
        else:
            pairs.add((packing_factor(int(in_w)), k_out, "dense"))
    return {f"{ki}:{ko}:{id_key}" if kind == id_kind else f"{ki}:{ko}":
            build_layer_plans(src, dst, rel, norm, num_nodes, ki, ko,
                              row_block=row_block, edge_block=edge_block,
                              kind=kind, num_out_nodes=num_out_nodes,
                              num_in_nodes=num_in_nodes, device=device)
            for ki, ko, kind in sorted(pairs)}


# --------------------------------------------------------------------------
# packing helpers
# --------------------------------------------------------------------------

def line_width(k: int, d: int) -> int:
    """Packed line width: 128 lanes for k > 1, else d rounded up to 128."""
    return 128 if k > 1 else -(-d // 128) * 128


def pack_rows(X: torch.Tensor, k: int, padded_rows: int) -> torch.Tensor:
    """(n, d) -> (padded_rows, L): k logical rows per L-lane line."""
    n, d = X.shape
    lw = line_width(k, d)
    sub = lw // k
    Xp = torch.nn.functional.pad(X, (0, sub - d, 0, padded_rows * k - n))
    return Xp.reshape(padded_rows, lw)


def unpack_rows(P: torch.Tensor, k: int, n: int, d: int) -> torch.Tensor:
    sub = P.shape[1] // k
    return P.reshape(P.shape[0] * k, sub)[:n, :d]


def _select_sub(G: torch.Tensor, mod: torch.Tensor, k: int, d: int
                ) -> torch.Tensor:
    """Per-edge sub-row select (E, L) -> (E, d): plain indexing, exact like
    the one-hot contraction it stands for."""
    if k == 1:
        return G[:, :d]
    sub = G.shape[1] // k
    rows = torch.arange(G.shape[0], device=G.device)
    return G.reshape(-1, k, sub)[rows, mod.long(), :d]


def _expand_sub(v: torch.Tensor, mod: torch.Tensor, k: int) -> torch.Tensor:
    """Per-edge sub-row placement (E, d) -> (E, line_width): ``v`` lands in
    lane slot ``mod``, every other slot is zero."""
    return expand_sub(v, mod, k, line_width(k, v.shape[1]))


def _gather_sub(table: torch.Tensor, row: torch.Tensor, mod: torch.Tensor,
                k: int, d: int) -> torch.Tensor:
    """Per-edge logical sub-rows of a packed (T, L) table: full-line row
    gather, then sub-row select."""
    return _select_sub(table[row], mod, k, d)


def _place_scatter(V: torch.Tensor, place_mod: torch.Tensor,
                   stream: Stream, out_rows: int, k: int, d: int,
                   L: int) -> torch.Tensor:
    """norm-scale + sub-row place + block scatter of per-edge values
    ``V`` (E, d) into ``(out_rows, L)``: one :func:`fused_place_scatter`
    pass, without the ``(E, L)`` lines in between (its row-segmented kernel
    where the planner marks the stream ``rows_sorted``)."""
    return fused_place_scatter(V[:, :d], place_mod, stream.norm,
                               stream.scatter_local, stream.scatter_blk,
                               out_rows, k, L, stream.row_block,
                               stream.edge_block,
                               rows_sorted=stream.rows_sorted)


# --------------------------------------------------------------------------
# featureless layer: out[src] += norm * table[rel, dst]
# --------------------------------------------------------------------------

class _FeaturelessAggregate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, plans, out_dim):
        f = plans.fwd
        k = plans.k_in
        V = _gather_sub(table, f.rel * plans.n_in_rows + f.gather_row,
                        f.in_mod, k, out_dim)
        out = _place_scatter(V, f.out_mod, f, plans.n_out_rows,
                             plans.k_out, out_dim, table.shape[1])
        ctx.plans = plans
        ctx.out_dim = out_dim
        ctx.table_shape = table.shape
        return unpack_rows(out, plans.k_out, plans.out_nodes, out_dim)

    @staticmethod
    def backward(ctx, d_out):
        plans, out_dim = ctx.plans, ctx.out_dim
        table_rows, L = ctx.table_shape
        b = plans.bwd_table
        # recompute the per-edge cotangent on the (rel, dst)-sorted stream
        # from the node-sized d_out: one small-table gather, no permutation
        d_out_p = pack_rows(d_out.contiguous(), plans.k_out,
                            plans.n_out_rows)
        d_v = _gather_sub(d_out_p, b.src_row, b.out_mod, plans.k_out,
                          out_dim)
        d_table = _place_scatter(d_v, b.in_mod, b, table_rows, plans.k_in,
                                 out_dim, L)
        return d_table, None, None


def featureless_aggregate(table: torch.Tensor, plans: LayerPlans,
                          out_dim: int) -> torch.Tensor:
    """``out[s] = sum_e norm_e * select(table[rel_e * nrp + dst_e // k])``.

    ``table``: relation-major packed weight table ``(R * n_in_rows, L)``,
    typically ``compose_packed(comp, packed)``. Returns
    ``(out_nodes, out_dim)``. Forward and backward each run one
    :func:`fused_place_scatter`.
    """
    return _FeaturelessAggregate.apply(table, plans, out_dim)


# --------------------------------------------------------------------------
# basis-stream featureless layer: compose per edge, never build the table
# --------------------------------------------------------------------------

class _FeaturelessBasis(torch.autograd.Function):

    @staticmethod
    def forward(ctx, comp, packed, plans, out_dim):
        f = plans.fwd
        k = plans.k_in
        w = comp[f.rel.long()]                              # (E, B)
        v = 0.0
        for b in range(comp.shape[1]):
            g = _gather_sub(packed[b], f.gather_row, f.in_mod, k, out_dim)
            v = v + w[:, b:b + 1] * g                       # (E, out_dim)
        out = _place_scatter(v, f.out_mod, f, plans.n_out_rows, plans.k_out,
                             out_dim, packed.shape[2])
        ctx.save_for_backward(comp, packed)
        ctx.plans, ctx.out_dim = plans, out_dim
        return unpack_rows(out, plans.k_out, plans.out_nodes, out_dim)

    @staticmethod
    def backward(ctx, d_out):
        comp, packed = ctx.saved_tensors
        plans, out_dim = ctx.plans, ctx.out_dim
        R, B = comp.shape
        k = plans.k_in
        d_out_p = pack_rows(d_out.contiguous(), plans.k_out,
                            plans.n_out_rows)
        # both gradients on the dst-sorted bwd_h stream: the d_packed
        # scatter and the d_comp gather visit the same packed rows
        h = plans.bwd_h
        d_vh = _gather_sub(d_out_p, h.src_row, h.out_mod, plans.k_out,
                           out_dim)                         # (E, out)
        w_h = comp[h.rel.long()]                            # (E, B)
        if k == 1:
            planes, cols = _basis_grads_fused(d_vh, w_h, h, packed,
                                              plans.n_in_rows)
        else:
            planes, cols = _basis_grads_placed(d_vh, w_h, h, packed, k,
                                               plans.n_in_rows, out_dim)
        d_packed = torch.stack(planes, dim=0)               # (B, rows, L)
        per_edge = torch.stack(cols, dim=1)                 # (E, B)
        d_comp = torch.zeros(R, B, dtype=per_edge.dtype,
                             device=per_edge.device
                             ).index_add_(0, h.rel.long(), per_edge)
        return d_comp.to(comp.dtype), d_packed.to(packed.dtype), None, None


def _basis_grads_fused(d_vh, w_h, h: Stream, packed, n_rows: int):
    """Per basis ``b``, one :func:`fused_scatter_dot` pass on the
    ``bwd_h`` stream: scatter ``w_h[:, b] * dvn`` into ``d_packed[b]`` and
    dot ``dvn`` with the unpacked row at the same address. Returns the
    planes and the per-edge dot columns. The planner's ``rows_sorted``
    picks the row-segmented kernel."""
    dvn = d_vh * h.norm[:, None]
    planes, cols = [], []
    for b in range(w_h.shape[1]):
        plane, dots = fused_scatter_dot(
            dvn, w_h[:, b].contiguous(), h.scatter_local, h.scatter_blk,
            packed[b], n_rows, h.row_block, h.edge_block,
            rows_sorted=h.rows_sorted)
        planes.append(plane)
        cols.append(dots)
    return planes, cols


def _basis_grads_placed(d_vh, w_h, h: Stream, packed, k: int, n_rows: int,
                        out_dim: int):
    """The same gradients for packed rows (any ``k``): per basis a
    :func:`fused_place_scatter` of ``w_h[:, b] * d_vh`` (the norm applied
    inside) and a dot with the gathered sub-rows."""
    dvn = d_vh * h.norm[:, None]
    L = packed.shape[2]
    planes, cols = [], []
    for b in range(w_h.shape[1]):
        planes.append(_place_scatter(d_vh * w_h[:, b:b + 1], h.in_mod, h,
                                     n_rows, k, out_dim, L))
        g_hb = _gather_sub(packed[b], h.gather_row, h.in_mod, k, out_dim)
        cols.append((dvn * g_hb).sum(dim=1))
    return planes, cols


def featureless_basis(comp: torch.Tensor, packed: torch.Tensor,
                      plans: LayerPlans, out_dim: int) -> torch.Tensor:
    """Featureless layer for graphs whose composed identity table is over
    budget (link prediction: hundreds of relations times wide rows):
    gather the ``B`` basis tables per edge on the src-sorted stream,
    contract with ``comp[rel_e]`` and block-scatter, without ever building
    the ``(R * rows, L)`` table.

    ``comp``: ``(R, B)`` with small ``B`` (:data:`MAX_BASIS_STREAMS`);
    ``packed``: ``(B, n_in_rows, L)``. Returns ``(out_nodes, out_dim)``.
    ``plans`` must be of kind ``"identity_basis"``: plain identity plans
    alias ``bwd_h`` to the ``fwd`` stream, which would give a silently
    wrong ``d_packed``.

    Backward, all on the dst-sorted ``bwd_h`` stream:
    ``d_packed[b] += comp[rel_e, b] norm_e d_out[src_e]`` and
    ``d_comp[r, b] = sum_e norm_e <d_out[src_e], packed[b, dst_e]>``. For
    unpacked rows (``k == 1``) each basis is one
    :func:`..sorted_stream.fused_scatter_dot` pass (its row-segmented
    kernel: the planner marks ``bwd_h`` ``rows_sorted``); for packed rows a
    :func:`fused_place_scatter` and a gathered dot.
    """
    if plans.kind != "identity_basis":
        raise ValueError(
            "featureless_basis needs identity_basis plans (plain identity "
            "plans alias bwd_h to the fwd stream: silently wrong d_packed)")
    return _FeaturelessBasis.apply(comp, packed, plans, out_dim)


# --------------------------------------------------------------------------
# dense layer: out[src] += norm * (H[dst] @ W[rel])
# --------------------------------------------------------------------------

def _slab_weights(W: torch.Tensor, stream: Stream) -> torch.Tensor:
    """One ``(in, out)`` weight per slab of a relation-constant stream."""
    return W[stream.slab_rel.long()]


def _slab_matmul(x: torch.Tensor, W: torch.Tensor, stream: Stream,
                 in_dim: int, out_dim: int) -> torch.Tensor:
    """``x[e] @ W[rel_e]`` on a stream whose slabs are relation-constant:
    one weight per slab, then a batched matmul. Padding edges carry
    ``norm == 0`` downstream, so the slab weight applied to them is
    harmless."""
    nslab, eb = stream.num_slabs, stream.edge_block
    return torch.bmm(x.reshape(nslab, eb, in_dim),
                     _slab_weights(W, stream)).reshape(-1, out_dim)


def _slab_matmul_t(d: torch.Tensor, W: torch.Tensor, stream: Stream,
                   in_dim: int, out_dim: int) -> torch.Tensor:
    """``d[e] @ W[rel_e]^T`` (cotangent side of :func:`_slab_matmul`)."""
    nslab, eb = stream.num_slabs, stream.edge_block
    return torch.bmm(d.reshape(nslab, eb, out_dim),
                     _slab_weights(W, stream).transpose(1, 2)
                     ).reshape(-1, in_dim)


def _edge_weights(W: torch.Tensor, stream: Stream) -> torch.Tensor:
    return W[stream.rel.long()]                      # (E, in, out)


class _DenseAggregate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, H, W, plans, in_dim, out_dim):
        f = plans.fwd
        Hp = pack_rows(H, plans.k_in, plans.n_in_rows)
        Hg = _gather_sub(Hp, f.gather_row, f.in_mod, plans.k_in, in_dim)
        L_out = line_width(plans.k_out, out_dim)
        if f.rel_const:
            v = _slab_matmul(Hg, W, f, in_dim, out_dim)
            out = _place_scatter(v, f.out_mod, f, plans.n_out_rows,
                                 plans.k_out, out_dim, L_out)
        else:
            v = torch.einsum("ei,eio->eo", Hg, _edge_weights(W, f)) \
                * f.norm[:, None]
            msgs = _expand_sub(v, f.out_mod, plans.k_out)
            out = sorted_scatter(msgs, f.scatter_local, f.scatter_blk,
                                 plans.n_out_rows, f.row_block,
                                 f.edge_block, rows_sorted=f.rows_sorted)
        ctx.save_for_backward(H, W)
        ctx.plans, ctx.in_dim, ctx.out_dim = plans, in_dim, out_dim
        return unpack_rows(out, plans.k_out, plans.out_nodes, out_dim)

    @staticmethod
    def backward(ctx, d_out):
        H, W = ctx.saved_tensors
        plans, in_dim, out_dim = ctx.plans, ctx.in_dim, ctx.out_dim
        d_out_p = pack_rows(d_out.contiguous(), plans.k_out,
                            plans.n_out_rows)
        L_in = line_width(plans.k_in, in_dim)

        # d_H on the dst-sorted stream: d_H[dst] += norm (d_out[src] W^T)
        h = plans.bwd_h
        d_v_h = _gather_sub(d_out_p, h.src_row, h.out_mod, plans.k_out,
                            out_dim)
        if h.rel_const:
            # norm is a scalar per edge: the place-scatter applies it after
            # the weight matmul it commutes with
            d_Hg = _slab_matmul_t(d_v_h, W, h, in_dim, out_dim)
            d_Hp = _place_scatter(d_Hg, h.in_mod, h, plans.n_in_rows,
                                  plans.k_in, in_dim, L_in)
        else:
            d_Hg = torch.einsum("eo,eio->ei", d_v_h * h.norm[:, None],
                                _edge_weights(W, h))
            msgs = _expand_sub(d_Hg, h.in_mod, plans.k_in)
            d_Hp = sorted_scatter(msgs, h.scatter_local, h.scatter_blk,
                                  plans.n_in_rows, h.row_block,
                                  h.edge_block, rows_sorted=h.rows_sorted)
        d_H = unpack_rows(d_Hp, plans.k_in, plans.in_nodes,
                          in_dim).to(H.dtype)

        # d_W on the (rel, dst)-sorted stream: its slabs are
        # relation-constant, so per-slab outer-product sums are batched
        # matmuls, then a segment sum over slabs by relation
        t = plans.bwd_table
        eb, nslab = t.edge_block, t.num_slabs
        Hp = pack_rows(H, plans.k_in, plans.n_in_rows)
        Hg_t = _gather_sub(Hp, t.gather_row, t.in_mod, plans.k_in, in_dim)
        d_v_t = _gather_sub(d_out_p, t.src_row, t.out_mod, plans.k_out,
                            out_dim) * t.norm[:, None]
        per_slab = torch.bmm(Hg_t.reshape(nslab, eb, in_dim).transpose(1, 2),
                             d_v_t.reshape(nslab, eb, out_dim))
        d_W = torch.zeros_like(W).index_add_(0, t.slab_rel.long(), per_slab)
        return d_H, d_W, None, None, None


def dense_aggregate(H: torch.Tensor, W: torch.Tensor, plans: LayerPlans,
                    in_dim: int, out_dim: int) -> torch.Tensor:
    """``out[s] = sum_e norm_e * H[dst_e] @ W[rel_e]``.

    ``H``: ``(in_nodes, in_dim)``; ``W``: ``(R, in_dim, out_dim)``, the
    composed weights (the caller's compose turns the returned ``d_W`` into
    basis and coefficient gradients). Forward and backward each scatter
    on their stream, ``fwd`` for the output, ``bwd_h`` for ``d_H``:
    :func:`fused_place_scatter` where the slabs are relation-constant,
    else :func:`sorted_scatter` of the expanded lines; ``d_W`` comes from
    the ``bwd_table`` stream's relation-constant slabs.
    """
    return _DenseAggregate.apply(H, W, plans, in_dim, out_dim)
