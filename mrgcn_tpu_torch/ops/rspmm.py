"""Relational sparse-dense products for R-GCN layers (PyTorch).

Counterpart of :mod:`mrgcn_tpu.ops.rspmm`: the packed identity-weight
layout, its relation-major compose, the relation-grouped dense aggregation
the restricted output layer runs, and the unplanned paths that layers
without sorted-stream plans take (mini-batch blocks):
:func:`transform_aggregate`, :func:`gather_aggregate_packed` and
:func:`gather_aggregate`. The unplanned paths choose between a direct
``(R * n, out)`` table and the fused-basis gather by the same padded-size
budgets as the JAX package, so both take the same branch.

Edge semantics: ``out[s] = sum_e norm_e * (H[dst_e] @ W[rel_e])`` with
basis decomposition ``W[r] = sum_b comp[r, b] * basis[b]``. Padding edges
(``norm == 0``, out-of-range ``src``) contribute nothing. Row gathers use
``index_select``: its backward is one ``index_add_``.
"""

from __future__ import annotations

from typing import Optional

import torch

from mrgcn_tpu_torch.ops.compose_kernels import compose_table
from mrgcn_tpu_torch.ops.sorted_stream import _packed_rows, compose_grad_pass


# budgets in padded f32 elements (rows to 8, the minor dimension to 128),
# as the JAX package counts them
DIRECT_BUDGET_ELEMS = 2 ** 27   # the (R * n, out) buffer
MESSAGE_BUDGET_ELEMS = 2 ** 28  # the (E, B * out) gather buffer


def _pad128(x: int) -> int:
    return -(-x // 128) * 128


def _padded_elems(rows: int, minor: int) -> int:
    pad_rows = -(-rows // 8) * 8
    return pad_rows * _pad128(minor)


def segment_sum(messages: torch.Tensor, src: torch.Tensor,
                num_nodes: int) -> torch.Tensor:
    """``out[src_e] += messages_e``; ids outside ``[0, num_nodes)`` are
    dropped, as ``jax.ops.segment_sum`` drops them (padding edges carry
    ``src == num_nodes``)."""
    valid = (src >= 0) & (src < num_nodes)
    idx = torch.where(valid, src, num_nodes)
    out = messages.new_zeros((num_nodes + 1,) + messages.shape[1:])
    return out.index_add(0, idx, messages)[:num_nodes]


class _ChunkMessages(torch.autograd.Function):
    """Per-edge messages of one edge chunk,
    ``m_e = sum_b (comp[rel_e, b] norm_e) flat[dst_e, b]``, keeping only the
    chunk's index arrays: the backward gathers ``flat`` again instead of
    storing the ``(C, B, out)`` rows."""

    @staticmethod
    def forward(ctx, flat, comp, dst, rel, norm, out_dim):
        ctx.save_for_backward(flat, comp, dst, rel, norm)
        ctx.out_dim = out_dim
        return _chunk_messages(flat, comp, dst, rel, norm, out_dim)

    @staticmethod
    def backward(ctx, d_m):
        flat, comp, dst, rel, norm = ctx.saved_tensors
        B = comp.shape[1]
        g = flat.index_select(0, dst).reshape(-1, B, ctx.out_dim)
        w = comp.index_select(0, rel) * norm[:, None]
        d_w = torch.einsum("eo,ebo->eb", d_m, g)
        d_g = (w[:, :, None] * d_m[:, None, :]).reshape(-1, flat.shape[1])
        d_flat = torch.zeros_like(flat).index_add_(0, dst, d_g)
        d_comp = torch.zeros_like(comp).index_add_(0, rel,
                                                   d_w * norm[:, None])
        return d_flat, d_comp, None, None, None, None


def _chunk_messages(flat, comp, dst, rel, norm, out_dim):
    B = comp.shape[1]
    g = flat.index_select(0, dst).reshape(-1, B, out_dim)     # (C, B, out)
    w = comp.index_select(0, rel) * norm[:, None]             # (C, B)
    return torch.einsum("eb,ebo->eo", w, g)                   # (C, out)


def _fused_basis_aggregate(flat: torch.Tensor, src: torch.Tensor,
                           dst: torch.Tensor, rel: torch.Tensor,
                           norm: torch.Tensor, comp: torch.Tensor,
                           num_nodes: int, out_dim: int,
                           budget_elems: int) -> torch.Tensor:
    """``out[s] = sum_e sum_b (comp[rel_e, b] norm_e) flat[dst_e, b * out :
    (b + 1) * out]``.

    ``flat``: ``(n_cols, B * out)``. When the ``(E, B * out)`` gather is over
    the budget the edges go in chunks whose messages are gathered again in
    the backward (:class:`_ChunkMessages`) instead of being kept.
    """
    E = src.shape[0]
    B = comp.shape[1]
    dst, rel = dst.long(), rel.long()
    chunk = max(8, budget_elems // _pad128(B * out_dim))
    if E <= chunk:
        return segment_sum(_chunk_messages(flat, comp, dst, rel, norm,
                                           out_dim), src, num_nodes)
    acc = flat.new_zeros(num_nodes, out_dim)
    for lo in range(0, E, chunk):
        part = slice(lo, lo + chunk)
        msgs = _ChunkMessages.apply(flat, comp, dst[part], rel[part],
                                    norm[part], out_dim)
        acc = acc + segment_sum(msgs, src[part], num_nodes)
    return acc


def _flat_gather_aggregate(table: torch.Tensor, n_cols: int,
                           src: torch.Tensor, dst: torch.Tensor,
                           rel: torch.Tensor, norm: torch.Tensor,
                           num_nodes: int) -> torch.Tensor:
    """One gather from the relation-major ``(R * n_cols, out)`` table and
    one segment sum."""
    flat_idx = rel.long() * n_cols + dst.long()
    messages = table.index_select(0, flat_idx) * norm[:, None]
    return segment_sum(messages, src, num_nodes)


def transform_aggregate(H: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, rel: torch.Tensor,
                        norm: torch.Tensor, num_nodes: int,
                        basis: torch.Tensor,
                        comp: Optional[torch.Tensor] = None,
                        budget_elems: int = DIRECT_BUDGET_ELEMS,
                        message_budget_elems: int = MESSAGE_BUDGET_ELEMS
                        ) -> torch.Tensor:
    """Dense-feature aggregation without a plan or a grouping:
    ``out[s] = sum_e norm_e H[dst_e] W[rel_e]``.

    ``H``: ``(n_cols, in)``; ``basis``: ``(B, in, out)``; ``comp``:
    ``(R, B)`` or None (then relations index the basis directly). Returns
    ``(num_nodes, out)``.
    """
    n_cols = H.shape[0]
    B, _, out_dim = basis.shape
    R = B if comp is None else comp.shape[0]

    if comp is None and _padded_elems(R * n_cols, out_dim) <= budget_elems:
        HW = torch.einsum("ni,rio->rno", H, basis)
        return _flat_gather_aggregate(HW.reshape(R * n_cols, out_dim),
                                      n_cols, src, dst, rel, norm,
                                      num_nodes)

    # fused-basis path: flat = H @ basis laid out (n, B * out)
    flat = torch.einsum("ni,bio->nbo", H, basis).reshape(n_cols,
                                                         B * out_dim)
    comp_eff = torch.eye(B, dtype=H.dtype, device=H.device) \
        if comp is None else comp
    return _fused_basis_aggregate(flat, src, dst, rel, norm, comp_eff,
                                  num_nodes, out_dim, message_budget_elems)


def transform_aggregate_grouped(H: torch.Tensor, grp_src: torch.Tensor,
                                grp_dst: torch.Tensor,
                                grp_norm: torch.Tensor,
                                group_rel: torch.Tensor, group_size: int,
                                num_nodes: int, basis: torch.Tensor,
                                comp: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Relation-grouped dense aggregation: edges are sorted by relation and
    padded so every ``group_size`` consecutive edges share one relation
    (:func:`mrgcn_tpu.encodings.structure.group_by_relation`); each group
    is one batched matmul against its composed ``(in, out)`` weight."""
    W = _compose_weights(basis, comp)             # (R, in, out)
    G = group_rel.shape[0]
    in_dim = H.shape[-1]
    out_dim = W.shape[-1]
    # index_select: its backward is an index_add_, where the backward of
    # H[idx] walks duplicate indices one by one
    Hg = H.index_select(0, grp_dst).reshape(G, group_size, in_dim)
    m = torch.bmm(Hg, W.index_select(0, group_rel))   # (G, group_size, out)
    messages = m.reshape(G * group_size, out_dim) * grp_norm[:, None]
    return segment_sum(messages, grp_src, num_nodes)


def _table(comp: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """``(R, B) x (B, rows, L) -> (R, rows, L)`` through
    :func:`..compose_kernels.compose_table` (kernel #10 on the card, its
    plain matmul on the CPU); ``packed`` may be a row slice."""
    R, B = comp.shape
    return compose_table(comp, _packed_rows(packed, B)).view(
        R, *packed.shape[1:])


def _grads(d_t: torch.Tensor, comp: torch.Tensor, packed: torch.Tensor):
    """Both gradients of :func:`_table` from one read of ``d_t`` through
    :func:`..sorted_stream.compose_grad_pass` (kernel #4 on the card, its
    two plain contractions on the CPU)."""
    R, B = comp.shape
    L = packed.shape[2]
    d_comp, d_packed = compose_grad_pass(d_t.contiguous().view(-1, L),
                                         packed, comp, R, B)
    return d_comp, d_packed.view(packed.shape)


class _ComposePacked(torch.autograd.Function):
    """``(R, B) x (B, rows, L) -> (R, rows, L)``, relation-major, so the
    ``(R * rows, L)`` table view the layer gathers from is free. The
    forward is :func:`_table`; the backward is :func:`_grads` where both
    gradients are needed, else the one library product of
    ``rspmm._compose_packed_bwd``."""

    @staticmethod
    def forward(ctx, comp, packed):
        ctx.save_for_backward(comp, packed)
        return _table(comp, packed)

    @staticmethod
    def backward(ctx, d_t):
        comp, packed = ctx.saved_tensors
        if all(ctx.needs_input_grad):
            return _grads(d_t, comp, packed)
        R, B = comp.shape
        d_flat = d_t.reshape(R, -1)
        if ctx.needs_input_grad[0]:
            return d_flat @ _packed_rows(packed, B).T, None   # rql,bql->rb
        return None, (comp.T @ d_flat).reshape(packed.shape)   # rb,rql->bql


def compose_packed(comp: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Identity-table compose in the packed layout (see
    :class:`_ComposePacked`)."""
    return _ComposePacked.apply(comp, packed)


def _compose_weights(basis: torch.Tensor,
                     comp: Optional[torch.Tensor]) -> torch.Tensor:
    """``W[r] = sum_b comp[r, b] basis[b]``."""
    if comp is None:
        return basis
    return torch.einsum("rb,bio->rio", comp, basis)


def packing_factor(out_dim: int) -> int:
    """How many logical weight rows share one 128-lane line: ``128 / p``
    for the next power of two ``p >= out_dim``, or 1 when ``out_dim > 64``.
    """
    out_p = 1
    while out_p < out_dim:
        out_p *= 2
    return 128 // out_p if out_p <= 64 else 1


def packed_identity_shape(S: int, num_nodes: int, out_dim: int,
                          row_multiple: int = 512):
    """Parameter shape ``(S, rows, lanes)`` of a packed identity weight and
    its packing factor ``k``: ``k`` consecutive node rows share a line,
    rows are rounded up to the stream engine's row block and lanes to 128.
    Padding slots start at zero and are never gathered."""
    k = packing_factor(out_dim)
    n_rows = -(-num_nodes // k)
    n_rows = -(-n_rows // row_multiple) * row_multiple
    lanes = 128 if k > 1 else _pad128(out_dim)
    return (S, n_rows, lanes), k


def gather_aggregate_packed(packed: torch.Tensor, src: torch.Tensor,
                            dst: torch.Tensor, rel: torch.Tensor,
                            norm: torch.Tensor, num_nodes: int, out_dim: int,
                            k: int, comp: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Featureless aggregation over a packed identity weight, without a
    plan: one 128-lane line per edge, then the sub-row select.

    ``packed``: ``(S, n_rows, 128)`` with logical row ``d`` at
    ``packed[s, d // k, (d % k) * (128 // k) : ...]``; ``dst`` indexes the
    global node space.
    """
    S, n_rows, _ = packed.shape
    sub = 128 // k
    if comp is not None:
        flat = compose_packed(comp, packed)
        R = comp.shape[0]
    else:
        flat = packed
        R = S
    flat = flat.reshape(R * n_rows, 128)
    dst = dst.long()
    packed_idx = rel.long() * n_rows + dst // k
    g = flat.index_select(0, packed_idx).reshape(-1, k, sub)   # (E, k, sub)
    sel = torch.nn.functional.one_hot(dst % k, k).to(g.dtype)  # (E, k)
    messages = torch.einsum("ek,eks->es", sel, g)[:, :out_dim]
    return segment_sum(messages * norm[:, None], src, num_nodes)


def gather_aggregate(node_weights: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor, rel: torch.Tensor,
                     norm: torch.Tensor, num_nodes: int,
                     comp: Optional[torch.Tensor] = None,
                     budget_elems: int = DIRECT_BUDGET_ELEMS,
                     message_budget_elems: int = MESSAGE_BUDGET_ELEMS
                     ) -> torch.Tensor:
    """Featureless input layer without a plan:
    ``out[s] = sum_e norm_e W_I[rel_e, dst_e, :]``.

    ``node_weights``: ``(S, n_cols, out)`` with ``S`` the basis or relation
    count; ``comp``: ``(R, S)`` or None.
    """
    S, n_cols, out_dim = node_weights.shape
    if comp is None:
        return _flat_gather_aggregate(
            node_weights.reshape(S * n_cols, out_dim), n_cols, src, dst,
            rel, norm, num_nodes)

    R = comp.shape[0]
    if _padded_elems(R * n_cols, out_dim) <= budget_elems:
        W = torch.einsum("rb,bno->rno", comp, node_weights)
        return _flat_gather_aggregate(W.reshape(R * n_cols, out_dim),
                                      n_cols, src, dst, rel, norm,
                                      num_nodes)

    flat = node_weights.permute(1, 0, 2).reshape(n_cols, S * out_dim)
    return _fused_basis_aggregate(flat, src, dst, rel, norm, comp,
                                  num_nodes, out_dim, message_budget_elems)
