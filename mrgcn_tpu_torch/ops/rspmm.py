"""Relational sparse-dense products for R-GCN layers (PyTorch).

Counterpart of :mod:`mrgcn_tpu.ops.rspmm` for the featureless full-batch
path: the packed identity-weight layout, its relation-major compose, and
the relation-grouped dense aggregation the restricted output layer runs.

Edge semantics: ``out[s] = sum_e norm_e * (H[dst_e] @ W[rel_e])`` with
basis decomposition ``W[r] = sum_b comp[r, b] * basis[b]``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _pad128(x: int) -> int:
    return -(-x // 128) * 128


def segment_sum(messages: torch.Tensor, src: torch.Tensor,
                num_nodes: int) -> torch.Tensor:
    """``out[src_e] += messages_e``; ids outside ``[0, num_nodes)`` are
    dropped, as ``jax.ops.segment_sum`` drops them (padding edges carry
    ``src == num_nodes``)."""
    valid = (src >= 0) & (src < num_nodes)
    idx = torch.where(valid, src, num_nodes)
    out = messages.new_zeros((num_nodes + 1,) + messages.shape[1:])
    return out.index_add(0, idx, messages)[:num_nodes]


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


class _ComposePacked(torch.autograd.Function):
    """``(R, B) x (B, rows, L) -> (R, rows, L)``, relation-major, so the
    ``(R * rows, L)`` table view the layer gathers from is free. The
    backward is the two matmuls of ``rspmm._compose_packed_bwd``."""

    @staticmethod
    def forward(ctx, comp, packed):
        ctx.save_for_backward(comp, packed)
        return torch.tensordot(comp, packed, dims=([1], [0]))

    @staticmethod
    def backward(ctx, d_t):
        comp, packed = ctx.saved_tensors
        R, B = comp.shape
        d_flat = d_t.reshape(R, -1)
        p_flat = packed.reshape(B, -1)
        d_comp = d_packed = None
        if ctx.needs_input_grad[0]:
            d_comp = d_flat @ p_flat.T                       # rql,bql->rb
        if ctx.needs_input_grad[1]:
            d_packed = (comp.T @ d_flat).reshape(packed.shape)  # rb,rql->bql
        return d_comp, d_packed


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
