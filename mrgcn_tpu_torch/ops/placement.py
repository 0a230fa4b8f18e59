"""Row placement of encoder outputs: ``X[node_idx[j]] = out[j]``.

Counterpart of :mod:`mrgcn_tpu.ops.placement`. Both directions are row
gathers: forward ``X = padded_out[rows]`` through an inverse map
(``rows[n] = j`` where ``node_idx[j] == n``, else the appended zero row),
backward ``d_out[j] = d_X[node_idx[j]]``, zero for padding indices outside
``[0, num_rows)``. Each valid node index appears at most once per encoding
set (``features.densify`` checks it). Plain PyTorch: no TPU kernel stands
behind these.
"""

from __future__ import annotations

import numpy as np
import torch


def build_rows(node_idx, num_rows: int) -> np.ndarray:
    """Host-side inverse map for :func:`place_rows_pre`: ``rows[n] = j``
    where ``node_idx[j] == n``, else ``m`` (the zero row). Entries of
    ``node_idx`` outside ``[0, num_rows)`` are padding and ignored."""
    idx = np.asarray(node_idx)
    m = idx.shape[0]
    rows = np.full(num_rows, m, dtype=np.int32)
    valid = (idx >= 0) & (idx < num_rows)
    rows[idx[valid]] = np.nonzero(valid)[0]
    return rows


def _gather_back(d_X: torch.Tensor, node_idx: torch.Tensor) -> torch.Tensor:
    """``d_out[j] = d_X[node_idx[j]]``, zero where ``node_idx[j]`` is
    outside ``[0, num_rows)``."""
    num_rows = d_X.shape[0]
    in_range = (node_idx >= 0) & (node_idx < num_rows)
    safe = torch.where(in_range, node_idx, torch.zeros_like(node_idx))
    return d_X[safe.long()] * in_range[:, None].to(d_X.dtype)


def _with_zero_row(out: torch.Tensor) -> torch.Tensor:
    return torch.cat([out, out.new_zeros(1, out.shape[1])], dim=0)


class _PlaceRowsPre(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out, node_idx, rows):
        ctx.save_for_backward(node_idx)
        return _with_zero_row(out)[rows.long()]

    @staticmethod
    def backward(ctx, d_X):
        (node_idx,) = ctx.saved_tensors
        return _gather_back(d_X, node_idx), None, None


def place_rows_pre(out: torch.Tensor, node_idx: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """``(num_rows, dim)`` X with ``X[node_idx[j]] = out[j]``, zeros
    elsewhere, given ``rows = build_rows(node_idx, num_rows)``."""
    return _PlaceRowsPre.apply(out, node_idx, rows)


class _PlaceRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out, node_idx, num_rows):
        m = out.shape[0]
        order = torch.argsort(node_idx, stable=True)
        sidx = node_idx[order]
        want = torch.arange(num_rows, dtype=sidx.dtype, device=sidx.device)
        pos = torch.clamp(torch.searchsorted(sidx, want), max=m - 1)
        hit = sidx[pos] == want
        rows = torch.where(hit, order[pos], torch.full_like(pos, m))
        ctx.save_for_backward(node_idx)
        return _with_zero_row(out)[rows]

    @staticmethod
    def backward(ctx, d_X):
        (node_idx,) = ctx.saved_tensors
        return _gather_back(d_X, node_idx), None, None


def place_rows(out: torch.Tensor, node_idx: torch.Tensor,
               num_rows: int) -> torch.Tensor:
    """:func:`place_rows_pre` with the inverse map found on the device
    (sort and binary search); entries of ``node_idx`` outside
    ``[0, num_rows)`` are dropped."""
    if out.shape[0] == 0:
        return out.new_zeros(num_rows, out.shape[1])
    return _PlaceRows.apply(out, node_idx, num_rows)
