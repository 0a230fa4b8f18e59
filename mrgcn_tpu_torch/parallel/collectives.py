"""Collectives with autograd: the port's ``psum`` and its all-gathers.

One process runs each device (:mod:`.mesh`), so the collectives that
``shard_map`` and GSPMD insert in the JAX package are explicit calls here,
each a ``torch.autograd.Function`` whose backward is its transpose:

* :func:`all_reduce` (``psum``): backward all-reduces the cotangent;
* :func:`all_gather_rows` (rows of every rank stacked in group order):
  backward reduce-scatters the cotangent, so each rank keeps the sum of
  every rank's cotangent for its own rows.

Every rank's gradient is then a share: each rank scales its loss by
1 / world, and the shares of a parameter sum to the single-device
gradient (:func:`..parallel.mesh.reduce_gradients` sums them). A group of
one rank passes its tensor through untouched unless ``ONE_RANK_PASSES`` is
False, as a check of the backend's collectives in a world of one rank
sets it (a sum over one rank is that rank's tensor, to the bit).
``TRAFFIC`` counts the bytes each rank hands to the collectives (forward
and backward), for the card's report of bytes moved per step.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

# bytes handed to each collective by this process since the last reset
TRAFFIC: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                           "reduce_scatter": 0}
# whether a group of one rank skips the backend
ONE_RANK_PASSES = True

# torch renamed the tensor forms of the two collectives; either takes
# (output, input, ..., group=)
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reset_traffic() -> None:
    for key in TRAFFIC:
        TRAFFIC[key] = 0


def group_size(group) -> int:
    return dist.get_world_size(group)


def _passes(group) -> bool:
    """Whether a collective over ``group`` is the identity and skipped."""
    return ONE_RANK_PASSES and group_size(group) == 1


def _bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (no autograd); returns ``x``."""
    if not _passes(group):
        TRAFFIC["all_reduce"] += _bytes(x)
        dist.all_reduce(x, group=group)
    return x


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) stacked along dim 0 in group-rank
    order, without autograd."""
    if _passes(group):
        return x
    n = group_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    TRAFFIC["all_gather"] += _bytes(x)
    _gather_into(out, x, group=group)
    return out


def scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, keeping this rank's block of rows
    (dim 0 split in group-rank order): the transpose of
    :func:`gather_rows`."""
    if _passes(group):
        return x
    n = group_size(group)
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    TRAFFIC["reduce_scatter"] += _bytes(x)
    _scatter_from(out, x, group=group)
    return out


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return scatter_rows(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``psum`` over ``group``: every rank gets the sum of the ranks'
    ``x``; the backward sums the ranks' cotangents."""
    if _passes(group):
        return x
    return _AllReduce.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x`` (equal shapes) stacked along dim 0 in
    group-rank order; the backward keeps, on each rank, the sum over the
    group of the cotangents of its own rows."""
    if _passes(group):
        return x
    return _AllGatherRows.apply(x, group)


def gather_basis(p: torch.Tensor) -> torch.Tensor:
    """The whole weight of a basis slice (a parameter tagged
    ``basis_slice`` by :func:`..parallel.mesh.shard_params`),
    all-gathered over its ``model`` group: each slice's gradient is then
    the sum over the group of the ranks' shares. Any other tensor as it
    is."""
    s = getattr(p, "basis_slice", None)
    return p if s is None else all_gather_rows(p, s.group)
