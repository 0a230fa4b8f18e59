"""Weight initializers with torch fan semantics, drawn from a
``torch.Generator`` (counterpart of :mod:`mrgcn_tpu.models.init`).

The reference initializes R-GCN weights with ``nn.init.xavier_uniform_``;
fans follow torch's ``_calculate_fan_in_and_fan_out``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def _torch_fans(shape: Sequence[int]) -> Tuple[int, int]:
    """fan_in = shape[1] * prod(shape[2:]), fan_out = shape[0] * prod(...)."""
    if len(shape) < 2:
        raise ValueError("fan computation needs >= 2 dims")
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _uniform(shape, bound: float, generator: torch.Generator
             ) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u * (2.0 * bound) - bound


def xavier_uniform(shape: Sequence[int], generator: torch.Generator,
                   fan_shape: Sequence[int] = None) -> torch.Tensor:
    """U(-b, b) with ``b = sqrt(6 / (fan_in + fan_out))``; ``fan_shape``
    overrides the shape the fans come from."""
    fin, fout = _torch_fans(fan_shape if fan_shape is not None else shape)
    return _uniform(shape, math.sqrt(6.0 / (fin + fout)), generator)


def packed_xavier_uniform(shape: Sequence[int], fan_shape: Sequence[int],
                          num_nodes: int, out_dim: int, k: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Xavier-uniform for the packed identity layout ``(S, rows, lanes)``
    with the fans of the logical ``(S*n, out)`` matrix; padding slots
    (lanes beyond ``out_dim``, nodes beyond ``num_nodes``) are zero so they
    never reach regularisation or weight decay."""
    vals = xavier_uniform(shape, generator, fan_shape=fan_shape)
    lanes = shape[2]
    sub = lanes // k
    lane = torch.arange(lanes, device=vals.device)
    node_of = (torch.arange(shape[1], device=vals.device)[:, None] * k
               + lane[None, :] // sub)
    valid = (node_of < num_nodes) & ((lane % sub) < out_dim)[None, :]
    return vals * valid[None, :, :].to(vals.dtype)
