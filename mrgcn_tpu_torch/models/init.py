"""Weight initializers with torch fan semantics, drawn from a
``torch.Generator`` (counterpart of :mod:`mrgcn_tpu.models.init`).

The reference initializes R-GCN weights with ``nn.init.xavier_uniform_``;
fans follow torch's ``_calculate_fan_in_and_fan_out``. The encoders use
flax's initializers as the JAX package does (``unit_uniform`` for the MLP
encoders, ``lecun_normal`` for the transformer's Dense layers, torch
Linear's uniform for the heads, normal embeddings). Every initializer
takes ``(shape, generator)``; the draws differ from JAX's, the
distributions do not.
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


# --------------------------------------------------------------------------
# the encoders' initializers (flax's, with the fans of an (in, out) kernel)
# --------------------------------------------------------------------------

def unit_uniform(shape: Sequence[int], generator: torch.Generator
                 ) -> torch.Tensor:
    """U(0, 1): the reference MLP's init."""
    return torch.rand(tuple(shape), generator=generator,
                      dtype=torch.float32, device=generator.device)


def torch_linear_kernel(shape: Sequence[int], generator: torch.Generator
                        ) -> torch.Tensor:
    """torch Linear's default for a flax ``(in, out)`` kernel:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = every dim but the last."""
    return _uniform(shape, 1.0 / math.sqrt(math.prod(shape[:-1])), generator)


def torch_linear_bias(fan_in: int):
    def init(shape, generator):
        return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)
    return init


def lecun_normal(shape: Sequence[int], generator: torch.Generator
                 ) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated to two standard
    deviations, scaled to variance 1/fan_in (fan_in = every dim but the
    last)."""
    fan_in = math.prod(shape[:-1])
    # std of the unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    out = torch.empty(tuple(shape), dtype=torch.float32,
                      device=generator.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return out * std


def embedding_normal(shape: Sequence[int], generator: torch.Generator
                     ) -> torch.Tensor:
    """flax ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)`` on a
    ``(vocab, dim)`` table: N(0, 1/dim)."""
    return normal(1.0 / math.sqrt(shape[1]))(shape, generator)


def normal(stddev: float):
    def init(shape, generator):
        return torch.randn(tuple(shape), generator=generator,
                           dtype=torch.float32,
                           device=generator.device) * stddev
    return init


def zeros(shape: Sequence[int], generator: torch.Generator
          ) -> torch.Tensor:
    del generator
    return torch.zeros(tuple(shape), dtype=torch.float32)
