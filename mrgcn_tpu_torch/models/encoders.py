"""Modality encoders: MLP and the from-scratch text encoder (PyTorch).

Counterpart of :mod:`mrgcn_tpu.models.encoders` for the encoders the
multimodal slice runs:

* :class:`MLP` (numeric, boolean and temporal literals): Dense -> Dropout
  -> ReLU per layer, widths interpolated from input to output, kernels and
  biases U(0, 1) (reference: perceptron.py:6-46).
* :class:`TextEncoder` with its pre-norm :class:`TextBlock` on the
  single-head ``fused_core`` attention and the fused MLP, the JAX
  encoder's default path: bf16 body (parameters, LayerNorm statistics and
  the head stay f32), key-only padding mask, CLS pooling and the
  reference's head (pre_fc -> ReLU -> dropout -> fc).

Parameter names and layouts are the flax ones (``Dense_0.kernel`` as
``(in, out)``, ``LayerNorm_0.scale``, ``_TextBlock_0.qkv``, ...), so the
weight bridge maps the two packages by path. The other text paths, the
temporal and image CNNs and pretrained backbones raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrgcn_tpu_torch.models import init as tinit
from mrgcn_tpu_torch.ops.attention import fused_attention
from mrgcn_tpu_torch.ops.fused_mlp import fused_mlp

TODO_TEXT = "ROADMAP Queue 1, item 3 (multi-head and xla/flash attention)"


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel (in, out)``, ``bias (out,)``, computed in
    ``dtype`` (inputs and parameters cast to it) or, with ``dtype=None``,
    in the inputs' type."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator,
                 kernel_init: Callable = tinit.lecun_normal,
                 bias_init: Callable = tinit.zeros, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = nn.Parameter(kernel_init((in_features, features),
                                               generator))
        self.bias = nn.Parameter(bias_init((features,), generator)) \
            if use_bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype,
                                                  self.kernel.dtype)
        y = torch.matmul(x.to(dtype), self.kernel.to(dtype))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6): f32 statistics with
    ``var = E[x^2] - E[x]^2`` clipped at 0, ``scale``/``bias`` applied in
    f32, the result cast to ``dtype``."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 epsilon: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype or x.dtype)


class MLP(nn.Module):
    """N-layer perceptron with linearly interpolated widths; every layer is
    Dense -> Dropout -> ReLU (the last included), parameters U(0, 1)."""

    def __init__(self, input_dim: int, output_dim: int,
                 generator: torch.Generator, num_layers: int = 1,
                 p_dropout: float = 0.0, use_bias: bool = True):
        super().__init__()
        step = (input_dim - output_dim) // num_layers
        widths = [output_dim + i * step
                  for i in reversed(range(num_layers))]
        self.p_dropout = p_dropout
        self.num_layers = num_layers
        prev = input_dim
        for i, width in enumerate(widths):
            setattr(self, f"Dense_{i}", Dense(
                prev, width, generator, kernel_init=tinit.unit_uniform,
                bias_init=tinit.unit_uniform, use_bias=use_bias))
            prev = width

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = F.dropout(x, self.p_dropout, training=train)
            x = torch.relu(x)
        return x


class DenseParams(nn.Module):
    """A Dense layer's ``kernel``/``bias`` (flax ``lecun_normal``, zeros)
    without the product: the fused MLP consumes them."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(tinit.lecun_normal(
            (in_features, features), generator))
        self.bias = nn.Parameter(torch.zeros(features))


class TextBlock(nn.Module):
    """One pre-norm transformer block: single-head fused attention (one
    ``(d, 3d)`` QKV product, the fused core, the output Dense) and the
    fused MLP, each added to the residual stream."""

    def __init__(self, model_dim: int, generator: torch.Generator,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        d = model_dim
        self.model_dim = d
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(d, dtype)
        self.qkv = Dense(d, 3 * d, generator, dtype=dtype)
        self.out = Dense(d, d, generator, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(d, dtype)
        self.Dense_0 = DenseParams(d, 4 * d, generator)
        self.Dense_1 = DenseParams(4 * d, d, generator)

    def forward(self, x: torch.Tensor,
                keys_valid: torch.Tensor) -> torch.Tensor:
        d, dt = self.model_dim, self.dtype
        qkv = self.qkv(self.LayerNorm_0(x))
        y = fused_attention(qkv[..., :d], qkv[..., d:2 * d],
                            qkv[..., 2 * d:], keys_valid)
        x = x + self.out(y)
        y = fused_mlp(self.LayerNorm_1(x), self.Dense_0.kernel.to(dt),
                      self.Dense_0.bias.to(dt), self.Dense_1.kernel.to(dt),
                      self.Dense_1.bias.to(dt))
        return x + y.to(dt)


class TextEncoder(nn.Module):
    """Trainable sequence encoder with CLS pooling and the reference's head
    (pre_fc -> ReLU -> dropout -> fc). Tokens ``(N, L)`` int, ``pad_id``
    marking padding; returns ``(N, output_dim)`` f32."""

    def __init__(self, output_dim: int, generator: torch.Generator,
                 vocab_size: int = 259, model_dim: int = 128,
                 num_heads: int = 1, num_layers: int = 2,
                 p_dropout: float = 0.2, max_len: int = 512,
                 pad_id: int = 256, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ("auto", "fused_core") or num_heads != 1:
            raise NotImplementedError(
                f"text attention {attn_impl!r} with {num_heads} head(s): "
                f"only the single-head fused_core path is ported "
                f"({TODO_TEXT})")
        d = model_dim
        self.pad_id = pad_id
        self.p_dropout = p_dropout
        self.num_layers = num_layers
        self.dtype = dtype
        self.embedding = nn.Parameter(tinit.embedding_normal(
            (vocab_size, d), generator))
        self.pos_embedding = nn.Parameter(tinit.normal(0.02)(
            (max_len, d), generator))
        for i in range(num_layers):
            setattr(self, f"_TextBlock_{i}", TextBlock(d, generator, dtype))
        self.LayerNorm_0 = LayerNorm(d, dtype)
        self.Dense_0 = Dense(d, d, generator,
                             kernel_init=tinit.torch_linear_kernel)
        self.Dense_1 = Dense(d, output_dim, generator,
                             kernel_init=tinit.torch_linear_kernel)

    def forward(self, tokens: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        L = tokens.shape[1]
        keys_valid = tokens != self.pad_id
        # F.embedding's backward sums each token's rows in segments; the
        # autograd of plain indexing (index_put with accumulate) walks the
        # 1M positions of the ~259 tokens one after another
        x = F.embedding(tokens.long(), self.embedding.to(self.dtype))
        x = x + self.pos_embedding[:L][None].to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"_TextBlock_{i}")(x, keys_valid)
        x = self.LayerNorm_0(x)
        pooled = torch.relu(self.Dense_0(x[:, 0].float()))
        pooled = F.dropout(pooled, self.p_dropout, training=train)
        return self.Dense_1(pooled)
