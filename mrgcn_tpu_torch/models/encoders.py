"""Modality encoders (PyTorch).

Counterpart of :mod:`mrgcn_tpu.models.encoders`:

* :class:`MLP` (numeric, boolean and temporal literals): Dense -> Dropout
  -> ReLU per layer, widths interpolated from input to output, kernels and
  biases U(0, 1) (reference: perceptron.py:6-46).
* :class:`TextEncoder` with its pre-norm :class:`TextBlock`: every
  attention path of the JAX encoder (``ATTN_IMPLS``: its ``qkv``,
  ``query``/``key``/``value`` or flax multi-head trees, one head or
  several) on the fused attention core, and the fused MLP; bf16 body
  (parameters, LayerNorm statistics and the head stay f32), key-only
  padding mask, CLS pooling and the reference's head (pre_fc -> ReLU ->
  dropout -> fc).
* :class:`TCNN` (WKT geometries, ``(N, C, L)``) in sizes S / M / L: f32
  Conv -> :class:`BatchNorm` -> ReLU stacks with max pooling, then the
  reference's head (reference: temporal_cnn.py:6-156).
* :class:`ImageCNN` (images, ``(N, C, H, W)``): a bf16 convolution body of
  depthwise-separable (``"sep"``) or plain 3x3 (``"dense"``) blocks with
  XLA's ``SAME`` padding, a global average pool in f32 and an f32 head
  (reference: imagecnn.py:9-41).

Parameter names and layouts are the flax ones (``Dense_0.kernel`` as
``(in, out)``, ``LayerNorm_0.scale``, ``_TextBlock_0.qkv``,
``_ConvBNRelu_0.Conv_0.kernel`` as ``(k, C_in, C_out)``, an image
convolution's ``(3, 3, C_in / groups, C_out)``, ...), and the BatchNorm
running statistics are buffers named as flax's ``batch_stats``
(``BatchNorm_0.mean``, ``.var``), so the weight bridge maps the two
packages by path.

Under a device mesh an encoder may run on this rank's block of its rows
(:class:`RowShard`, set by :class:`..models.mrgcn.MRGCN` around the call):
:class:`BatchNorm` then takes its batch statistics over every rank's rows,
and :func:`dropout` draws the mask of all rows and keeps the rank's block,
so both equal the single-device run's.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrgcn_tpu_torch.encodings.features import TCNN_LENGTH_L, TCNN_LENGTH_S
from mrgcn_tpu_torch.models import init as tinit
from mrgcn_tpu_torch.ops.attention import fused_attention
from mrgcn_tpu_torch.ops.fused_mlp import fused_mlp
from mrgcn_tpu_torch.parallel import collectives as coll


@dataclass(frozen=True)
class RowShard:
    """The encoder in progress sees rows ``[start, start + n)`` of
    ``total``; the other rows are on the other ranks of ``group``."""

    group: object
    start: int
    total: int


_ROW_SHARD: ContextVar[Optional[RowShard]] = ContextVar("row_shard",
                                                        default=None)


@contextmanager
def row_shard(shard: RowShard):
    """Run the encoders inside on a block of rows (see :class:`RowShard`)."""
    token = _ROW_SHARD.set(shard)
    try:
        yield
    finally:
        _ROW_SHARD.reset(token)


def dropout(x: torch.Tensor, p: float, train: bool) -> torch.Tensor:
    """``F.dropout``; on a block of rows (:func:`row_shard`), the mask of
    every row is drawn, as the single-device run draws it, and this
    block's rows kept."""
    shard = _ROW_SHARD.get()
    if shard is None or not train or p == 0.0:
        return F.dropout(x, p, training=train)
    mask = F.dropout(x.new_ones((shard.total,) + tuple(x.shape[1:])), p)
    return x * mask[shard.start:shard.start + x.shape[0]]

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
            x = dropout(x, self.p_dropout, train)
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


# TextEncoder's attention paths (the JAX package's ATTN_IMPLS): each names
# a parameter tree, and every one runs the same attention core
# (ops/attention.fused_attention); an unknown value raises
ATTN_IMPLS = ("auto", "xla", "flash", "plain", "plain_fused", "fused_core")
# the paths whose trees hold one (d, d) projection a role: one head only,
# and the key-only mask
SINGLE_HEAD_IMPLS = ("plain", "plain_fused", "fused_core")


def resolve_attn_impl(attn_impl: str, num_heads: int,
                      key_only_mask: bool = True) -> str:
    """The path ``attn_impl`` takes: ``auto`` is ``fused_core`` with one
    head and the key-only mask, ``xla`` otherwise
    (``mrgcn_tpu.models.encoders.TextEncoder``). Raises on an unknown
    value, and on a single-head path with more heads or the full mask."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"Unknown attn_impl {attn_impl!r} (check "
                         f"MRGCN_TEXT_ATTN); expected one of {ATTN_IMPLS}")
    if attn_impl == "auto":
        return "fused_core" if num_heads == 1 and key_only_mask else "xla"
    if attn_impl in SINGLE_HEAD_IMPLS and (num_heads != 1
                                           or not key_only_mask):
        raise ValueError(f"text attention {attn_impl!r} is single-head "
                         "with the key-only mask; got "
                         f"{num_heads} heads, key_only_mask={key_only_mask}")
    return attn_impl


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` over the last axes: ``kernel`` of shape
    ``(*in_shape, *out_shape)`` (flax's ``lecun_normal`` over the
    flattened fans), ``bias`` of ``out_shape``, computed in ``dtype``."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        fan_in, fan_out = math.prod(in_shape), math.prod(out_shape)
        self.kernel = nn.Parameter(tinit.lecun_normal(
            (fan_in, fan_out), generator).reshape(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(out_shape))
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fan_in = math.prod(self.in_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        k = self.kernel.reshape(fan_in, -1).to(self.dtype)
        y = torch.matmul(x.reshape(*lead, fan_in).to(self.dtype), k)
        y = y + self.bias.reshape(-1).to(self.dtype)
        return y.reshape(*lead, *self.out_shape)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention``'s parameters (``query``,
    ``key``, ``value``: kernel ``(d, h, d / h)``, bias ``(h, d / h)``;
    ``out``: kernel ``(h, d / h, d)``, bias ``(d,)``) around the attention
    core on the ``(N, L, h, d / h)`` heads, with the key-only mask: the
    ``xla`` and ``flash`` paths."""

    def __init__(self, model_dim: int, num_heads: int,
                 generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        if model_dim % num_heads:
            raise ValueError(f"{num_heads} heads do not divide "
                             f"model_dim {model_dim}")
        heads = (num_heads, model_dim // num_heads)
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral((model_dim,), heads, generator,
                                             dtype))
        self.out = DenseGeneral(heads, (model_dim,), generator, dtype)

    def forward(self, y: torch.Tensor,
                keys_valid: torch.Tensor) -> torch.Tensor:
        out = fused_attention(self.query(y), self.key(y), self.value(y),
                              keys_valid)
        return self.out(out.reshape(*y.shape[:2], *self.out.in_shape))


class TextBlock(nn.Module):
    """One pre-norm transformer block: attention (its parameter tree as
    ``attn_impl`` names it) and the fused MLP, each added to the residual
    stream.

    * ``fused_core`` / ``plain_fused``: one ``(d, 3d)`` ``qkv`` product,
      the core, the ``out`` Dense;
    * ``plain``: ``query`` / ``key`` / ``value`` / ``out`` Dense;
    * ``xla`` / ``flash``: flax's ``MultiHeadDotProductAttention_0``.

    The core is :func:`..ops.attention.fused_attention` on every path (one
    head: #6 / #7; several: #12). The MLP's parameters are ``Dense_0`` /
    ``Dense_1`` whether the JAX package's ``MRGCN_TEXT_MLP`` picks its
    fused kernel or two Dense layers (the same tree); the port runs the
    fused MLP either way."""

    def __init__(self, model_dim: int, generator: torch.Generator,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "fused_core", num_heads: int = 1):
        super().__init__()
        d = model_dim
        self.model_dim = d
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.LayerNorm_0 = LayerNorm(d, dtype)
        if attn_impl in ("plain_fused", "fused_core"):
            self.qkv = Dense(d, 3 * d, generator, dtype=dtype)
        elif attn_impl == "plain":
            for name in ("query", "key", "value"):
                setattr(self, name, Dense(d, d, generator, dtype=dtype))
        else:
            self.MultiHeadDotProductAttention_0 = \
                MultiHeadDotProductAttention(d, num_heads, generator, dtype)
        if attn_impl in SINGLE_HEAD_IMPLS:
            self.out = Dense(d, d, generator, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(d, dtype)
        self.Dense_0 = DenseParams(d, 4 * d, generator)
        self.Dense_1 = DenseParams(4 * d, d, generator)

    def attention(self, y: torch.Tensor,
                  keys_valid: torch.Tensor) -> torch.Tensor:
        d = self.model_dim
        if self.attn_impl in ("plain_fused", "fused_core"):
            qkv = self.qkv(y)
            q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        elif self.attn_impl == "plain":
            q, k, v = self.query(y), self.key(y), self.value(y)
        else:
            return self.MultiHeadDotProductAttention_0(y, keys_valid)
        return self.out(fused_attention(q, k, v, keys_valid))

    def forward(self, x: torch.Tensor,
                keys_valid: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x + self.attention(self.LayerNorm_0(x), keys_valid)
        y = fused_mlp(self.LayerNorm_1(x), self.Dense_0.kernel.to(dt),
                      self.Dense_0.bias.to(dt), self.Dense_1.kernel.to(dt),
                      self.Dense_1.bias.to(dt))
        return x + y.to(dt)


class TextEncoder(nn.Module):
    """Trainable sequence encoder with CLS pooling and the reference's head
    (pre_fc -> ReLU -> dropout -> fc). Tokens ``(N, L)`` int, ``pad_id``
    marking padding; returns ``(N, output_dim)`` f32.

    ``attn_impl`` (one of ``ATTN_IMPLS``; :func:`resolve_attn_impl`)
    picks the blocks' attention tree; ``num_heads`` divides
    ``model_dim``. ``key_only_mask = False`` stands for the JAX encoder's
    full query x key mask: it gives the same valid rows (its padding query
    rows reach no output), so the port masks keys alone either way; it
    only moves ``auto`` to ``xla``, as there."""

    def __init__(self, output_dim: int, generator: torch.Generator,
                 vocab_size: int = 259, model_dim: int = 128,
                 num_heads: int = 1, num_layers: int = 2,
                 p_dropout: float = 0.2, max_len: int = 512,
                 pad_id: int = 256, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", key_only_mask: bool = True):
        super().__init__()
        impl = resolve_attn_impl(attn_impl, num_heads, key_only_mask)
        d = model_dim
        self.attn_impl = impl
        self.pad_id = pad_id
        self.p_dropout = p_dropout
        self.num_layers = num_layers
        self.dtype = dtype
        self.embedding = nn.Parameter(tinit.embedding_normal(
            (vocab_size, d), generator))
        self.pos_embedding = nn.Parameter(tinit.normal(0.02)(
            (max_len, d), generator))
        for i in range(num_layers):
            setattr(self, f"_TextBlock_{i}", TextBlock(
                d, generator, dtype, attn_impl=impl, num_heads=num_heads))
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
        pooled = dropout(pooled, self.p_dropout, train)
        return self.Dense_1(pooled)


# --------------------------------------------------------------------------
# convolutional encoders: TCNN (WKT geometries) and ImageCNN (images)
# --------------------------------------------------------------------------

# minimal input length per TCNN size; size M takes LENGTH_L as its minimal
# length (reference: temporal_cnn.py:7-9, 57)
TCNN_MINIMAL_LENGTH = {"S": TCNN_LENGTH_S, "M": TCNN_LENGTH_L,
                       "L": TCNN_LENGTH_L}


def adaptive_max_pool1d(x: torch.Tensor, output_size: int) -> torch.Tensor:
    """Max over windows ``[floor(i L / k), ceil((i + 1) L / k))`` of the
    length axis of ``(N, C, L)``: torch's ``AdaptiveMaxPool1d``, the JAX
    package's windows."""
    return F.adaptive_max_pool1d(x, output_size)


def same_padding(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: ``ceil(size / stride)``
    outputs, the extra pad on the high side (at stride 2 and an even size,
    3x3 windows pad ``(0, 1)`` where torch's ``padding=1`` pads
    ``(1, 1)``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over axis 1 of
    ``(N, C, ...)``: parameters ``scale``, ``bias``; the running
    statistics are the buffers ``mean`` (zeros) and ``var`` (ones),
    flax's ``batch_stats``.

    With ``train`` the batch's statistics normalize (reduced in f32, also
    for a bf16 input) and the buffers move to
    ``0.9 * running + 0.1 * batch``, where the batch variance is the biased
    one, ``E[x^2] - E[x]^2``, as flax keeps it (torch's ``BatchNorm*d``
    would keep the unbiased one). Without it the running statistics
    normalize and the buffers stay. The output has the input's dtype. On a
    block of rows (:func:`row_shard`) the batch statistics are those of
    every rank's rows: the per-rank sums are all-reduced in f32 (f64 for
    an f64 input), the mean first, then the squared deviations from it."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum = momentum
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, training=False, eps=self.epsilon)
        shard = _ROW_SHARD.get()
        if shard is not None:
            return self._across_ranks(x, shard)
        count = x.numel() // x.shape[1]
        if count == 1:
            # torch takes no batch statistics of one value per channel;
            # flax's are the value itself and variance 0
            shape = (1, -1) + (1,) * (x.ndim - 2)
            batch_mean = x.detach().float().reshape(-1)
            batch_var = torch.zeros_like(self.var)
            y = ((x - x) * self.scale.view(shape)
                 + self.bias.view(shape)).to(x.dtype)
        else:
            # momentum 1: the scratch buffers take this batch's mean and
            # its unbiased variance, rescaled to the biased one below
            batch_mean = torch.zeros_like(self.mean)
            batch_var = torch.ones_like(self.var)
            y = F.batch_norm(x, batch_mean, batch_var, self.scale,
                             self.bias, training=True, momentum=1.0,
                             eps=self.epsilon)
            batch_var = batch_var * ((count - 1) / count)
        self._update(batch_mean, batch_var)
        return y

    @torch.no_grad()
    def _update(self, batch_mean: torch.Tensor,
                batch_var: torch.Tensor) -> None:
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * batch_mean)
        self.var.copy_(m * self.var + (1 - m) * batch_var)

    def _across_ranks(self, x: torch.Tensor, shard: RowShard
                      ) -> torch.Tensor:
        """Training-mode batch norm of this rank's rows with the statistics
        of all rows (two all-reduces, each the transpose of its own
        backward)."""
        axes = [0] + list(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        count = shard.total * (x[:1, :1].numel())
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = coll.all_reduce(xf.sum(axes), shard.group) / count
        centred = xf - mean.view(shape)
        var = coll.all_reduce(centred.square().sum(axes), shard.group) \
            / count
        y = centred * torch.rsqrt(var + self.epsilon).view(shape) \
            * self.scale.view(shape) + self.bias.view(shape)
        self._update(mean.detach(), var.detach())
        return y.to(x.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` over ``(N, C, *spatial)``: ``kernel`` as
    ``(*window, C_in / groups, C_out)``, an optional ``bias`` (zeros),
    computed in ``dtype`` (input, kernel and bias cast to it) or, with
    ``dtype=None``, in the input's type. ``padding`` is one ``(lo, hi)``
    pair per spatial axis, or ``"SAME"`` (:func:`same_padding`)."""

    def __init__(self, in_features: int, features: int,
                 window: Tuple[int, ...], generator: torch.Generator,
                 kernel_init: Callable = tinit.lecun_normal,
                 use_bias: bool = True, stride: int = 1,
                 padding="SAME", groups: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = nn.Parameter(kernel_init(
            (*window, in_features // groups, features), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None
        self.window = tuple(window)
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = len(self.window)
        dtype = self.dtype or torch.promote_types(x.dtype,
                                                  self.kernel.dtype)
        pads = [same_padding(n, k, self.stride) for n, k in
                zip(x.shape[2:], self.window)] \
            if self.padding == "SAME" else list(self.padding)
        x = x.to(dtype)
        if any(lo != hi for lo, hi in pads):
            # F.pad takes the last axis first
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            pads = [(0, 0)] * nd
        weight = self.kernel.permute(nd + 1, nd, *range(nd)).to(dtype)
        bias = self.bias.to(dtype) if self.bias is not None else None
        conv = F.conv1d if nd == 1 else F.conv2d
        return conv(x, weight, bias, self.stride, [lo for lo, _ in pads],
                    groups=self.groups)


class _ConvBNRelu(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int,
                 padding: int, generator: torch.Generator):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (kernel,), generator,
                           kernel_init=tinit.torch_linear_kernel,
                           padding=((padding, padding),))
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x), train))


# channel plans per size (reference: temporal_cnn.py:24-139): stages of
# (features, kernel, padding) convolutions, each followed by its pool
# (("max", k) | ("adaptive", k) | None), and the head's width
_TCNN_PLANS = {
    "S": ([([(64, 3, 1), (64, 3, 1)], ("max", 2)),
           ([(128, 3, 1), (128, 3, 1)], ("max", 2)),
           ([(256, 3, 1), (256, 3, 1)], ("adaptive", 2)),
           ([(512, 2, 0)], None)], 512),
    "M": ([([(64, 7, 3), (64, 7, 3)], ("max", 3)),
           ([(128, 3, 1), (128, 3, 1)], ("max", 3)),
           ([(256, 3, 1), (256, 3, 1)], ("adaptive", 3)),
           ([(512, 3, 1), (512, 3, 1), (1024, 3, 0)], None)], 1024),
    "L": ([([(64, 7, 3), (64, 7, 3)], ("max", 3)),
           ([(128, 7, 3), (128, 7, 3)], ("max", 3)),
           ([(256, 3, 1), (256, 3, 1)], ("max", 3)),
           ([(512, 3, 1), (512, 3, 1)], ("adaptive", 3)),
           ([(1024, 3, 1), (1024, 3, 1), (2048, 3, 0)], None)], 2048),
}


class TCNN(nn.Module):
    """Temporal CNN over ``(N, C, L)`` sequences (WKT geometries: C = 9)
    in sizes S / M / L; an input of at least ``TCNN_MINIMAL_LENGTH[size]``
    points leaves one position, whose ``cnn_out`` channels the head reads
    (reference: temporal_cnn.py:6-156)."""

    def __init__(self, input_dim: int, output_dim: int,
                 generator: torch.Generator, size: str = "M",
                 p_dropout: float = 0.0):
        super().__init__()
        stages, cnn_out = _TCNN_PLANS[size]
        self.pools = []
        prev, i = input_dim, 0
        for convs, pool in stages:
            for features, kernel, padding in convs:
                setattr(self, f"_ConvBNRelu_{i}", _ConvBNRelu(
                    prev, features, kernel, padding, generator))
                prev, i = features, i + 1
            self.pools.append((len(convs), pool))
        self.p_dropout = p_dropout
        self.Dense_0 = Dense(cnn_out, cnn_out, generator,
                             kernel_init=tinit.torch_linear_kernel,
                             bias_init=tinit.torch_linear_bias(cnn_out))
        self.Dense_1 = Dense(cnn_out, output_dim, generator,
                             kernel_init=tinit.torch_linear_kernel,
                             bias_init=tinit.torch_linear_bias(cnn_out))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        i = 0
        for num_convs, pool in self.pools:
            for _ in range(num_convs):
                x = getattr(self, f"_ConvBNRelu_{i}")(x, train)
                i += 1
            if pool is not None:
                kind, k = pool
                x = F.max_pool1d(x, k, k) if kind == "max" \
                    else adaptive_max_pool1d(x, k)
        # flatten as the JAX package's (N, L', C') rows are, l-major
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        x = dropout(x, self.p_dropout, train)
        return self.Dense_1(x)


class _SeparableBlock(nn.Module):
    """Depthwise 3x3 (``groups = C_in``) -> BatchNorm -> ReLU -> pointwise
    1x1 -> BatchNorm -> ReLU, convolutions in ``dtype``."""

    def __init__(self, in_features: int, features: int, stride: int,
                 generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(in_features, in_features, (3, 3), generator,
                           use_bias=False, stride=stride,
                           groups=in_features, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_1 = Conv(in_features, features, (1, 1), generator,
                           use_bias=False, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        return torch.relu(self.BatchNorm_1(self.Conv_1(x), train))


class _DenseBlock(nn.Module):
    """Plain 3x3 convolution -> BatchNorm -> ReLU, in ``dtype``."""

    def __init__(self, in_features: int, features: int, stride: int,
                 generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (3, 3), generator,
                           use_bias=False, stride=stride, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x), train))


class ImageCNN(nn.Module):
    """Compact image CNN over normalized ``(N, C, H, W)`` f32 images: a
    stride-2 stem and seven ``block_impl`` blocks (``"sep"``: depthwise
    separable, MobileNet-style; ``"dense"``: plain 3x3), convolutions in
    ``dtype`` with parameters in f32, then a global average pool in f32
    and the reference's head in f32 (reference: imagecnn.py:9-41)."""

    def __init__(self, output_dim: int, generator: torch.Generator,
                 p_dropout: float = 0.2, width: int = 32,
                 dtype: torch.dtype = torch.bfloat16,
                 block_impl: str = "sep", in_channels: int = 3):
        super().__init__()
        w = width
        block, name = (_DenseBlock, "_DenseBlock") \
            if block_impl == "dense" else (_SeparableBlock,
                                           "_SeparableBlock")
        self.Conv_0 = Conv(in_channels, w, (3, 3), generator,
                           use_bias=False, stride=2, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(w)
        self.blocks = []
        prev = w
        for i, (features, stride) in enumerate(
                ((w * 2, 2), (w * 2, 1), (w * 4, 2), (w * 4, 1),
                 (w * 8, 2), (w * 8, 1), (w * 16, 2))):
            setattr(self, f"{name}_{i}", block(prev, features, stride,
                                               generator, dtype))
            self.blocks.append(f"{name}_{i}")
            prev = features
        self.p_dropout = p_dropout
        self.Dense_0 = Dense(prev, prev, generator,
                             kernel_init=tinit.torch_linear_kernel)
        self.Dense_1 = Dense(prev, output_dim, generator,
                             kernel_init=tinit.torch_linear_kernel)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = x.float().mean(dim=(2, 3))          # global average pool
        x = torch.relu(self.Dense_0(x))
        x = dropout(x, self.p_dropout, train)
        return self.Dense_1(x)
