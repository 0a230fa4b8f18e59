"""Fused attention core, one head or several: the CUDA kernels and their
plain version.

Counterpart of :mod:`mrgcn_tpu.ops.attention` (``fused_attention``, the
single-head core, kernels #6 / #7) and of the multi-head attention that
``mrgcn_tpu.models.encoders._flash_attention_fn`` runs on the Pallas TPU
FlashAttention kernels (#12): attention over ``(N, L, d)`` (one head) or
``(N, L, H, d)`` (H heads of width d, flax's layout) with a key-only
padding mask. :func:`fused_attention` multiplies ``q`` by ``1/sqrt(d)``
in the input type before the core, as the JAX wrapper does; the core
computes, for each sequence and head,

    s = q k^T (f32), s = -1e9 at padding keys, p = softmax(s) (f32),
    out = bf16(p) v   (f32 sums, cast to the input type)

and its backward recomputes ``p``. A padding key's logit is replaced by
-1e9, as the plain chain (``xla_attention``) does, so a sequence whose keys
are all padding gets a uniform softmax and no logit gradient at its padding
keys. Flash attention's segment ids differ from this key mask at padding
query rows only (flash lets them attend padding keys); no output reaches
those rows.

One head (``(N, L, d)``, or ``H = 1``) runs ``csrc/fused_attention.cu``
(#6 / #7): one tiled family for every ``1 <= L <= 512``; a thread block
owns ``KEY_TILE`` rows of one sequence a warpgroup and streams the other
side through shared memory in tiles of ``KEY_TILE`` rows, loaded by TMA
and multiplied by ``wgmma``. The forward runs an online softmax over the
key tiles; the backward is two launches, ``dq`` with each row's softmax
statistics, then the key-major ``dk`` / ``dv``. Key tiles without a valid
key are skipped. :func:`live_key_tiles` states the skipping rule in plain
PyTorch, for the tests that hold the kernels to it.

More heads (#12) run ``csrc/fused_attention_heads.cu``: the same walks, but
a block owns a group of heads of one sequence, each head in its own
shared-memory slab of its padded width, and every product runs at that
width; each head's sums are the single-head kernel's, in its order.
:func:`head_plan` is the launch plan the wrappers hand that library (it
checks the plan against ``(H, d)``).

CPU tensors take the plain version (:func:`attention_fwd_reference`,
:func:`attention_bwd_reference`); CUDA tensors launch the kernels or
raise. ``attention_fwd.launches`` and ``attention_bwd.launches`` count the
single-head calls that launched (#6 / #7), ``.launches_heads`` the calls
with more than one head (#12).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from mrgcn_tpu_torch.ops import _build

MASKED = -1e9
# the kernels' limits, raised on here with a message (the C entry points
# refuse the same shapes), and the rows of a key tile
MAX_LEN = 512          # the text encoder's tokenizer limit
MAX_DIM = 128
KEY_TILE = 64

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "mrgcn_attention_fwd_bf16": ([_P] * 5 + [_I] * 4 + [_P, _P], _I),
    "mrgcn_attention_bwd_bf16": ([_P] * 9 + [_I] * 4 + [_P, _P], _I),
    "mrgcn_attention_bwd_scratch_floats": ([_I, _I, _I], _LL),
    "mrgcn_attention_error_string": ([_I], ctypes.c_char_p),
}


_HEADS_SIGNATURES = {
    "mrgcn_attention_heads_fwd_bf16": ([_P] * 5 + [_I] * 4 + [_P]
                                       + [_I] * 3 + [_P], _I),
    "mrgcn_attention_heads_bwd_bf16": ([_P] * 9 + [_I] * 4 + [_P]
                                       + [_I] * 3 + [_P], _I),
    "mrgcn_attention_heads_bwd_scratch_floats": ([_I, _I, _I], _LL),
    "mrgcn_attention_heads_error_string": ([_I], ctypes.c_char_p),
}


def _library():
    return _build.bind("fused_attention", _SIGNATURES)


def _heads_library():
    return _build.bind("fused_attention_heads", _HEADS_SIGNATURES)


# --------------------------------------------------------------------------
# the multi-head kernels' launch plan
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class HeadPlan:
    """How the multi-head kernels group ``H`` heads of width ``d``: each
    head in a shared-memory slab of ``dpad`` columns in a ``swizzle``-byte
    swizzle, ``fwd_heads`` heads a forward block, ``bwd_heads`` a backward
    block (the last group of each may hold fewer)."""

    dpad: int
    swizzle: int
    fwd_heads: int
    bwd_heads: int

    def groups(self, H: int, backward: bool = False) -> list:
        """The heads of each group, in order."""
        g = self.bwd_heads if backward else self.fwd_heads
        return [list(range(h, min(h + g, H))) for h in range(0, H, g)]


def _check_shape(L: int, d: int) -> None:
    """The kernels' limits, raised on with a message (the C entry points
    refuse the same shapes)."""
    if not 0 < L <= MAX_LEN:
        raise NotImplementedError(
            f"fused_attention: the kernels take 1 <= L <= {MAX_LEN} (the "
            f"text encoder's tokenizer limit), got {L}")
    if d % 8 or not 0 < d <= MAX_DIM:
        raise ValueError(f"fused_attention: the kernel takes a head width "
                         f"that is a multiple of 8 up to {MAX_DIM}, got {d}")


def head_plan(H: int, d: int, L: int) -> HeadPlan:
    """The multi-head kernels' plan for ``H >= 2`` heads of width ``d`` over
    ``L`` tokens: ``dpad`` the next power of two >= max(d, 16), the swizzle
    one slab row; a forward tile holds 64 columns below ``dpad = 64``, else
    ``MAX_DIM``; a backward block two heads up to ``dpad = 32``, else one
    (the widths the card ran fastest at with no spilled register:
    ``csrc/fused_attention_heads.cu``)."""
    if H < 2:
        raise ValueError(f"head_plan: the multi-head kernels take H >= 2, "
                         f"got {H}")
    _check_shape(L, d)
    dpad = 16
    while dpad < d:
        dpad *= 2
    fwd = (64 if dpad <= 32 else MAX_DIM) // dpad
    bwd = 2 if dpad <= 32 else 1
    return HeadPlan(dpad=dpad, swizzle=min(128, 2 * dpad),
                    fwd_heads=min(H, fwd), bwd_heads=min(H, bwd))


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def heads_first(t: torch.Tensor) -> torch.Tensor:
    """``(N, L, d)`` -> ``(N, 1, L, d)``; ``(N, L, H, d)`` ->
    ``(N, H, L, d)`` (a view)."""
    return t.unsqueeze(1) if t.dim() == 3 else t.transpose(1, 2)


def heads_last(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`heads_first` for a tensor shaped as ``like``
    was."""
    return t.squeeze(1) if like.dim() == 3 else t.transpose(1, 2)


def key_mask(keys_valid: torch.Tensor) -> torch.Tensor:
    """``(N, L)`` -> ``(N, 1, 1, L)``, against ``(N, H, L, L)`` scores."""
    return keys_valid[:, None, None, :]


def _probabilities(q, k, keys_valid):
    """f32 softmax of the masked scores ``(N, H, L, L)`` of heads-first
    ``q``, ``k``, ``exp(s - max) / sum`` as ``jax.nn.softmax`` computes
    it."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = torch.where(key_mask(keys_valid), s, torch.full_like(s, MASKED))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def attention_fwd_reference(q, k, v, keys_valid):
    """Plain PyTorch version of the forward kernel (``q`` already scaled;
    ``(N, L, d)`` or ``(N, L, H, d)``)."""
    qh, kh, vh = map(heads_first, (q, k, v))
    p = _probabilities(qh, kh, keys_valid).to(q.dtype)
    return heads_last(torch.matmul(p.float(), vh.float()), q).to(q.dtype)


def attention_bwd_reference(q, k, v, keys_valid, d_out):
    """Plain PyTorch version of the backward kernel: ``(dq, dk, dv)``."""
    qh, kh, vh = map(heads_first, (q, k, v))
    p = _probabilities(qh, kh, keys_valid)
    do = heads_first(d_out.to(q.dtype)).float()
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, vh.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = torch.where(key_mask(keys_valid), ds, torch.zeros_like(ds))
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kh.float())
    dk = torch.matmul(ds.transpose(-1, -2), qh.float())
    return (heads_last(dq, q).to(q.dtype), heads_last(dk, q).to(k.dtype),
            heads_last(dv, q).to(v.dtype))


# --------------------------------------------------------------------------
# the key tiles the kernels walk
# --------------------------------------------------------------------------

def live_key_tiles(keys_valid: torch.Tensor) -> torch.Tensor:
    """``(N, ceil(L / KEY_TILE))`` bool: the key tiles the kernels load,
    score and multiply. A tile is walked if one of its keys is valid; a
    sequence with no valid key at all walks every tile (its softmax is
    uniform over all ``L`` keys). Every other tile's probabilities are
    exactly 0 in f32, so dropping it changes nothing; its ``dk`` / ``dv``
    rows are zeros. The kernels find the tiles themselves; this is the
    rule they follow."""
    N, L = keys_valid.shape
    tiles = -(-L // KEY_TILE)
    padded = torch.zeros((N, tiles * KEY_TILE), dtype=torch.bool,
                         device=keys_valid.device)
    padded[:, :L] = keys_valid
    has_key = padded.view(N, tiles, KEY_TILE).any(dim=-1)
    return has_key | ~has_key.any(dim=-1, keepdim=True)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _strides(t: torch.Tensor, name: str):
    """(stride over N, over L, over H) in elements of a ``(N, L, H, d)``
    view; the kernel reads 16-byte vectors along d."""
    if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"fused_attention: {name} needs a contiguous last "
                         "dim, strides that are multiples of 8 and a "
                         "16-byte aligned start")
    # a single head's stride is never stepped; the tensor map takes d
    sh = t.stride(2) if t.shape[2] > 1 else t.shape[3]
    return t.stride(0), t.stride(1), sh


def _as_heads(t: torch.Tensor) -> torch.Tensor:
    return t.unsqueeze(2) if t.dim() == 3 else t


def _check_cuda_args(q, k, v, keys_valid):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"fused_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_attention: the kernel takes bf16, "
                            f"{name} is {t.dtype}")
        if t.dim() not in (3, 4) or t.shape != q.shape:
            raise ValueError(f"fused_attention: {name} must be (N, L, d) or "
                             f"(N, L, H, d) like q {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    N, L, d = q.shape[0], q.shape[1], q.shape[-1]
    if keys_valid.shape != (N, L) or keys_valid.dtype != torch.bool \
            or keys_valid.device != q.device \
            or not keys_valid.is_contiguous():
        raise ValueError("fused_attention: keys_valid must be a contiguous "
                         f"(N, L) bool tensor on {q.device}")
    _check_shape(L, d)
    if q.dim() == 4 and q.shape[2] < 1:
        raise ValueError("fused_attention: no heads")


def _raise_on(rc: int, error_string, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed: "
                           + error_string(rc).decode())


def _stride_array(q, k, v):
    strides = [st for name, t in (("q", q), ("k", k), ("v", v))
               for st in _strides(_as_heads(t), name)]
    return (ctypes.c_longlong * 9)(*strides)


def _count(fn, heads: int) -> None:
    if heads > 1:
        fn.launches_heads += 1
    else:
        fn.launches += 1


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  keys_valid: torch.Tensor) -> torch.Tensor:
    """Forward core on ``(N, L, d)`` or ``(N, L, H, d)`` inputs (``q``
    already scaled), ``keys_valid`` (N, L) bool. CPU: the plain version;
    CUDA: the kernel (bf16; any of them may be a strided view) or
    raise."""
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, keys_valid)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    _check_cuda_args(q, k, v, keys_valid)
    N, L, H, d = _as_heads(q).shape
    plan = head_plan(H, d, L) if H > 1 else None
    lib = _heads_library() if plan else _library()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if N == 0:
        return out
    strides = _stride_array(q, k, v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), keys_valid.data_ptr(),
            out.data_ptr(), N, L, H, d, strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan:
            rc = lib.mrgcn_attention_heads_fwd_bf16(
                *args, plan.dpad, plan.fwd_heads, plan.swizzle, stream)
            error_string = lib.mrgcn_attention_heads_error_string
        else:
            rc = lib.mrgcn_attention_fwd_bf16(*args, stream)
            error_string = lib.mrgcn_attention_error_string
    _raise_on(rc, error_string, "attention_fwd")
    _count(attention_fwd, H)
    return out


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  keys_valid: torch.Tensor, d_out: torch.Tensor):
    """Backward core: ``(dq, dk, dv)``, shaped as ``q``, for the cotangent
    ``d_out`` (dq is with respect to the scaled ``q``). CPU: the plain
    version; CUDA: the kernel or raise."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, keys_valid, d_out)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    _check_cuda_args(q, k, v, keys_valid)
    N, L, H, d = _as_heads(q).shape
    plan = head_plan(H, d, L) if H > 1 else None
    lib = _heads_library() if plan else _library()
    do = d_out.to(q.dtype).contiguous()
    if do.shape != q.shape or do.data_ptr() % 16:
        raise ValueError("fused_attention: d_out must be shaped as q")
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if N == 0:
        return dq, dk, dv
    # each row's softmax statistics, from the dq kernel to the dk / dv one
    scratch = (lib.mrgcn_attention_heads_bwd_scratch_floats if plan
               else lib.mrgcn_attention_bwd_scratch_floats)
    stats = torch.empty(scratch(N, L, H), dtype=torch.float32,
                        device=q.device)
    strides = _stride_array(q, k, v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), keys_valid.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), N, L, H, d, strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan:
            rc = lib.mrgcn_attention_heads_bwd_bf16(
                *args, plan.dpad, plan.bwd_heads, plan.swizzle, stream)
            error_string = lib.mrgcn_attention_heads_error_string
        else:
            rc = lib.mrgcn_attention_bwd_bf16(*args, stream)
            error_string = lib.mrgcn_attention_error_string
    _raise_on(rc, error_string, "attention_bwd")
    _count(attention_bwd, H)
    return dq, dk, dv


attention_fwd.launches = attention_fwd.launches_heads = 0
attention_bwd.launches = attention_bwd.launches_heads = 0


class _AttentionCore(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, keys_valid):
        ctx.save_for_backward(q, k, v, keys_valid)
        return attention_fwd(q, k, v, keys_valid)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, keys_valid = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, keys_valid, d_out)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    keys_valid: torch.Tensor) -> torch.Tensor:
    """Attention with a key-only mask. ``q``/``k``/``v``: ``(N, L, d)``
    (one head) or ``(N, L, H, d)`` (H heads of width d); ``keys_valid``:
    ``(N, L)`` bool. The true ``1/sqrt(d)`` is folded into ``q`` in its own
    type before the core, as ``mrgcn_tpu.ops.attention.fused_attention``
    and flax's ``dot_product_attention`` do."""
    d = q.shape[-1]
    q = q * torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype)
    return _AttentionCore.apply(q, k, v, keys_valid.contiguous())
