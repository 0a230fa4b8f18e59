"""Fused transformer MLP: the CUDA kernels and their plain version.

Counterpart of :mod:`mrgcn_tpu.ops.fused_mlp` (``fused_mlp``):
``gelu_tanh(x W1 + b1) W2 + b2`` over flattened rows, with the kernel's
arithmetic: f32 sums, the bias added to the f32 sum, the hidden
activations cast to the input type before the second product, and a
backward that recomputes them (``csrc/fused_mlp.cu``):

    dW2 = hb^T do, db2 = sum do, dh = do W2^T, dh_pre = gelu'(h_pre) dh,
    dx = bf16(dh_pre) W1^T, dW1 = x^T bf16(dh_pre), db1 = sum dh_pre

with the weight gradients summed in f32 and returned in the weights' type,
as the JAX wrapper returns them.

CPU tensors take the plain version (:func:`mlp_fwd_reference`,
:func:`mlp_bwd_reference`); CUDA tensors launch the kernels or raise.
``mlp_fwd.launches`` and ``mlp_bwd.launches`` count the launches (one
backward call runs the dx kernel, the per-segment weight partials and
their fixed-order sum). :func:`mlp_plan` is the launch geometry the
wrappers hand the kernels.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from mrgcn_tpu_torch.ops import _build

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)

# The kernels' geometry (csrc/fused_mlp.cu; checked against the library
# before the first launch): the largest d, the hidden columns of a chunk,
# the rows of a forward and of a dx block step, of a weight-gradient step.
MAX_D = 128
HIDDEN_CHUNK = 64
FWD_ROW_TILE = 192
BWD_ROW_TILE = 128
SEGMENT_ROWS = 64
# weight-gradient blocks: one an SM, all in one wave; at most this many
# (hidden chunks x row segments), so that the f32 partials (one
# weight-sized set a segment) stay small: 16 segments at hd = 512
MAX_DW_BLOCKS = 256

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "mrgcn_mlp_fwd_bf16": ([_P] * 6 + [_LL, _I, _I, _I, _P], _I),
    "mrgcn_mlp_bwd_bf16": ([_P] * 8 + [_LL, _I, _I, _I, _I, _LL, _P], _I),
    "mrgcn_mlp_geometry": ([_P], None),
    "mrgcn_mlp_error_string": ([_I], ctypes.c_char_p),
}


@dataclass(frozen=True)
class MLPPlan:
    """How the kernels cover ``M`` rows of width ``d`` with ``hd`` hidden
    columns on a card of ``sms`` SMs."""

    fwd_tiles: int     # 192-row tiles of the forward kernel
    fwd_blocks: int    # its persistent blocks (b walks b, b + fwd_blocks..)
    bwd_tiles: int     # 128-row tiles of the dx kernel
    bwd_blocks: int    # its persistent blocks
    chunks: int        # 64-column hidden chunks: the dW grid's x
    segments: int      # row segments: its y, one f32 partial each
    seg_rows: int      # rows a segment (a multiple of 64; last cut at M)
    grad_floats: int   # [dW1 | dW2 | db1 | db2]: 2 d hd + hd + d
    part_floats: int   # the partials' workspace: segments x grad_floats


def mlp_plan(M: int, d: int, hd: int, sms: int) -> MLPPlan:
    """The launch geometry for ``M >= 1`` rows on a card of ``sms`` SMs
    (the wrappers compute it and the C side checks the segments)."""
    if M < 1 or sms < 1:
        raise ValueError(f"mlp_plan: needs M >= 1 and sms >= 1, got {M}, "
                         f"{sms}")
    fwd_tiles = -(-M // FWD_ROW_TILE)
    bwd_tiles = -(-M // BWD_ROW_TILE)
    chunks = hd // HIDDEN_CHUNK
    steps = -(-M // SEGMENT_ROWS)
    # one wave of weight-gradient blocks: a block never waits for an SM
    segments = max(1, min(steps, sms // chunks, MAX_DW_BLOCKS // chunks))
    seg_rows = -(-steps // segments) * SEGMENT_ROWS
    segments = -(-M // seg_rows)
    grad_floats = 2 * d * hd + hd + d
    return MLPPlan(fwd_tiles, min(fwd_tiles, sms), bwd_tiles,
                   min(bwd_tiles, sms), chunks, segments, seg_rows,
                   grad_floats, segments * grad_floats)


def _library():
    return _build.bind("fused_mlp", _SIGNATURES)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, written as JAX writes it."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (x + 0.044715 * (x * x * x))))
    return x * cdf


def _gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    th = torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x)))
    return 0.5 * (1.0 + th) + x * 0.5 * (1.0 - th * th) * _SQRT_2_OVER_PI \
        * (1.0 + 3.0 * 0.044715 * x * x)


def _hidden_pre(x, w1, b1):
    return torch.matmul(x.float(), w1.float()) + b1.float()


def mlp_fwd_reference(x, w1, b1, w2, b2):
    """Plain PyTorch version of the forward kernel on (M, d) rows."""
    h = gelu_tanh(_hidden_pre(x, w1, b1)).to(x.dtype)
    return (torch.matmul(h.float(), w2.float()) + b2.float()).to(x.dtype)


def mlp_bwd_reference(x, w1, b1, w2, d_out):
    """Plain PyTorch version of the backward kernel:
    ``(dx, dw1, db1, dw2, db2)``, weight gradients in f32."""
    h_pre = _hidden_pre(x, w1, b1)
    hb = gelu_tanh(h_pre).to(x.dtype).float()
    do = d_out.to(x.dtype).float()
    dw2 = torch.matmul(hb.t(), do)
    db2 = do.sum(dim=0)
    dh = torch.matmul(do, w2.float().t())
    dh_pre = _gelu_tanh_grad(h_pre) * dh
    dh_b = dh_pre.to(x.dtype).float()
    dx = torch.matmul(dh_b, w1.float().t()).to(x.dtype)
    dw1 = torch.matmul(x.float().t(), dh_b)
    db1 = dh_pre.sum(dim=0)
    return dx, dw1, db1, dw2, db2


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_geometry_checked = False


def _checked_library():
    """The library, its geometry held to this module's constants once."""
    global _geometry_checked
    lib = _library()
    if not _geometry_checked:
        got = (ctypes.c_int * 5)()
        lib.mrgcn_mlp_geometry(got)
        want = (MAX_D, HIDDEN_CHUNK, FWD_ROW_TILE, BWD_ROW_TILE,
                SEGMENT_ROWS)
        if tuple(got) != want:
            raise RuntimeError(f"fused_mlp: the library's geometry "
                               f"{tuple(got)} is not the wrapper's {want}")
        _geometry_checked = True
    return lib


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def _check_cuda_args(tensors):
    x = tensors["x"]
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"fused_mlp: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_mlp: the kernel takes bf16, {name} is "
                            f"{t.dtype}")
    M, d = x.shape
    hd = tensors["w1"].shape[1]
    if d % 16 or not 0 < d <= MAX_D:
        raise ValueError(f"fused_mlp: the kernel takes d a multiple of 16 "
                         f"up to {MAX_D}, got {d}")
    if hd % HIDDEN_CHUNK or hd == 0:
        raise ValueError(f"fused_mlp: the kernel takes a hidden width that "
                         f"is a multiple of {HIDDEN_CHUNK}, got {hd}")
    if M >= 2 ** 31 - FWD_ROW_TILE:
        raise ValueError(f"fused_mlp: the kernel takes fewer than 2^31 - "
                         f"{FWD_ROW_TILE} rows, got {M}")
    want = {"w1": (d, hd), "b1": (hd,), "w2": (hd, d), "b2": (d,),
            "d_out": (M, d)}
    for name, shape in want.items():
        if name in tensors and tuple(tensors[name].shape) != shape:
            raise ValueError(f"fused_mlp: {name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed: "
                           + lib.mrgcn_mlp_error_string(rc).decode())


def _operands(tensors: dict) -> dict:
    """Contiguous, with a 16-byte aligned start (what the tensor maps
    take): a view that starts elsewhere is copied."""
    out = {}
    for k, t in tensors.items():
        t = t.contiguous()
        out[k] = t if t.data_ptr() % 16 == 0 else t.clone()
    return out


def mlp_fwd(x, w1, b1, w2, b2) -> torch.Tensor:
    """Forward on ``(M, d)`` rows. CPU: the plain version; CUDA: the
    kernel (bf16) or raise."""
    if x.device.type == "cpu":
        return mlp_fwd_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for device {x.device}")
    lib = _checked_library()
    t = _operands({"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2})
    _check_cuda_args(t)
    M, d = x.shape
    hd = w1.shape[1]
    out = torch.empty((M, d), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    plan = mlp_plan(M, d, hd, _sm_count(x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mrgcn_mlp_fwd_bf16(
            t["x"].data_ptr(), t["w1"].data_ptr(), t["b1"].data_ptr(),
            t["w2"].data_ptr(), t["b2"].data_ptr(), out.data_ptr(), M, d, hd,
            plan.fwd_blocks, stream)
    _raise_on(rc, lib, "mlp_fwd")
    mlp_fwd.launches += 1
    return out


def mlp_bwd(x, w1, b1, w2, d_out):
    """Backward: ``(dx, dw1, db1, dw2, db2)``, weight gradients in f32.
    CPU: the plain version; CUDA: the kernels or raise."""
    if x.device.type == "cpu":
        return mlp_bwd_reference(x, w1, b1, w2, d_out)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for device {x.device}")
    lib = _checked_library()
    t = _operands({"x": x, "w1": w1, "b1": b1, "w2": w2,
                   "d_out": d_out.to(x.dtype)})
    _check_cuda_args(t)
    M, d = x.shape
    hd = w1.shape[1]
    dx = torch.empty((M, d), dtype=x.dtype, device=x.device)
    n = 2 * d * hd + hd + d
    grads = torch.zeros(n, dtype=torch.float32, device=x.device)
    if M > 0:
        plan = mlp_plan(M, d, hd, _sm_count(x.device))
        part = torch.empty(plan.part_floats, dtype=torch.float32,
                           device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.mrgcn_mlp_bwd_bf16(
                t["x"].data_ptr(), t["w1"].data_ptr(), t["b1"].data_ptr(),
                t["w2"].data_ptr(), t["d_out"].data_ptr(), dx.data_ptr(),
                part.data_ptr(), grads.data_ptr(), M, d, hd,
                plan.bwd_blocks, plan.segments, plan.seg_rows, stream)
        _raise_on(rc, lib, "mlp_bwd")
        mlp_bwd.launches += 1
    dw1 = grads[:d * hd].view(d, hd)
    dw2 = grads[d * hd:2 * d * hd].view(hd, d)
    db1 = grads[2 * d * hd:2 * d * hd + hd]
    db2 = grads[2 * d * hd + hd:]
    return dx, dw1, db1, dw2, db2


mlp_fwd.launches = 0
mlp_bwd.launches = 0


class _FusedMLP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.b2_dtype = b2.dtype
        return mlp_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, d_out):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = mlp_bwd(x, w1, b1, w2, d_out)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype))


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(x @ w1 + b1) @ w2 + b2`` over the rows of ``x``
    (``(..., d)``, leading dims flattened), one fused kernel each way on
    the card."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    out = _FusedMLP.apply(x.reshape(-1, d), w1, b1.reshape(-1), w2,
                          b2.reshape(-1))
    return out.reshape(*lead, d)
