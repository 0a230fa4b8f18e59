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
backward call runs the dx pass, the per-segment weight partials and their
fixed-order sum).
"""

from __future__ import annotations

import ctypes
import math

import torch

from mrgcn_tpu_torch.ops import _build

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
# weight-gradient row segments: enough CTAs (hd/64 x segments) to fill
# the card, few enough that the f32 partials stay small
MAX_SEGMENTS = 32

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "mrgcn_mlp_fwd_bf16": ([_P] * 6 + [_LL, _I, _I, _P], _I),
    "mrgcn_mlp_bwd_bf16": ([_P] * 9 + [_LL, _I, _I, _I, _LL, _P], _I),
    "mrgcn_mlp_max_dim": ([], _I),
    "mrgcn_mlp_hidden_chunk": ([], _I),
    "mrgcn_mlp_segment_rows": ([], _I),
    "mrgcn_mlp_error_string": ([_I], ctypes.c_char_p),
}


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

def _check_cuda_args(tensors, lib):
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
    chunk = lib.mrgcn_mlp_hidden_chunk()
    if d % 16 or not 0 < d <= lib.mrgcn_mlp_max_dim():
        raise ValueError(f"fused_mlp: the kernel takes d a multiple of 16 "
                         f"up to {lib.mrgcn_mlp_max_dim()}, got {d}")
    if hd % chunk or hd == 0:
        raise ValueError(f"fused_mlp: the kernel takes a hidden width that "
                         f"is a multiple of {chunk}, got {hd}")
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


def _contiguous(tensors: dict) -> dict:
    return {k: t.contiguous() for k, t in tensors.items()}


def mlp_fwd(x, w1, b1, w2, b2) -> torch.Tensor:
    """Forward on ``(M, d)`` rows. CPU: the plain version; CUDA: the
    kernel (bf16) or raise."""
    if x.device.type == "cpu":
        return mlp_fwd_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for device {x.device}")
    lib = _library()
    t = _contiguous({"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2})
    _check_cuda_args(t, lib)
    M, d = x.shape
    hd = w1.shape[1]
    out = torch.empty((M, d), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    w1t = t["w1"].t().contiguous()
    w2t = t["w2"].t().contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mrgcn_mlp_fwd_bf16(
            t["x"].data_ptr(), w1t.data_ptr(), t["b1"].data_ptr(),
            w2t.data_ptr(), t["b2"].data_ptr(), out.data_ptr(), M, d, hd,
            stream)
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
    lib = _library()
    t = _contiguous({"x": x, "w1": w1, "b1": b1, "w2": w2,
                     "d_out": d_out.to(x.dtype)})
    _check_cuda_args(t, lib)
    M, d = x.shape
    hd = w1.shape[1]
    dx = torch.empty((M, d), dtype=x.dtype, device=x.device)
    n = 2 * d * hd + hd + d
    grads = torch.zeros(n, dtype=torch.float32, device=x.device)
    if M > 0:
        seg_rows_unit = lib.mrgcn_mlp_segment_rows()
        blocks = -(-M // seg_rows_unit)
        segments = min(MAX_SEGMENTS, blocks)
        seg_rows = -(-blocks // segments) * seg_rows_unit
        segments = -(-M // seg_rows)
        part = torch.empty(segments * n, dtype=torch.float32,
                           device=x.device)
        w1t = t["w1"].t().contiguous()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.mrgcn_mlp_bwd_bf16(
                t["x"].data_ptr(), t["w1"].data_ptr(), w1t.data_ptr(),
                t["b1"].data_ptr(), t["w2"].data_ptr(),
                t["d_out"].data_ptr(), dx.data_ptr(), part.data_ptr(),
                grads.data_ptr(), M, d, hd, segments, seg_rows, stream)
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
