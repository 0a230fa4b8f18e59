"""How far a bf16 kernel may stand from its plain version, element by
element.

The attention and MLP kernels and their plain versions take the same bf16
inputs, sum in f32 in different orders and round the same intermediates
to bf16 (the probabilities and ``ds``, the hidden activations and
``dh_pre``, the outputs). Two f32 sums of one value differ by far less
than a bf16 step, but where they straddle a rounding boundary the bf16
intermediate lands one step (at most ``2^-7`` of its size) apart. An
output element that sums such terms can then move by ``2^-7`` times the
sum of its terms' sizes, and its own rounding by ``2^-7`` of itself. So
each element is held to

    |got - want| <= RTOL * (|want| + scale) + ATOL

where ``scale`` is the product that forms the element taken over
absolute values (``p |v|`` for the attention output, ``|x|^T |dh|`` for
``dW1``, ...), ``RTOL = 2^-6`` (twice the worst case above) and ``ATOL``
absorbs f32 noise where every term is zero. A bound on the whole tensor
would let the largest element set it: one short sequence's ``dv`` is
a sum of up to L cotangent rows while a long one's is a hundred times
smaller, so a kernel that dropped a tile of keys could hide under it.
"""

from __future__ import annotations

import torch

from mrgcn_tpu_torch.ops.attention import _probabilities
from mrgcn_tpu_torch.ops.fused_mlp import _gelu_tanh_grad, gelu_tanh

RTOL = 2.0 ** -6
ATOL = 1e-6


def attention_scales(q, k, v, keys_valid, d_out):
    """Scales of ``(out, dq, dk, dv)`` of the attention core (``q``
    already scaled), as :func:`attention_bwd_reference` forms them."""
    p = _probabilities(q, k, keys_valid)
    do = d_out.to(q.dtype).float()
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = torch.where(keys_valid[:, None, :], ds, torch.zeros_like(ds)).abs()
    p_t = p.transpose(-1, -2)
    return (torch.matmul(p, v.float().abs()),
            torch.matmul(ds, k.float().abs()),
            torch.matmul(ds.transpose(-1, -2), q.float().abs()),
            torch.matmul(p_t, do.abs()))


def mlp_scales(x, w1, b1, w2, b2, d_out):
    """Scales of ``(out, dx, dw1, db1, dw2, db2)`` of the fused MLP, as
    :func:`mlp_fwd_reference` and :func:`mlp_bwd_reference` form them."""
    h_pre = torch.matmul(x.float(), w1.float()) + b1.float()
    hb = gelu_tanh(h_pre).to(x.dtype).float().abs()
    do = d_out.to(x.dtype).float()
    dh_pre = _gelu_tanh_grad(h_pre) * torch.matmul(do, w2.float().t())
    dhb = dh_pre.to(x.dtype).float().abs()
    return (torch.matmul(hb, w2.float().abs()) + b2.float().abs(),
            torch.matmul(dhb, w1.float().abs().t()),
            torch.matmul(x.float().abs().t(), dhb),
            dh_pre.abs().sum(dim=0),
            torch.matmul(hb.t(), do.abs()),
            do.abs().sum(dim=0))


def bf16_error(got, want, scale):
    """``(max abs error, max of error / bound)``: the kernel agrees with
    its plain version where the second number is at most 1."""
    if got.shape != want.shape:
        raise ValueError(f"shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0, 0.0
    err = (got.float() - want.float()).abs()
    bound = RTOL * (want.float().abs() + scale.float()) + ATOL
    return float(err.max()), float((err / bound).max())
