"""The element-wise bound that holds the bf16 encoder kernels to their plain
versions (``mrgcn_tpu_torch.ops.kernel_bounds``), checked on the CPU.

A sound stand-in for a kernel is the plain version computed in another
summation order: the keys (or rows) and the summed width permuted, the
results permuted back. It must stay within the bound (error / bound <= 1).
A kernel fault, a dropped tile of 16 keys or 16 rows, must not.
"""

import numpy as np
import pytest
import torch

from mrgcn_tpu_torch.ops import attention as att
from mrgcn_tpu_torch.ops import fused_mlp as fm
from mrgcn_tpu_torch.ops.kernel_bounds import (attention_scales, bf16_error,
                                               mlp_scales)


def attention_inputs(N, L, d, seed):
    """Scaled q, k, v and a cotangent in bf16; ragged key masks with one
    sequence of length 1 and one that is all padding."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(N, L, d, generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    q = q * torch.tensor(d ** -0.5, dtype=torch.bfloat16)
    lengths = torch.randint(1, L + 1, (N,), generator=gen)
    lengths[0], lengths[1] = 1, 0
    valid = torch.arange(L)[None, :] < lengths[:, None]
    return q, k, v, valid, do


def permuted_attention(q, k, v, valid, do, seed):
    """The plain forward and backward with keys and the head width in
    another order, mapped back."""
    rng = np.random.default_rng(seed)
    kp = torch.from_numpy(rng.permutation(q.shape[1]))
    cp = torch.from_numpy(rng.permutation(q.shape[2]))
    inv_k, inv_c = torch.argsort(kp), torch.argsort(cp)
    qc, kc, vc, dc = (t[..., cp] for t in (q, k, v, do))
    kc, vc, vm = kc[:, kp], vc[:, kp], valid[:, kp]
    out = att.attention_fwd_reference(qc, kc, vc, vm)[..., inv_c]
    dq, dk, dv = att.attention_bwd_reference(qc, kc, vc, vm, dc)
    return (out, dq[..., inv_c], dk[:, inv_k][..., inv_c],
            dv[:, inv_k][..., inv_c])


@pytest.mark.parametrize("N,L,d", [(13, 37, 128), (6, 128, 64)])
def test_attention_bound_accepts_another_summation_order(N, L, d):
    q, k, v, valid, do = attention_inputs(N, L, d, seed=N + L)
    want = (att.attention_fwd_reference(q, k, v, valid),
            *att.attention_bwd_reference(q, k, v, valid, do))
    got = permuted_attention(q, k, v, valid, do, seed=1)
    flips = 0
    for name, g, w, s in zip(("out", "dq", "dk", "dv"), got, want,
                             attention_scales(q, k, v, valid, do)):
        err, ratio = bf16_error(g, w, s)
        assert ratio <= 1.0, f"{name}: error {err}, {ratio} x the bound"
        flips += int((g != w).sum())
    assert flips > 0    # the orders do differ somewhere


def test_attention_bound_rejects_a_dropped_key_tile():
    q, k, v, valid, do = attention_inputs(16, 128, 128, seed=0)
    valid[2:] = True          # full-length sequences: every tile matters
    dq, dk, dv = att.attention_bwd_reference(q, k, v, valid, do)
    _, s_dq, s_dk, s_dv = attention_scales(q, k, v, valid, do)
    for name, g, s in (("dk", dk, s_dk), ("dv", dv, s_dv)):
        faulty = g.clone()
        faulty[:, 64:80] = 0
        assert bf16_error(faulty, g, s)[1] > 1.0, name
    assert bf16_error(dq, dq, s_dq) == (0.0, 0.0)


def mlp_inputs(M, d, hd, seed):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(torch.bfloat16)

    return (rnd(M, d), rnd(d, hd, scale=d ** -0.5), rnd(hd, scale=0.5),
            rnd(hd, d, scale=hd ** -0.5), rnd(d, scale=0.5), rnd(M, d))


def test_mlp_bound_accepts_another_summation_order():
    x, w1, b1, w2, b2, do = mlp_inputs(300, 64, 256, seed=0)
    want = (fm.mlp_fwd_reference(x, w1, b1, w2, b2),
            *fm.mlp_bwd_reference(x, w1, b1, w2, do))
    rng = np.random.default_rng(1)
    rp = torch.from_numpy(rng.permutation(x.shape[0]))
    hp = torch.from_numpy(rng.permutation(w1.shape[1]))
    inv_r, inv_h = torch.argsort(rp), torch.argsort(hp)
    xp, dop, w1p, b1p, w2p = x[rp], do[rp], w1[:, hp], b1[hp], w2[hp]
    out = fm.mlp_fwd_reference(xp, w1p, b1p, w2p, b2)[inv_r]
    dx, dw1, db1, dw2, db2 = fm.mlp_bwd_reference(xp, w1p, b1p, w2p, dop)
    got = (out, dx[inv_r], dw1[:, inv_h], db1[inv_h], dw2[inv_h], db2)
    for name, g, w, s in zip(("out", "dx", "dw1", "db1", "dw2", "db2"),
                             got, want, mlp_scales(x, w1, b1, w2, b2, do)):
        err, ratio = bf16_error(g, w, s)
        assert ratio <= 1.0, f"{name}: error {err}, {ratio} x the bound"


def test_mlp_bound_rejects_a_dropped_row_tile():
    x, w1, b1, w2, b2, do = mlp_inputs(300, 64, 256, seed=0)
    _, s_dx, s_dw1, _, s_dw2, _ = mlp_scales(x, w1, b1, w2, b2, do)
    dx, dw1, _, dw2, _ = fm.mlp_bwd_reference(x, w1, b1, w2, do)
    _, dw1_f, _, dw2_f, _ = fm.mlp_bwd_reference(x[16:], w1, b1, w2,
                                                 do[16:])
    assert bf16_error(dw1_f, dw1, s_dw1)[1] > 1.0
    assert bf16_error(dw2_f, dw2, s_dw2)[1] > 1.0
    with pytest.raises(ValueError, match="shape"):
        bf16_error(dx[1:], dx, s_dx)
