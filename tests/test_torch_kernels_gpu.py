"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests import no JAX, so they also run on a machine with a card and
without JAX (the repository's conftest imports JAX, hence
``--noconftest``)::

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Elsewhere they skip. Tolerances: ``sorted_scatter`` atol 1e-4 / rtol
1e-5 (the kernel and ``index_add_`` sum the same f32 values in different
orders). The bf16 encoder kernels (fused attention, fused MLP) against
their plain versions: element by element, ``|got - want| <= 2^-6 (|want|
+ scale) + 1e-6``, where ``scale`` is the element's product taken over
absolute values (``mrgcn_tpu_torch.ops.kernel_bounds``). Both sides sum
in f32 in different orders, so an intermediate that is rounded to bf16
(the probabilities, the hidden activations, the outputs) can land one
bf16 step (at most 2^-7 of its size) apart.
"""

import numpy as np
import pytest
import torch


def make_stream(seed, nslab=7, rb=16, eb=8, n_blocks=6, L=128):
    """A sorted stream: non-decreasing block ids drawn from the even blocks
    (so the odd ones are never visited), ~20% padding, and slabs that
    repeat a row."""
    rng = np.random.default_rng(seed)
    blk = np.sort(rng.choice(np.arange(0, n_blocks, 2), nslab))
    local = rng.integers(0, rb, (nslab, eb))
    local[rng.random((nslab, eb)) < 0.2] = rb
    local[:, :3] = local[:, :1]
    msgs = rng.standard_normal((nslab * eb, L)).astype(np.float32)
    return msgs, local.astype(np.int32), blk.astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rb,eb,L", [(16, 8, 128), (512, 256, 128),
                                     (64, 40, 96)])
def test_sorted_scatter_kernel_matches_plain(cuda, rb, eb, L):
    from mrgcn_tpu_torch.ops.sorted_stream import (sorted_scatter,
                                                   sorted_scatter_reference)
    msgs, local, blk = make_stream(rb + eb, 9, rb, eb, 10, L)
    m, lo, bl = (torch.from_numpy(x).to(cuda) for x in (msgs, local, blk))
    out_rows = 10 * rb - 3
    before = sorted_scatter.launches
    got = sorted_scatter(m, lo, bl, out_rows, rb, eb)
    again = sorted_scatter(m, lo, bl, out_rows, rb, eb)
    want = sorted_scatter_reference(m, lo, bl, out_rows, rb, eb)
    torch.cuda.synchronize()
    assert sorted_scatter.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_sorted_scatter_kernel_rejects_bad_arguments(cuda):
    from mrgcn_tpu_torch.ops.sorted_stream import sorted_scatter
    msgs, local, blk = make_stream(1)
    m, lo, bl = (torch.from_numpy(x).to(cuda) for x in (msgs, local, blk))
    with pytest.raises(TypeError, match="local must be torch.int32"):
        sorted_scatter(m, lo.long(), bl, 96, 16, 8)
    with pytest.raises(ValueError, match="multiple of 32"):
        sorted_scatter(m[:, :100].contiguous(), lo, bl, 96, 16, 8)
    with pytest.raises(ValueError, match="contiguous"):
        sorted_scatter(m[:, ::2], lo, bl, 96, 16, 8)
    with pytest.raises(ValueError, match="shapes disagree"):
        sorted_scatter(m, lo, bl, 96, 16, 4)


@pytest.mark.gpu
def test_featureless_aggregate_on_card_matches_cpu(cuda):
    from mrgcn_tpu_torch.ops import relational as rl
    rng = np.random.default_rng(0)
    n, R, E, d = 300, 5, 2000, 16
    src = rng.integers(0, n, E)
    dst = rng.integers(0, n, E)
    rel = rng.integers(0, R, E)
    norm = rng.random(E).astype(np.float32)
    plans = rl.build_layer_plans(src, dst, rel, norm, n, 8, 8,
                                 row_block=64, edge_block=32,
                                 kind="identity")
    table = rng.standard_normal((R * plans.n_in_rows, 128)).astype(
        np.float32)
    cot = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    results = []
    for device in (torch.device("cpu"), cuda):
        t = torch.tensor(table, device=device, requires_grad=True)
        out = rl.featureless_aggregate(t, plans.to(device), d)
        out.backward(cot.to(device))
        results.append((out.detach().cpu(), t.grad.cpu()))
    (o_cpu, g_cpu), (o_gpu, g_gpu) = results
    torch.testing.assert_close(o_gpu, o_cpu, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=1e-5, atol=1e-4)


def assert_bf16_close(got, want, scale, what):
    from mrgcn_tpu_torch.ops.kernel_bounds import bf16_error
    assert bool(torch.isfinite(got).all()), what
    err, ratio = bf16_error(got, want, scale)
    assert ratio <= 1.0, f"{what}: max abs err {err}, {ratio} x the bound"


def attention_inputs(cuda, N, L, d, seed, strided=True):
    """q, k, v (bf16, k and v as slices of one fused (N, L, 3d) tensor as
    the text encoder hands them over) and a key mask with ragged lengths,
    one sequence of length 1 and one that is all padding."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(N, L, 3 * d, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    if not strided:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lengths = torch.randint(1, L + 1, (N,), generator=gen)
    lengths[0] = 1
    if N > 1:
        lengths[1] = 0
    valid = (torch.arange(L)[None, :] < lengths[:, None]).to(cuda)
    do = torch.randn(N, L, d, generator=gen).to(cuda, torch.bfloat16)
    return q * (1.0 / d ** 0.5), k, v, valid, do


@pytest.mark.gpu
@pytest.mark.parametrize("N,L,d", [(13, 37, 128), (16, 128, 128),
                                   (9, 1, 128), (5, 128, 64),
                                   (3, 16, 16), (6, 200, 128),
                                   (3, 512, 128), (4, 129, 64),
                                   (2, 300, 16)])
def test_attention_kernels_match_plain(cuda, N, L, d):
    from mrgcn_tpu_torch.ops import attention as att
    from mrgcn_tpu_torch.ops.kernel_bounds import attention_scales
    q, k, v, valid, do = attention_inputs(cuda, N, L, d, seed=N * L + d)
    scales = attention_scales(q, k, v, valid, do)
    f0, b0 = att.attention_fwd.launches, att.attention_bwd.launches
    out = att.attention_fwd(q, k, v, valid)
    again = att.attention_fwd(q, k, v, valid)
    grads = att.attention_bwd(q, k, v, valid, do)
    grads_again = att.attention_bwd(q, k, v, valid, do)
    torch.cuda.synchronize()
    assert att.attention_fwd.launches == f0 + 2
    assert att.attention_bwd.launches == b0 + 2
    assert_bf16_close(out, att.attention_fwd_reference(q, k, v, valid),
                      scales[0], "out")
    assert torch.equal(out, again)
    want = att.attention_bwd_reference(q, k, v, valid, do)
    for name, g, w, s, g2 in zip(("dq", "dk", "dv"), grads, want,
                                 scales[1:], grads_again):
        assert_bf16_close(g, w, s, name)
        assert torch.equal(g, g2), name
    if N > 1:   # the all-padding sequence: uniform softmax, no logit grad
        v1 = v[1].float()
        assert_bf16_close(out[1], v1.mean(0, keepdim=True).expand(L, d),
                          v1.abs().mean(0, keepdim=True).expand(L, d),
                          "uniform")
        assert not grads[0][1].any() and not grads[1][1].any()


@pytest.mark.gpu
def test_fused_attention_autograd_on_card_matches_cpu(cuda):
    from mrgcn_tpu_torch.ops.attention import fused_attention
    from mrgcn_tpu_torch.ops.kernel_bounds import attention_scales
    q, k, v, valid, do = attention_inputs(cuda, 6, 40, 32, seed=3)
    # the leaves' q enters the core scaled by 1/sqrt(d) in bf16, so its
    # gradient's terms are the core's times that factor
    c = torch.tensor(32 ** -0.5, dtype=torch.bfloat16)
    s_out, s_dq, s_dk, s_dv = attention_scales(q * c, k, v, valid, do)
    scales = (s_out, s_dq * float(c), s_dk, s_dv)
    results = []
    for device in (torch.device("cpu"), cuda):
        leaves = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = fused_attention(*leaves, valid.to(device))
        out.backward(do.to(device))
        results.append([out.detach().cpu()]
                       + [t.grad.cpu() for t in leaves])
    for name, a, b, s in zip(("out", "dq", "dk", "dv"), *results, scales):
        assert_bf16_close(b, a, s.cpu(), name)


@pytest.mark.gpu
@pytest.mark.parametrize("M,d,hd", [(1000, 128, 512), (37, 16, 64),
                                    (4101, 64, 256), (128, 128, 512)])
def test_mlp_kernels_match_plain(cuda, M, d, hd):
    from mrgcn_tpu_torch.ops import fused_mlp as fm
    from mrgcn_tpu_torch.ops.kernel_bounds import mlp_scales
    gen = torch.Generator(device="cpu").manual_seed(M + d + hd)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            cuda, torch.bfloat16)

    x, do = rnd(M, d), rnd(M, d)
    w1, b1 = rnd(d, hd, scale=d ** -0.5), rnd(hd, scale=0.5)
    w2, b2 = rnd(hd, d, scale=hd ** -0.5), rnd(d, scale=0.5)
    scales = mlp_scales(x, w1, b1, w2, b2, do)
    f0, b0 = fm.mlp_fwd.launches, fm.mlp_bwd.launches
    out = fm.mlp_fwd(x, w1, b1, w2, b2)
    again = fm.mlp_fwd(x, w1, b1, w2, b2)
    grads = fm.mlp_bwd(x, w1, b1, w2, do)
    grads_again = fm.mlp_bwd(x, w1, b1, w2, do)
    torch.cuda.synchronize()
    assert (fm.mlp_fwd.launches, fm.mlp_bwd.launches) == (f0 + 2, b0 + 2)
    assert_bf16_close(out, fm.mlp_fwd_reference(x, w1, b1, w2, b2),
                      scales[0], "out")
    assert torch.equal(out, again)
    want = fm.mlp_bwd_reference(x, w1, b1, w2, do)
    for name, g, w, s, g2 in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                                 want, scales[1:], grads_again):
        assert_bf16_close(g, w, s, name)
        assert torch.equal(g, g2), name


@pytest.mark.gpu
def test_encoder_kernels_reject_bad_arguments(cuda):
    from mrgcn_tpu_torch.ops import attention as att
    from mrgcn_tpu_torch.ops import fused_mlp as fm
    q, k, v, valid, do = attention_inputs(cuda, 2, 8, 16, seed=0)
    with pytest.raises(TypeError, match="bf16"):
        att.attention_fwd(q.float(), k, v, valid)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        long = torch.zeros(1, 513, 16, dtype=torch.bfloat16, device=cuda)
        att.attention_fwd(long, long, long,
                          torch.ones(1, 513, dtype=torch.bool, device=cuda))
    x = torch.zeros(4, 24, dtype=torch.bfloat16, device=cuda)
    w1 = torch.zeros(24, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        fm.mlp_fwd(x, w1, w1[0], w1.t(), x[0])
