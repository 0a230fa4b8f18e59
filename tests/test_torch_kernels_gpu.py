"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests import no JAX, so they also run on a machine with a card and
without JAX (the repository's conftest imports JAX, hence
``--noconftest``)::

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Elsewhere they skip. Tolerance atol 1e-4 / rtol 1e-5: the kernel and
``index_add_`` sum the same f32 values in different orders.
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
