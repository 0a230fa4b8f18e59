"""The port's block-sorted scatter against the JAX package's.

Same streams, made with numpy from a seed, go through
``mrgcn_tpu.ops.pallas_gather.sorted_scatter`` (its XLA path, and the
Pallas kernel in interpret mode) and ``mrgcn_tpu_torch``'s
``sorted_scatter`` (on CPU tensors: its plain version). Streams cover
padding edges, repeated block ids, unvisited blocks and rows past
``out_rows``. Tolerance 1e-5: both sum the same f32 values, in different
orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrgcn_tpu.ops.pallas_gather import sorted_scatter as jax_scatter
from mrgcn_tpu_torch.ops.sorted_stream import (sorted_scatter,
                                               sorted_scatter_reference)

from tests.test_torch_kernels_gpu import make_stream


def numpy_scatter(msgs, local, blk, out_rows, rb):
    want = np.zeros((out_rows, msgs.shape[1]), np.float32)
    rows = (blk[:, None] * rb + local).reshape(-1)
    valid = (local.reshape(-1) < rb) & (rows < out_rows)
    np.add.at(want, rows[valid], msgs[valid])
    return want


def torch_scatter(msgs, local, blk, out_rows, rb, eb):
    return sorted_scatter(torch.from_numpy(msgs), torch.from_numpy(local),
                          torch.from_numpy(blk), out_rows, rb, eb).numpy()


@pytest.mark.parametrize("seed,nslab,n_blocks,L", [
    (0, 7, 6, 128), (1, 12, 10, 128), (2, 5, 4, 256), (3, 9, 12, 64)])
def test_sorted_scatter_matches_jax_xla(seed, nslab, n_blocks, L):
    rb, eb = 16, 8
    msgs, local, blk = make_stream(seed, nslab, rb, eb, n_blocks, L)
    out_rows = n_blocks * rb
    want = np.asarray(jax_scatter(jnp.asarray(msgs), jnp.asarray(local),
                                  jnp.asarray(blk), out_rows, rb, eb))
    got = torch_scatter(msgs, local, blk, out_rows, rb, eb)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, numpy_scatter(msgs, local, blk,
                                                  out_rows, rb),
                               rtol=1e-5, atol=1e-5)
    # unvisited (odd) blocks stay zero
    for b in range(1, n_blocks, 2):
        assert not got[b * rb:(b + 1) * rb].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_scatter_matches_jax_pallas_interpret(seed, monkeypatch):
    rb, eb, n_blocks = 16, 8, 6
    msgs, local, blk = make_stream(seed, 7, rb, eb, n_blocks)
    out_rows = n_blocks * rb
    monkeypatch.setenv("MRGCN_FORCE_PALLAS_GATHER", "1")
    want = np.asarray(jax_scatter(jnp.asarray(msgs), jnp.asarray(local),
                                  jnp.asarray(blk), out_rows, rb, eb,
                                  interpret=True))
    got = torch_scatter(msgs, local, blk, out_rows, rb, eb)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sorted_scatter_drops_rows_past_out_rows():
    rb, eb = 16, 8
    msgs, local, blk = make_stream(4, 8, rb, eb, 8)
    out_rows = 6 * rb - 5        # the last visited block is cut short
    got = torch_scatter(msgs, local, blk, out_rows, rb, eb)
    assert got.shape == (out_rows, msgs.shape[1])
    np.testing.assert_allclose(got, numpy_scatter(msgs, local, blk,
                                                  out_rows, rb),
                               rtol=1e-5, atol=1e-5)


def test_sorted_scatter_cpu_takes_plain_version_and_counts_no_launch():
    msgs, local, blk = make_stream(5)
    before = sorted_scatter.launches
    a = torch_scatter(msgs, local, blk, 96, 16, 8)
    b = sorted_scatter_reference(torch.from_numpy(msgs),
                                 torch.from_numpy(local),
                                 torch.from_numpy(blk), 96, 16, 8).numpy()
    np.testing.assert_array_equal(a, b)
    assert sorted_scatter.launches == before


def test_sorted_scatter_rejects_mixed_and_unknown_devices():
    msgs, local, blk = make_stream(6)
    m, lo, bl = (torch.from_numpy(x) for x in (msgs, local, blk))
    with pytest.raises(ValueError, match="local is on meta"):
        sorted_scatter(m, lo.to("meta"), bl, 96, 16, 8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sorted_scatter(m.to("meta"), lo.to("meta"), bl.to("meta"), 96, 16,
                       8)


def test_kernel_build_is_lazy():
    """Importing the port never builds or loads a kernel library (the
    CPU suite runs without nvcc)."""
    from mrgcn_tpu_torch.ops import _build
    assert "sorted_scatter" not in _build._loaded
    assert _build.NVCC_FLAGS[:2] == ("-gencode",
                                     "arch=compute_90a,code=sm_90a")
