"""The port's sorted_gather, fused_scatter_dot and fused_place_scatter
against the JAX package's.

Same streams, made with numpy from a seed, go through the wrappers of
``mrgcn_tpu.ops.pallas_gather`` (XLA path, and the Pallas kernels in
interpret mode) and through ``mrgcn_tpu_torch.ops.sorted_stream`` (on CPU
tensors: the plain versions). Streams cover padding edges and slabs,
repeated block ids, unvisited blocks, ``k`` in {1, 8} and values narrower
than their slot. Tolerance 1e-6 relative (plus 1e-6 absolute on sums that
cancel): both sides add the same f32 values, in different orders; the
gather is a copy and must agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.ops import pallas_gather as jpg
from mrgcn_tpu_torch.ops import sorted_stream as ss

from tests.test_torch_kernels_gpu import make_stream

RB, EB = 16, 8
TOL = dict(rtol=1e-6, atol=1e-6)


def stream(seed, nslab=12, n_blocks=10, L=128):
    """``make_stream`` plus one slab that is all padding."""
    msgs, local, blk = make_stream(seed, nslab, RB, EB, n_blocks, L)
    local[nslab // 2] = RB
    return msgs, local, blk


def t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture(params=["xla", "interpret"])
def jax_mode(request, monkeypatch):
    """The JAX side's XLA reference, or its Pallas kernel in interpret
    mode; gives the ``interpret`` argument."""
    if request.param == "interpret":
        monkeypatch.setenv("MRGCN_FORCE_PALLAS_GATHER", "1")
        return True
    return False


@pytest.mark.parametrize("seed,L", [(0, 128), (1, 256)])
def test_sorted_gather_matches_jax(seed, L, jax_mode):
    _, local, blk = stream(seed, L=L)
    rng = np.random.default_rng(seed)
    blk = rng.permutation(blk)            # a gather takes any block order
    table = rng.standard_normal((10 * RB, L)).astype(np.float32)
    want = np.asarray(jpg.sorted_gather(
        jnp.asarray(table), jnp.asarray(local), jnp.asarray(blk), RB, EB,
        jax_mode))
    got = ss.sorted_gather(*t(table, local, blk), RB, EB).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[local.reshape(-1) == RB].any()     # padding rows: zero


@pytest.mark.parametrize("shuffled", [False, True])
def test_gather_and_scatter_vjps_match_jax(shuffled):
    """Each is the other's backward on the same stream; the gather's
    stream may carry its block ids in any order."""
    msgs, local, blk = stream(2)
    rng = np.random.default_rng(2)
    table = rng.standard_normal((10 * RB, 128)).astype(np.float32)
    cot_g = rng.standard_normal(msgs.shape).astype(np.float32)
    # padding edges carry no cotangent in use (their norm is 0); the JAX
    # segment sum would add one to row 0 of the next block, the port
    # masks it
    cot_g[local.reshape(-1) == RB] = 0.0
    cot_s = rng.standard_normal(table.shape).astype(np.float32)
    jl, jb = jnp.asarray(local), jnp.asarray(blk)
    gblk = rng.permutation(blk) if shuffled else blk

    _, vjp = jax.vjp(lambda x: jpg.sorted_gather(x, jl, jnp.asarray(gblk),
                                                 RB, EB), jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    ss.sorted_gather(tt, *t(local, gblk), RB, EB).backward(
        torch.from_numpy(cot_g))
    np.testing.assert_allclose(tt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot_g))[0]),
                               **TOL)

    _, vjp = jax.vjp(lambda x: jpg.sorted_scatter(x, jl, jb, 10 * RB, RB,
                                                  EB), jnp.asarray(msgs))
    tm = torch.from_numpy(msgs).requires_grad_()
    ss.sorted_scatter(tm, *t(local, blk), 10 * RB, RB, EB).backward(
        torch.from_numpy(cot_s))
    np.testing.assert_array_equal(tm.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(cot_s))[0]))


@pytest.mark.parametrize("seed,L,Lv", [(0, 128, 128), (1, 256, 200),
                                       (2, 128, 21)])
def test_fused_scatter_dot_matches_jax(seed, L, Lv, jax_mode):
    msgs, local, blk = stream(seed, L=L)
    rng = np.random.default_rng(seed)
    dvn = msgs[:, :Lv]                   # its real width, strided rows
    w = rng.standard_normal(msgs.shape[0]).astype(np.float32)
    out_rows = 10 * RB
    table = rng.standard_normal((out_rows, L)).astype(np.float32)
    # the JAX wrapper takes dvn padded to the table's width
    dvn_pad = np.pad(dvn, ((0, 0), (0, L - Lv)))
    want_out, want_dots = jpg.fused_scatter_dot(
        jnp.asarray(dvn_pad), jnp.asarray(w), jnp.asarray(local),
        jnp.asarray(blk), jnp.asarray(table), out_rows, RB, EB, jax_mode)
    got_out, got_dots = ss.fused_scatter_dot(
        torch.from_numpy(msgs)[:, :Lv], *t(w, local, blk, table), out_rows,
        RB, EB)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_dots.numpy(), np.asarray(want_dots),
                               rtol=1e-6, atol=1e-5)
    assert not got_dots.numpy()[local.reshape(-1) == RB].any()
    for b in range(1, 10, 2):            # unvisited (odd) blocks stay zero
        assert not got_out.numpy()[b * RB:(b + 1) * RB].any()
    assert not got_out.numpy()[:, Lv:].any()


@pytest.mark.parametrize("k,L,Lv", [(8, 128, 16), (8, 128, 11), (1, 128, 128),
                                    (1, 256, 200), (4, 128, 21)])
def test_fused_place_scatter_matches_jax(k, L, Lv, jax_mode):
    msgs, local, blk = stream(k + Lv, L=L)
    rng = np.random.default_rng(k + Lv)
    E = msgs.shape[0]
    V = msgs[:, :Lv]
    place = rng.integers(0, k, E).astype(np.int32)
    norm = rng.random(E).astype(np.float32)
    out_rows = 10 * RB
    if jax_mode:
        want = np.asarray(jpg.fused_place_scatter(
            jnp.asarray(V), jnp.asarray(place), jnp.asarray(norm),
            jnp.asarray(local), jnp.asarray(blk), out_rows, k, L, RB, EB,
            interpret=True))
    else:
        # the JAX package's default route: expand, then sorted_scatter
        sub = L // k
        lines = np.zeros((E, k, sub), np.float32)
        lines[np.arange(E), place, :Lv] = V * norm[:, None]
        want = np.asarray(jpg.sorted_scatter(
            jnp.asarray(lines.reshape(E, L)), jnp.asarray(local),
            jnp.asarray(blk), out_rows, RB, EB))
    got = ss.fused_place_scatter(
        torch.from_numpy(msgs)[:, :Lv], *t(place, norm, local, blk),
        out_rows, k, L, RB, EB).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for b in range(1, 10, 2):
        assert not got[b * RB:(b + 1) * RB].any()


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    msgs, local, blk = stream(5)
    rng = np.random.default_rng(5)
    table = rng.standard_normal((10 * RB, 128)).astype(np.float32)
    w = rng.random(msgs.shape[0]).astype(np.float32)
    place = np.zeros(msgs.shape[0], np.int32)
    before = [f.launches for f in (ss.sorted_gather, ss.fused_scatter_dot,
                                   ss.fused_place_scatter)]
    a = ss.sorted_gather(*t(table, local, blk), RB, EB)
    b = ss.sorted_gather_reference(*t(table, local, blk), RB, EB)
    assert torch.equal(a, b)
    a = ss.fused_scatter_dot(*t(msgs, w, local, blk, table), 10 * RB, RB, EB)
    b = ss.fused_scatter_dot_reference(*t(msgs, w, local, blk, table),
                                       10 * RB, RB, EB)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = ss.fused_place_scatter(*t(msgs, place, w, local, blk), 10 * RB, 1,
                               128, RB, EB)
    b = ss.fused_place_scatter_reference(*t(msgs, place, w, local, blk),
                                         10 * RB, 1, 128, RB, EB)
    assert torch.equal(a, b)
    assert before == [f.launches for f in (
        ss.sorted_gather, ss.fused_scatter_dot, ss.fused_place_scatter)]


def test_wrappers_reject_misfits_and_unknown_devices():
    msgs, local, blk = stream(6)
    m, lo, bl = t(msgs, local, blk)
    w = torch.ones(m.shape[0])
    place = torch.zeros(m.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit slots"):
        ss.fused_place_scatter(m, place, w, lo, bl, 160, 8, 128, RB, EB)
    with pytest.raises(ValueError, match="do not fit"):
        ss.fused_scatter_dot(m, w, lo, bl, torch.zeros(160, 64), 160, RB,
                             EB)
    with pytest.raises(ValueError, match="local is on meta"):
        ss.sorted_gather(m, lo.to("meta"), bl, RB, EB)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ss.fused_place_scatter(*(x.to("meta") for x in (m, place, w, lo, bl)),
                               160, 1, 128, RB, EB)
