"""The scatters' row-segmented route: the planner's ``Stream.rows_sorted``
on its way from every call site to ``sorted_scatter`` and
``fused_place_scatter``, and the two functions on the streams the routes
meet against the JAX package's.

The layer ops must hand each stream's flag to the scatter that walks it
(spies record the keyword): ``featureless_aggregate`` forward and
backward, ``featureless_basis`` forward and its packed backward
(``_basis_grads_placed``), and ``dense_aggregate``'s forward and ``bwd_h``
scatters with relation-constant streams and without. The plain versions
(what CPU tensors take, whatever the flag says) match
``mrgcn_tpu.ops.pallas_gather`` (its XLA path and its Pallas kernels in
interpret mode) on planner streams sorted by row at (k, Lv, L) = (8, 16,
128), (4, 21, 128) and (1, 200, 256), on a row-sorted stream whose slots
interleave within a row, and on a relation-constant stream, to 1e-6
relative (plus 1e-6 absolute): both sides add the same f32 values in
different orders. The kernels themselves run on the card
(``tests/test_torch_kernels_gpu.py``); ``chip_smoke.scatter_work``, the
byte count of their bounds, counts values at the real edges only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import edge_rows, scatter_work, sorted_adversarial_stream
from mrgcn_tpu.ops import pallas_gather as jpg
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops import sorted_stream as ss

from tests.test_torch_dense import CASES, dense_case
from tests.test_torch_stream_kernels import jax_mode  # noqa: F401

RB, EB = 16, 8
TOL = dict(rtol=1e-6, atol=1e-6)


def graph(seed, n=300, R=5, E=2000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, E), rng.integers(0, n, E),
            rng.integers(0, R, E), rng.random(E).astype(np.float32))


def cleared(plans):
    """The plans with every stream's ``rows_sorted`` set to False."""
    off = {name: dataclasses.replace(getattr(plans, name), rows_sorted=False)
           for name in ("fwd", "bwd_table", "bwd_h")}
    return dataclasses.replace(plans, **off)


def spy_on_scatters(monkeypatch):
    """Record, for each call of the layer ops' two scatters, the wrapper,
    the stream's ``scatter_local`` and the ``rows_sorted`` keyword."""
    calls = []
    for name in ("fused_place_scatter", "sorted_scatter"):
        real = getattr(rl, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            local = args[3] if _name == "fused_place_scatter" else args[1]
            calls.append((_name, local.data_ptr(),
                          kwargs.get("rows_sorted")))
            return _real(*args, **kwargs)

        monkeypatch.setattr(rl, name, spy)
    return calls


def run_featureless(plans, out_dim):
    rng = np.random.default_rng(1)
    L = rl.line_width(plans.k_in, out_dim)
    table = torch.tensor(rng.standard_normal((5 * plans.n_in_rows, L)),
                         dtype=torch.float32, requires_grad=True)
    out = rl.featureless_aggregate(table, plans, out_dim)
    out.backward(torch.ones_like(out))


def run_basis(plans, out_dim):
    rng = np.random.default_rng(2)
    L = rl.line_width(plans.k_in, out_dim)
    comp = torch.tensor(rng.standard_normal((5, 2)), dtype=torch.float32,
                        requires_grad=True)
    packed = torch.tensor(rng.standard_normal((2, plans.n_in_rows, L)),
                          dtype=torch.float32, requires_grad=True)
    out = rl.featureless_basis(comp, packed, plans, out_dim)
    out.backward(torch.ones_like(out))


def run_dense(plans, H, W, in_dim, out_dim):
    h = torch.tensor(H, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    out = rl.dense_aggregate(h, w, plans, in_dim, out_dim)
    out.backward(torch.ones_like(out))


@pytest.mark.parametrize("edit", ["planner", "cleared"])
@pytest.mark.parametrize("op", ["featureless_aggregate", "featureless_basis",
                                "dense_rel_const", "dense_per_edge"])
def test_every_call_site_hands_its_streams_flag_to_the_scatter(
        monkeypatch, op, edit):
    """Each scatter call gets ``rows_sorted`` as the stream it walks has
    it: the planner's (True but on relation-constant streams), or False
    everywhere in plans edited so."""
    if op.startswith("dense"):
        case = CASES["rel_const_k4" if op == "dense_rel_const"
                     else "per_edge_k4"]
        plans, _, H, W, _ = dense_case(*case[:7])
        run = lambda p: run_dense(p, H, W, 21, 16)  # noqa: E731
        # forward on fwd, d_H on bwd_h; the wrapper by layout
        wrapper = "fused_place_scatter" if op == "dense_rel_const" \
            else "sorted_scatter"
        expect = [(wrapper, "fwd"), (wrapper, "bwd_h")]
        assert plans.fwd.rel_const == plans.bwd_h.rel_const \
            == (op == "dense_rel_const")
    elif op == "featureless_aggregate":
        plans = rl.build_layer_plans(*graph(3), 300, 8, 8, row_block=RB,
                                     edge_block=EB, kind="identity")
        run = lambda p: run_featureless(p, 16)  # noqa: E731
        expect = [("fused_place_scatter", "fwd"),
                  ("fused_place_scatter", "bwd_table")]
    else:
        # packed rows (k = 8): the backward's place-scatter per basis
        plans = rl.build_layer_plans(*graph(4), 300, 8, 8, row_block=RB,
                                     edge_block=EB, kind="identity_basis")
        run = lambda p: run_basis(p, 16)  # noqa: E731
        expect = [("fused_place_scatter", "fwd"),
                  ("fused_place_scatter", "bwd_h"),
                  ("fused_place_scatter", "bwd_h")]
    for name in ("fwd", "bwd_table", "bwd_h"):
        stream = getattr(plans, name)
        assert stream.rows_sorted == (not stream.rel_const), name
    if edit == "cleared":
        plans = cleared(plans)
    calls = spy_on_scatters(monkeypatch)
    run(plans)
    assert calls == [(wrapper, getattr(plans, stream).scatter_local
                      .data_ptr(), getattr(plans, stream).rows_sorted)
                     for wrapper, stream in expect]


def jax_place_scatter(V, place, norm, local, blk, out_rows, k, L, interpret):
    """The JAX package's place-scatter: its Pallas kernel in interpret
    mode, or its default route (expand, then ``sorted_scatter``)."""
    if interpret:
        return np.asarray(jpg.fused_place_scatter(
            jnp.asarray(V), jnp.asarray(place), jnp.asarray(norm),
            jnp.asarray(local), jnp.asarray(blk), out_rows, k, L, RB, EB,
            interpret=True))
    return np.asarray(jpg.sorted_scatter(
        jnp.asarray(expand(V, place, norm, k, L)), jnp.asarray(local),
        jnp.asarray(blk), out_rows, RB, EB))


def expand(V, place, norm, k, L):
    E, Lv = V.shape
    lines = np.zeros((E, k, L // k), np.float32)
    lines[np.arange(E), place, :Lv] = V * norm[:, None]
    return lines.reshape(E, L)


def check_both_scatters(V, place, norm, local, blk, out_rows, k, L,
                        rows_sorted, interpret):
    """``fused_place_scatter`` and ``sorted_scatter`` (on the expanded
    lines) with the stream's flag against the JAX package's."""
    want = jax_place_scatter(V, place, norm, local, blk, out_rows, k, L,
                             interpret)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = ss.fused_place_scatter(t(V), t(place), t(norm), t(local), t(blk),
                                 out_rows, k, L, RB, EB,
                                 rows_sorted=rows_sorted).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    lines = expand(V, place, norm, k, L)
    want = np.asarray(jpg.sorted_scatter(
        jnp.asarray(lines), jnp.asarray(local), jnp.asarray(blk), out_rows,
        RB, EB, interpret))
    got = ss.sorted_scatter(t(lines), t(local), t(blk), out_rows, RB, EB,
                            rows_sorted=rows_sorted).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,Lv,L", [(8, 16, 128), (4, 21, 128),
                                    (1, 200, 256)])
def test_plain_versions_match_jax_on_planner_row_sorted_streams(
        k, Lv, L, jax_mode):  # noqa: F811
    """The identity plans' ``fwd`` stream (sorted by source row) at the
    NC paths' width (k = 8, 16 values), a dense input's (k = 4, 21) and
    link prediction's (k = 1, 200 of 256 lanes)."""
    plans = rl.build_layer_plans(*graph(k + Lv), 300, k, k, row_block=RB,
                                 edge_block=EB, kind="identity")
    f = plans.fwd
    assert f.rows_sorted and not f.rel_const
    rng = np.random.default_rng(Lv)
    V = rng.standard_normal((f.num_padded_edges, Lv)).astype(np.float32)
    check_both_scatters(V, f.out_mod.numpy(), f.norm.numpy(),
                        f.scatter_local.numpy(), f.scatter_blk.numpy(),
                        plans.n_out_rows, k, L, True, jax_mode)


def test_plain_versions_match_jax_with_slots_interleaved_in_a_row(
        jax_mode):  # noqa: F811
    """A row-sorted stream with a hub row of 300 edges over many slabs
    and an all-padding slab inside its run; each edge's slot drawn on its
    own, so slots interleave within every row."""
    rng = np.random.default_rng(8)
    local, blk, scale = sorted_adversarial_stream(rng, 200, RB, EB, 10, 300)
    E = local.size
    row = blk[:, None].astype(np.int64) * RB + local
    assert np.bincount(row[local < RB]).max() > 128   # longer than a chunk
    V = (rng.standard_normal((E, 16)) * scale[:, None]).astype(np.float32)
    place = rng.integers(0, 8, E).astype(np.int32)
    norm = rng.random(E).astype(np.float32)
    check_both_scatters(V, place, norm, local, blk, 10 * RB, 8, 128, True,
                        jax_mode)


def test_plain_versions_match_jax_on_a_relation_constant_stream(
        jax_mode):  # noqa: F811
    """A dense plan's relation-constant ``fwd`` stream (not sorted by
    row): the split walk's route."""
    plans, _, _, _, _ = dense_case(*CASES["rel_const_k4"][:7])
    f = plans.fwd
    assert f.rel_const and not f.rows_sorted
    rng = np.random.default_rng(9)
    V = rng.standard_normal((f.num_padded_edges, 16)).astype(np.float32)
    check_both_scatters(V, f.out_mod.numpy(), f.norm.numpy(),
                        f.scatter_local.numpy(), f.scatter_blk.numpy(),
                        plans.n_out_rows, plans.k_out, 128, False, jax_mode)


@pytest.mark.parametrize("wrapper", ["sorted_scatter", "fused_place_scatter"])
def test_cpu_scatters_take_the_plain_version_with_either_flag(wrapper):
    """On CPU tensors both flags give the plain version's result, bit for
    bit, and no launch is counted."""
    rng = np.random.default_rng(10)
    local, blk, _ = sorted_adversarial_stream(rng, 200, RB, EB, 10, 300)
    E = local.size
    msgs = torch.from_numpy(rng.standard_normal((E, 128)).astype(np.float32))
    place = torch.from_numpy(rng.integers(0, 8, E).astype(np.int32))
    norm = torch.from_numpy(rng.random(E).astype(np.float32))
    lo, bl = torch.from_numpy(local), torch.from_numpy(blk)
    if wrapper == "sorted_scatter":
        args = (msgs, lo, bl, 10 * RB, RB, EB)
        plain = ss.sorted_scatter_reference(*args)
    else:
        args = (msgs[:, :16], place, norm, lo, bl, 10 * RB, 8, 128, RB, EB)
        plain = ss.fused_place_scatter_reference(*args)
    fn = getattr(ss, wrapper)
    before = (fn.launches, fn.launches_rows)
    for flag in (False, True):
        assert torch.equal(fn(*args, rows_sorted=flag), plain)
    assert (fn.launches, fn.launches_rows) == before


@pytest.mark.parametrize("nslab,L,sms,want", [
    (1759, 128, 132, 27),     # the NC dense forward stream: 264 blocks
    (9, 128, 132, 4),         # a small stream: the least segment
    (12_000, 256, 132, 364)])
def test_split_segment_gives_two_blocks_an_sm(nslab, L, sms, want):
    """The split walk's segment: the stream's slab-tiles over two blocks
    an SM, at least 4 slabs; the segments then give at most two blocks an
    SM for every 32-lane tile."""
    seg = ss.split_segment(nslab, L, sms)
    assert seg == want
    assert -(-nslab // seg) * (L // 32) <= 2 * sms or seg == 4


@pytest.mark.parametrize("per_edge,flops", [(128, 128), (18, 32)])
def test_scatter_bound_counts_values_at_real_edges_only(per_edge, flops):
    """A slab of padding adds its slot indices (and its block id) to a
    scatter's bound, none of its values: #1's line and #5's values, slot
    and norm are read at the real edges only."""
    rng = np.random.default_rng(11)
    local, blk, _ = sorted_adversarial_stream(rng, 200, RB, EB, 10, 300)
    lo, bl = torch.from_numpy(local), torch.from_numpy(blk)
    out_rows, L = 10 * RB, 128
    real = int((edge_rows(lo, bl, RB, out_rows) < out_rows).sum())
    assert 0 < real < local.size
    work = scatter_work(real, per_edge, flops, lo, bl, out_rows, L)
    assert work == (real * per_edge * 4 + (local.size + blk.size) * 4
                    + out_rows * L * 4, real * flops)
    lo2 = torch.cat([lo, torch.full((1, EB), RB, dtype=lo.dtype)])
    bl2 = torch.cat([bl, bl[-1:]])
    real2 = int((edge_rows(lo2, bl2, RB, out_rows) < out_rows).sum())
    work2 = scatter_work(real2, per_edge, flops, lo2, bl2, out_rows, L)
    assert (work2[0] - work[0], work2[1]) == ((EB + 1) * 4, work[1])
