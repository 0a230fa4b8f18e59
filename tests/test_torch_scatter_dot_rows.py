"""``fused_scatter_dot``'s row-segmented route: the planner's
``Stream.rows_sorted``, the flag's way to the wrapper, and the function
on row-sorted streams against the JAX package's.

``rows_sorted`` is held to a direct numpy check of each stream (the real
edges' scatter rows never decrease) for every plan kind. The basis
layer's backward must hand the planner's flag to the wrapper (a spy
records the keyword). On CPU tensors the wrapper takes the plain version
whatever the flag says. The function on a row-sorted stream with a hub row
over many slabs and an all-padding slab inside its run
(``chip_smoke.sorted_adversarial_stream``) matches
``mrgcn_tpu.ops.pallas_gather.fused_scatter_dot`` (XLA path and the
Pallas kernel in interpret mode) to 1e-6 relative: both sides add the
same f32 values in different orders. The kernel itself runs on the card
(``tests/test_torch_kernels_gpu.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import sorted_adversarial_stream
from mrgcn_tpu.ops import pallas_gather as jpg
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops import sorted_stream as ss

from tests.test_torch_stream_kernels import jax_mode  # noqa: F401


def numpy_rows_sorted(stream) -> bool:
    local = stream.scatter_local.numpy()
    rows = (stream.scatter_blk.numpy().astype(np.int64)[:, None]
            * stream.row_block + local).reshape(-1)
    rows = rows[local.reshape(-1) < stream.row_block]
    return bool(np.all(np.diff(rows) >= 0))


def graph(seed, n, R, E, n_out=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_out or n, E)
    dst = rng.integers(0, n, E)
    rel = rng.integers(0, R, E)
    return src, dst, rel, rng.random(E).astype(np.float32)


@pytest.mark.parametrize("case", ["identity", "identity_basis",
                                  "dense_relation_constant", "dense",
                                  "rectangular"])
def test_rows_sorted_matches_a_direct_check(case):
    n, k = 300, 1
    extra = {}
    if case == "dense_relation_constant":
        # few relations, many edges a block: the relation-constant layout
        # pads little and is taken
        args, kind, k = graph(0, n, 3, 6000), "dense", 8
    elif case == "dense":
        # hundreds of relations: the relation-constant layout would pad
        # too much, the streams stay row-sorted
        args, kind = graph(1, n, 200, 2000), "dense"
    elif case == "rectangular":
        args, kind = graph(2, n, 5, 2000, n_out=90), "identity_basis"
        extra = dict(num_out_nodes=90, num_in_nodes=n)
    else:
        args, kind = graph(3, n, 5, 2000), case
    plans = rl.build_layer_plans(*args, n, k, k, row_block=64,
                                 edge_block=32, kind=kind, **extra)
    for name in ("fwd", "bwd_table", "bwd_h"):
        stream = getattr(plans, name)
        assert stream.rows_sorted == numpy_rows_sorted(stream), name
        if not stream.rel_const:
            # sorted by the scatter row itself: always row-sorted
            assert stream.rows_sorted, name
    if case == "dense_relation_constant":
        assert plans.fwd.rel_const and plans.bwd_h.rel_const
        assert not plans.fwd.rows_sorted and not plans.bwd_h.rows_sorted
    if kind == "identity_basis":
        assert plans.bwd_h.rows_sorted
    moved = plans.to("cpu")
    assert moved.bwd_h.rows_sorted == plans.bwd_h.rows_sorted


@pytest.mark.parametrize("flag", [True, False])
def test_basis_backward_hands_the_planners_flag_to_the_wrapper(
        monkeypatch, flag):
    """``featureless_basis`` at ``k == 1`` calls ``fused_scatter_dot``
    once per basis with ``rows_sorted`` as the plan's ``bwd_h`` has it
    (the planner's ``True``, or a plan edited to ``False``); the
    gradients are the same either way on the CPU."""
    src, dst, rel, norm = graph(4, 300, 5, 2000)
    plans = rl.build_layer_plans(src, dst, rel, norm, 300, 1, 1,
                                 row_block=64, edge_block=32,
                                 kind="identity_basis")
    assert plans.bwd_h.rows_sorted
    if not flag:
        plans = dataclasses.replace(
            plans, bwd_h=dataclasses.replace(plans.bwd_h, rows_sorted=False))
    seen = []
    real = rl.fused_scatter_dot

    def spy(*args, **kwargs):
        seen.append(kwargs.get("rows_sorted"))
        return real(*args, **kwargs)

    monkeypatch.setattr(rl, "fused_scatter_dot", spy)
    rng = np.random.default_rng(5)
    comp = torch.tensor(rng.standard_normal((5, 2)), dtype=torch.float32,
                        requires_grad=True)
    packed = torch.tensor(rng.standard_normal((2, plans.n_in_rows, 256)),
                          dtype=torch.float32, requires_grad=True)
    out = rl.featureless_basis(comp, packed, plans, 200)
    out.backward(torch.tensor(rng.standard_normal(out.shape),
                              dtype=torch.float32))
    assert seen == [flag, flag]
    # the packed route gives the same gradients (the fork the layer
    # settles by device time on the card)
    h = plans.bwd_h
    d_vh = torch.tensor(rng.standard_normal((h.num_padded_edges, 200)),
                        dtype=torch.float32)
    w_h = comp.detach()[h.rel.long()]
    fused = rl._basis_grads_fused(d_vh, w_h, h, packed.detach(),
                                  plans.n_in_rows)
    placed = rl._basis_grads_placed(d_vh, w_h, h, packed.detach(), 1,
                                    plans.n_in_rows, 200)
    for a, b in zip(fused, placed):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def sorted_inputs(seed, rb=16, eb=8, L=128, Lv=100):
    rng = np.random.default_rng(seed)
    local, blk, scale = sorted_adversarial_stream(rng, 200, rb, eb, 10, 300)
    E, out_rows = local.size, 10 * rb
    dvn = (rng.standard_normal((E, Lv)) * scale[:, None]).astype(np.float32)
    w = rng.random(E).astype(np.float32)
    table = rng.standard_normal((out_rows, L)).astype(np.float32)
    return dvn, w, local, blk, table, out_rows


@pytest.mark.parametrize("rows_sorted", [False, True])
def test_cpu_tensors_take_the_plain_version_with_either_flag(rows_sorted):
    dvn, w, local, blk, table, out_rows = sorted_inputs(6)
    args = tuple(torch.from_numpy(a) for a in (dvn, w, local, blk, table))
    before = (ss.fused_scatter_dot.launches,
              ss.fused_scatter_dot.launches_rows)
    got = ss.fused_scatter_dot(*args, out_rows, 16, 8,
                               rows_sorted=rows_sorted)
    want = ss.fused_scatter_dot_reference(*args, out_rows, 16, 8)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert (ss.fused_scatter_dot.launches,
            ss.fused_scatter_dot.launches_rows) == before


def test_row_sorted_stream_matches_jax(jax_mode):  # noqa: F811
    """A hub row of about 270 edges over 35 slabs, split by an
    all-padding slab, unvisited blocks, a tenth of the edges padding."""
    dvn, w, local, blk, table, out_rows = sorted_inputs(7)
    L, Lv = table.shape[1], dvn.shape[1]
    row = blk[:, None].astype(np.int64) * 16 + local
    assert np.bincount(row[local < 16]).max() > 128   # longer than a chunk
    want_out, want_dots = jpg.fused_scatter_dot(
        jnp.asarray(np.pad(dvn, ((0, 0), (0, L - Lv)))), jnp.asarray(w),
        jnp.asarray(local), jnp.asarray(blk), jnp.asarray(table), out_rows,
        16, 8, jax_mode)
    got_out, got_dots = ss.fused_scatter_dot(
        *(torch.from_numpy(a) for a in (dvn, w, local, blk, table)),
        out_rows, 16, 8, rows_sorted=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_dots.numpy(), np.asarray(want_dots),
                               rtol=1e-6, atol=1e-5)
    assert not got_dots.numpy()[local.reshape(-1) == 16].any()
    assert not got_out.numpy()[:, Lv:].any()
