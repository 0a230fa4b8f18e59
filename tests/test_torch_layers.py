"""The port's layer ops against the JAX package's, on the same inputs.

Small graphs in the style of tests/test_relational.py (n=57, R=7, E=311,
row_block=16, edge_block=8), made with numpy from a seed and fed to both
packages. Plan arrays must be equal element for element; forward values
agree to 2e-5 and table gradients to 2e-4 (f32 sums in different orders,
as in test_relational.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.encodings.structure import group_by_relation
from mrgcn_tpu.ops import relational as jrl
from mrgcn_tpu.ops import rspmm as jrs
from mrgcn_tpu_torch.models import init as tinit
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops import rspmm

RB, EB = 16, 8


def random_graph(seed=0, n=57, R=7, E=311):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    rel = rng.integers(0, R, E).astype(np.int32)
    norm = rng.random(E).astype(np.float32)
    return src, dst, rel, norm, n, R


def assert_plans_equal(mine, theirs):
    for name in ("k_in", "k_out", "n_in_rows", "n_out_rows", "num_nodes",
                 "kind", "num_out_nodes", "num_in_nodes", "out_nodes"):
        assert getattr(mine, name) == getattr(theirs, name), name
    for stream in ("fwd", "bwd_table", "bwd_h"):
        a, b = getattr(mine, stream), getattr(theirs, stream)
        assert (a.edge_block, a.row_block, a.rel_const) \
            == (b.edge_block, b.row_block, b.rel_const), stream
        for f in dataclasses.fields(a):
            val = getattr(a, f.name)
            if isinstance(val, torch.Tensor):
                want = np.asarray(getattr(b, f.name))
                got = val.numpy()
                assert got.dtype == want.dtype, (stream, f.name)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{stream}.{f.name}")


@pytest.mark.parametrize("case", ["identity", "identity_rect",
                                  "identity_basis", "dense", "dense_wide"])
def test_build_layer_plans_equal_jax(case):
    src, dst, rel, norm, n, R = random_graph(seed=3)
    kw = {}
    kind, k_in, k_out = "identity", 8, 8
    if case == "identity_rect":
        # frontier-restricted input layer: src indexes 23 output rows
        src = (src % 23).astype(np.int32)
        kw["num_out_nodes"] = 23
    elif case == "identity_basis":
        kind = "identity_basis"
    elif case == "dense":
        kind, k_in, k_out = "dense", 8, 8
    elif case == "dense_wide":
        kind, k_in, k_out = "dense", 1, 2
    mine = rl.build_layer_plans(src, dst, rel, norm, n, k_in, k_out,
                                row_block=RB, edge_block=EB, kind=kind, **kw)
    theirs = jrl.build_layer_plans(src, dst, rel, norm, n, k_in, k_out,
                                   row_block=RB, edge_block=EB, kind=kind,
                                   **kw)
    assert_plans_equal(mine, theirs)
    if kind == "identity":
        assert mine.bwd_h is mine.fwd


@pytest.mark.parametrize("rect", [False, True])
def test_plans_for_layers_equal_jax(rect):
    src, dst, rel, norm, n, R = random_graph(seed=4)
    kw = {}
    if rect:
        src = (src % 31).astype(np.int32)
        kw["num_out_nodes"] = 31
    shapes = [(None, 16), (16, 14)] if not rect else [(None, 16)]
    mine = rl.plans_for_layers(src, dst, rel, norm, n, shapes,
                               row_block=RB, edge_block=EB, **kw)
    theirs = jrl.plans_for_layers(src, dst, rel, norm, n, shapes,
                                  row_block=RB, edge_block=EB, **kw)
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        assert_plans_equal(mine[key], theirs[key])


def _featureless_case(out_dim, rect, seed):
    src, dst, rel, norm, n, R = random_graph(seed=seed)
    n_out = n
    if rect:
        n_out = 29
        src = (src % n_out).astype(np.int32)
    k = rspmm.packing_factor(out_dim)
    kw = {"num_out_nodes": n_out} if rect else {}
    mine = rl.build_layer_plans(src, dst, rel, norm, n, k, k, row_block=RB,
                                edge_block=EB, kind="identity", **kw)
    theirs = jrl.build_layer_plans(src, dst, rel, norm, n, k, k,
                                   row_block=RB, edge_block=EB,
                                   kind="identity", **kw)
    rng = np.random.default_rng(seed + 100)
    lw = rl.line_width(k, out_dim)
    table = rng.standard_normal((R * mine.n_in_rows, lw)).astype(np.float32)
    cot = rng.standard_normal((n_out, out_dim)).astype(np.float32)
    return mine, theirs, table, cot


@pytest.mark.parametrize("out_dim,rect", [(16, False), (14, False),
                                          (200, False), (16, True),
                                          (96, True)])
def test_featureless_aggregate_fwd_and_grad_match_jax(out_dim, rect):
    mine, theirs, table, cot = _featureless_case(out_dim, rect, seed=out_dim)

    want, vjp = jax.vjp(
        lambda t: jrl.featureless_aggregate(t, theirs, out_dim),
        jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(cot))

    t = torch.tensor(table, requires_grad=True)
    got = rl.featureless_aggregate(t, mine, out_dim)
    got.backward(torch.from_numpy(cot))

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad),
                               rtol=2e-4, atol=2e-4)


def test_featureless_aggregate_launches_one_scatter_each_way(monkeypatch):
    mine, _, table, cot = _featureless_case(16, False, seed=1)
    calls = []
    real = rl.fused_place_scatter

    def spy(V, place_mod, norm, local, blk, out_rows, *rest, **kw):
        calls.append((local.data_ptr(), out_rows))
        return real(V, place_mod, norm, local, blk, out_rows, *rest, **kw)

    # the scatter of these ops is the fused place-scatter; the plain
    # sorted_scatter must not run beside it
    monkeypatch.setattr(rl, "fused_place_scatter", spy)
    monkeypatch.setattr(rl, "sorted_scatter", None)
    t = torch.tensor(table, requires_grad=True)
    rl.featureless_aggregate(t, mine, 16).backward(torch.from_numpy(cot))
    assert calls == [(mine.fwd.scatter_local.data_ptr(), mine.n_out_rows),
                     (mine.bwd_table.scatter_local.data_ptr(),
                      table.shape[0])]


def test_compose_packed_fwd_and_bwd_match_jax():
    rng = np.random.default_rng(7)
    R, B, rows, L = 7, 3, 32, 128
    comp = rng.standard_normal((R, B)).astype(np.float32)
    packed = rng.standard_normal((B, rows, L)).astype(np.float32)
    cot = rng.standard_normal((R, rows, L)).astype(np.float32)

    want, vjp = jax.vjp(jrs.compose_packed, jnp.asarray(comp),
                        jnp.asarray(packed))
    want_dc, want_dp = vjp(jnp.asarray(cot))

    c = torch.tensor(comp, requires_grad=True)
    p = torch.tensor(packed, requires_grad=True)
    got = rspmm.compose_packed(c, p)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # d_comp sums rows * L = 4096 products of magnitude ~1 per entry
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_dc),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_dp),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_comp", [True, False])
def test_transform_aggregate_grouped_matches_jax(with_comp):
    src, dst, rel, norm, n, R = random_graph(seed=11)
    num_out, in_dim, out_dim, B = 40, 16, 14, 3
    src = (src % num_out).astype(np.int32)
    g = group_by_relation(src, dst, rel, norm, num_out, group_size=8)
    rng = np.random.default_rng(12)
    H = rng.standard_normal((n, in_dim)).astype(np.float32)
    S = B if with_comp else R
    basis = rng.standard_normal((S, in_dim, out_dim)).astype(np.float32)
    comp = rng.standard_normal((R, B)).astype(np.float32) \
        if with_comp else None
    cot = rng.standard_normal((num_out, out_dim)).astype(np.float32)

    def jax_fn(H, basis, comp):
        return jrs.transform_aggregate_grouped(
            H, jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(g.norm),
            jnp.asarray(g.group_rel), g.group_size, num_out, basis, comp)

    args = [jnp.asarray(H), jnp.asarray(basis)]
    args.append(jnp.asarray(comp) if with_comp else None)
    want, vjp = jax.vjp(jax_fn, *args)
    want_grads = vjp(jnp.asarray(cot))

    tensors = [torch.tensor(H, requires_grad=True),
               torch.tensor(basis, requires_grad=True)]
    tensors.append(torch.tensor(comp, requires_grad=True)
                   if with_comp else None)
    got = rspmm.transform_aggregate_grouped(
        tensors[0], torch.from_numpy(g.src), torch.from_numpy(g.dst),
        torch.from_numpy(g.norm), torch.from_numpy(g.group_rel),
        g.group_size, num_out, tensors[1], comp=tensors[2])
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for t, w in zip(tensors, want_grads):
        if t is not None:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,k", [(16, 8), (14, 8), (30, 4), (200, 1)])
def test_packing_helpers_match_jax(d, k):
    rng = np.random.default_rng(d)
    n, E = 37, 50
    X = rng.standard_normal((n, d)).astype(np.float32)
    padded_rows = -(-n // k) + 3
    P = rl.pack_rows(torch.from_numpy(X), k, padded_rows)
    np.testing.assert_array_equal(
        P.numpy(), np.asarray(jrl.pack_rows(jnp.asarray(X), k,
                                            padded_rows)))
    np.testing.assert_array_equal(rl.unpack_rows(P, k, n, d).numpy(), X)

    mod = rng.integers(0, k, E).astype(np.int32)
    V = rng.standard_normal((E, d)).astype(np.float32)
    np.testing.assert_array_equal(
        rl._expand_sub(torch.from_numpy(V), torch.from_numpy(mod),
                       k).numpy(),
        np.asarray(jrl._expand_sub(jnp.asarray(V), jnp.asarray(mod), k)))
    G = rng.standard_normal((E, rl.line_width(k, d))).astype(np.float32)
    np.testing.assert_allclose(
        rl._select_sub(torch.from_numpy(G), torch.from_numpy(mod), k,
                       d).numpy(),
        np.asarray(jrl._select_sub(jnp.asarray(G), jnp.asarray(mod), k, d)),
        rtol=0, atol=0)


@pytest.mark.parametrize("out_dim,n,S", [(16, 101, 3), (14, 64, 2),
                                         (100, 9, 2)])
def test_packing_shapes_and_packed_init(out_dim, n, S):
    shape, k = rspmm.packed_identity_shape(S, n, out_dim)
    assert (shape, k) == jrs.packed_identity_shape(S, n, out_dim)
    assert rspmm.packing_factor(out_dim) == jrs.packing_factor(out_dim)
    assert rl.composed_table_elems(7, n, out_dim) \
        == jrl.composed_table_elems(7, n, out_dim)

    gen = torch.Generator().manual_seed(0)
    w = tinit.packed_xavier_uniform(shape, (S * n, out_dim), n, out_dim, k,
                                    gen)
    bound = np.sqrt(6.0 / (S * n + out_dim))
    # every padding slot is zero, every real slot inside the bound
    flat = w.reshape(S, shape[1] * k, shape[2] // k)
    assert not flat[:, n:, :].any()
    assert not flat[:, :, out_dim:].any()
    assert float(flat.abs().max()) <= bound
    assert float(flat[:, :n, :out_dim].abs().min()) > 0.0
