"""The port's fused compose backward against the JAX package's.

``compose_grad_pass``'s plain version against
``mrgcn_tpu.ops.pallas_gather.compose_grad_pass`` (its XLA branch and the
Pallas kernel in interpret mode) on ragged R, B and rows, ``rows % 8 != 0``
included (the JAX function takes its plain contractions there);
``featureless_composed`` (output, ``d_comp``, ``d_packed``) against the JAX
op as tests/test_relational.py runs it, packed (``k == 8``) and wide
(``k == 1``) tables; the R-GCN with ``MRGCN_FUSED_COMPOSE_BWD=1`` against
its default route and against the JAX model on the same route. Inputs come
from numpy generators with fixed seeds. Tolerance: 1e-5 of the largest
value (f32 sums taken in other orders). The two compose micro-kernels'
plain versions are held against numpy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.models.rgcn import RGCN as JaxRGCN
from mrgcn_tpu.models.rgcn import EdgeBlock as JaxEdgeBlock
from mrgcn_tpu.ops import pallas_gather as jpg
from mrgcn_tpu.ops import relational as jrl
from mrgcn_tpu_torch.models.rgcn import RGCN, EdgeBlock
from mrgcn_tpu_torch.ops import compose_kernels as ck
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops import rspmm
from mrgcn_tpu_torch.ops import sorted_stream as ss
from mrgcn_tpu_torch.tasks.jax_import import load_jax_params

from tests.test_torch_basis import assert_close
from tests.test_torch_layers import random_graph


def grad_case(R, B, rows, L, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R * rows, L)).astype(np.float32),
            rng.standard_normal((B * rows, L)).astype(np.float32),
            rng.standard_normal((R, B)).astype(np.float32))


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("R,B,rows,L", [(5, 3, 8, 128), (7, 4, 24, 128),
                                        (3, 2, 16, 256), (4, 3, 12, 128),
                                        (6, 1, 40, 128)])
def test_compose_grad_pass_matches_jax(R, B, rows, L, interpret):
    """rows 12 is no multiple of 8: the JAX function takes its plain
    contractions there, whatever ``interpret`` says."""
    d_t, packed, comp = grad_case(R, B, rows, L, seed=R + rows)
    want = jpg.compose_grad_pass(jnp.asarray(d_t), jnp.asarray(packed),
                                 jnp.asarray(comp), R, B,
                                 interpret=interpret)
    args = (torch.from_numpy(d_t), torch.from_numpy(packed),
            torch.from_numpy(comp), R, B)
    for got in (ss.compose_grad_pass(*args),
                ss.compose_grad_pass_reference(*args)):
        assert got[0].shape == (R, B) and got[1].shape == (B * rows, L)
        for g, w in zip(got, want):
            assert_close(g.numpy(), w)
    # the einsums of the docstring, in f64
    d3, p3 = (a.astype(np.float64).reshape(-1, rows, L)
              for a in (d_t, packed))
    assert_close(got[0].numpy(), np.einsum("rql,bql->rb", d3, p3))
    assert_close(got[1].numpy().reshape(B, rows, L),
                 np.einsum("rb,rql->bql", comp.astype(np.float64), d3))


def test_compose_grad_pass_counts_no_launch_on_the_cpu():
    before = ss.compose_grad_pass.launches
    d_t, packed, comp = (torch.from_numpy(a) for a in grad_case(3, 2, 8, 128))
    ss.compose_grad_pass(d_t, packed, comp, 3, 2)
    assert ss.compose_grad_pass.launches == before


@pytest.mark.parametrize("bad", ["comp", "packed", "rows", "R"])
def test_compose_grad_pass_rejects_shapes_that_do_not_fit(bad):
    d_t, packed, comp = (torch.from_numpy(a) for a in grad_case(3, 2, 8, 128))
    R = 3
    if bad == "comp":
        comp = comp.T.contiguous()
    elif bad == "packed":
        packed = packed[:-1]
    elif bad == "rows":
        d_t = d_t[:-1]
    else:
        R = 0
    with pytest.raises(ValueError, match="do not fit"):
        ss.compose_grad_pass(d_t, packed, comp, R, 2)


def composed_case(out_dim, B, seed, small):
    kw = {"n": 24, "E": 80, "R": 4} if small else {}
    src, dst, rel, norm, n, R = random_graph(seed=seed, **kw)
    k = rspmm.packing_factor(out_dim)
    args = (src, dst, rel, norm, n, k, k)
    kw = dict(row_block=8 if small else 16, edge_block=8)
    plans = rl.build_layer_plans(*args, **kw)
    jplans = jrl.build_layer_plans(*args, **kw)
    rng = np.random.default_rng(seed + 1)
    lw = rl.line_width(k, out_dim)
    comp = rng.standard_normal((R, B)).astype(np.float32)
    packed = rng.standard_normal((B, plans.n_in_rows, lw)).astype(np.float32)
    cot = rng.standard_normal((n, out_dim)).astype(np.float32)
    return plans, jplans, comp, packed, cot


def torch_composed(fn, plans, comp, packed, cot, out_dim):
    c = torch.from_numpy(comp).requires_grad_()
    p = torch.from_numpy(packed).requires_grad_()
    out = fn(c, p, plans, out_dim)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), c.grad.numpy(), p.grad.numpy()


def chain(comp, packed, plans, out_dim):
    """The unfused route: compose, then aggregate."""
    flat = rspmm.compose_packed(comp, packed)
    return rl.featureless_aggregate(flat.reshape(-1, packed.shape[2]), plans,
                                    out_dim)


@pytest.mark.parametrize("interpret,out_dim,B", [(False, 16, 3),
                                                 (False, 200, 3),
                                                 (False, 5, 1),
                                                 (False, 16, 7),
                                                 (True, 16, 3)])
def test_featureless_composed_matches_jax(monkeypatch, interpret, out_dim,
                                          B):
    """Against the JAX op (XLA fallback, and its Pallas kernels in
    interpret mode on the small graph) and against the port's own unfused
    chain."""
    plans, jplans, comp, packed, cot = composed_case(out_dim, B, seed=5,
                                                     small=interpret)
    got = torch_composed(rl.featureless_composed, plans, comp, packed, cot,
                         out_dim)
    unfused = torch_composed(chain, plans, comp, packed, cot, out_dim)
    if interpret:
        monkeypatch.setenv("MRGCN_FORCE_PALLAS_GATHER", "1")

    def f(c, p):
        return jrl.featureless_composed(c, p, jplans, out_dim, interpret)
    out, vjp = jax.vjp(f, jnp.asarray(comp), jnp.asarray(packed))
    want = (out, *vjp(jnp.asarray(cot)))
    for g, u, w in zip(got, unfused, want):
        assert_close(g, w)
        assert_close(g, u)


@pytest.mark.parametrize("hidden,num_bases", [((16, 5), 3), ((200, 6), 2),
                                              ((16, 5), 0)])
def test_rgcn_fused_compose_backward_matches_default_and_jax(monkeypatch,
                                                             hidden,
                                                             num_bases):
    """``MRGCN_FUSED_COMPOSE_BWD=1`` changes the backward's route and
    nothing else: outputs and every gradient equal the default route's to
    1e-5 and the JAX model's on the same route to 1e-4 (the layers above
    sum in other orders too). Without bases there is no compose and the
    switch changes nothing."""
    src, dst, rel, norm, n, R = random_graph(seed=31)
    shapes = [(None, hidden[0]), (hidden[0], hidden[1])]
    kw = dict(row_block=16, edge_block=8)
    plans = rl.plans_for_layers(src, dst, rel, norm, n, shapes, **kw)
    jplans = jrl.plans_for_layers(src, dst, rel, norm, n, shapes, **kw)
    cot = np.random.default_rng(6).standard_normal(
        (n, hidden[1])).astype(np.float32)

    jmodel = JaxRGCN(hidden_dims=hidden, num_relations=R, num_nodes=n,
                     num_bases=num_bases, featureless=True)
    jedges = JaxEdgeBlock(src=jnp.asarray(src), dst=jnp.asarray(dst),
                          rel=jnp.asarray(rel), norm=jnp.asarray(norm),
                          num_out=n, plans=jplans)
    params = jmodel.init(jax.random.PRNGKey(0), None, jedges)["params"]
    edges = EdgeBlock(src=torch.from_numpy(src), dst=torch.from_numpy(dst),
                      rel=torch.from_numpy(rel), norm=torch.from_numpy(norm),
                      num_out=n, plans=plans)

    def run(fused):
        monkeypatch.setenv("MRGCN_FUSED_COMPOSE_BWD", "1" if fused else "0")
        model = RGCN(hidden_dims=hidden, num_relations=R, num_nodes=n,
                     generator=torch.Generator().manual_seed(0),
                     num_bases=num_bases, featureless=True)
        load_jax_params(model, jax.tree.map(np.asarray, params))
        calls = []
        monkeypatch.setattr(rl, "featureless_composed",
                            lambda *a: calls.append(1)
                            or kept(*a))
        out = model(None, edges)
        out.backward(torch.from_numpy(cot))
        assert bool(calls) == (fused and num_bases > 0)
        return out.detach().numpy(), {name: p.grad.numpy() for name, p
                                      in model.named_parameters()}

    kept = rl.featureless_composed
    out_d, grads_d = run(False)
    out_f, grads_f = run(True)
    assert_close(out_f, out_d)
    for name in grads_d:
        assert_close(grads_f[name], grads_d[name])

    want, vjp = jax.vjp(lambda p: jmodel.apply({"params": p}, None, jedges),
                        params)
    want_grads = vjp(jnp.asarray(cot))[0]
    assert_close(out_f, want, 1e-4)
    for name, g in grads_f.items():
        layer, leaf = name.split(".")
        assert_close(g, want_grads[layer][leaf], 1e-4)


@pytest.mark.parametrize("R,B,cols", [(5, 3, 1024), (121, 40, 256),
                                      (475, 2, 36), (1, 1, 4)])
def test_compose_table_plain_version_matches_numpy(R, B, cols):
    rng = np.random.default_rng(R + cols)
    comp = rng.standard_normal((R, B)).astype(np.float32)
    pk = rng.standard_normal((B, cols)).astype(np.float32)
    want = comp.astype(np.float64) @ pk.astype(np.float64)
    before = ck.compose_table.launches
    for fn in (ck.compose_table, ck.compose_table_reference):
        got = fn(torch.from_numpy(comp), torch.from_numpy(pk))
        assert got.shape == (R, cols) and got.dtype == torch.float32
        assert_close(got.numpy(), want)
    assert ck.compose_table.launches == before
    # relation-major: the reshape to the (R * rows, L) table is free
    packed = pk.reshape(B, -1, 4)
    table = rspmm.compose_packed(torch.from_numpy(comp),
                                 torch.from_numpy(packed))
    assert_close(got.numpy().reshape(table.shape), table.numpy())


def test_compose_table_rejects_shapes_that_do_not_multiply():
    with pytest.raises(ValueError, match="do not multiply"):
        ck.compose_table(torch.zeros(3, 2), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="do not multiply"):
        ck.compose_table(torch.zeros(0, 2), torch.zeros(2, 8))


@pytest.mark.parametrize("shape", [(41, 3), (16, 128), (0, 128), (7,)])
def test_canonical_copy_plain_version_matches_numpy(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    before = ck.canonical_copy.launches
    for fn in (ck.canonical_copy, ck.canonical_copy_reference):
        t = torch.from_numpy(x)
        got = fn(t)
        assert got.data_ptr() != t.data_ptr() or x.size == 0
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), x)
    assert ck.canonical_copy.launches == before
