"""The port's basis-stream featureless layer against the JAX package's.

Small graphs in the style of tests/test_relational.py (n=57, R=7, E=311,
row_block=16, edge_block=8; n=24 for the Pallas kernels in interpret
mode), made with numpy from a seed and fed to both packages:
``featureless_basis`` forward, ``d_comp`` and ``d_packed`` for packed
(``k == 8``) and unpacked (``k == 1``, the fused scatter+dot backward)
rows and 1, 2 and 4 bases, against the JAX op on its default path and
with ``MRGCN_FUSED_BASIS_BWD=1``. Tolerance 1e-5 relative to the largest
value (f32 sums in different orders). Also: the layer op refuses plain
identity plans, the place-scatter route equals expand + sorted_scatter,
and the R-GCN takes the basis route when the composed table is over
budget.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.models.rgcn import RGCN as JaxRGCN
from mrgcn_tpu.models.rgcn import EdgeBlock as JaxEdgeBlock
from mrgcn_tpu.ops import relational as jrl
from mrgcn_tpu_torch.models.rgcn import RGCN, EdgeBlock
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops import rspmm
from mrgcn_tpu_torch.ops.sorted_stream import sorted_scatter
from mrgcn_tpu_torch.tasks.jax_import import load_jax_params

from tests.test_torch_layers import random_graph


def assert_close(got, want, tol=1e-5):
    """Within ``tol`` of the largest value."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def basis_case(out_dim, B, seed, small=False):
    kw = {"n": 24, "E": 80, "R": 4} if small else {}
    src, dst, rel, norm, n, R = random_graph(seed=seed, **kw)
    rb = 8 if small else 16
    k = rspmm.packing_factor(out_dim)
    args = (src, dst, rel, norm, n, k, k)
    kw = dict(row_block=rb, edge_block=8, kind="identity_basis")
    plans = rl.build_layer_plans(*args, **kw)
    jplans = jrl.build_layer_plans(*args, **kw)
    rng = np.random.default_rng(seed + 1)
    lw = rl.line_width(k, out_dim)
    comp = rng.standard_normal((R, B)).astype(np.float32)
    packed = rng.standard_normal((B, plans.n_in_rows, lw)).astype(np.float32)
    cot = rng.standard_normal((n, out_dim)).astype(np.float32)
    return plans, jplans, comp, packed, cot


def torch_basis(plans, comp, packed, cot, out_dim):
    c = torch.from_numpy(comp).requires_grad_()
    p = torch.from_numpy(packed).requires_grad_()
    out = rl.featureless_basis(c, p, plans, out_dim)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), c.grad.numpy(), p.grad.numpy()


def jax_basis(jplans, comp, packed, cot, out_dim, interpret=False):
    def f(c, p):
        return jrl.featureless_basis(c, p, jplans, out_dim, interpret)
    out, vjp = jax.vjp(f, jnp.asarray(comp), jnp.asarray(packed))
    return (out, *vjp(jnp.asarray(cot)))


@pytest.mark.parametrize("out_dim,B", [(16, 1), (16, 2), (16, 4), (200, 1),
                                       (200, 2), (200, 4), (5, 3)])
def test_featureless_basis_matches_jax(out_dim, B):
    plans, jplans, comp, packed, cot = basis_case(out_dim, B, seed=11)
    got = torch_basis(plans, comp, packed, cot, out_dim)
    want = jax_basis(jplans, comp, packed, cot, out_dim)
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("interpret", [False, True])
def test_featureless_basis_matches_jax_fused_backward(monkeypatch,
                                                      interpret):
    """The JAX op behind MRGCN_FUSED_BASIS_BWD=1 (its fused_scatter_dot,
    XLA path and the Pallas kernel in interpret mode) is the port's only
    ``k == 1`` backward."""
    out_dim = 200
    plans, jplans, comp, packed, cot = basis_case(out_dim, 2, seed=43,
                                                  small=interpret)
    monkeypatch.setenv("MRGCN_FUSED_BASIS_BWD", "1")
    if interpret:
        monkeypatch.setenv("MRGCN_FORCE_PALLAS_GATHER", "1")
    got = torch_basis(plans, comp, packed, cot, out_dim)
    want = jax_basis(jplans, comp, packed, cot, out_dim, interpret)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_featureless_basis_refuses_identity_plans():
    """Identity plans alias bwd_h to fwd: d_packed would be silently
    wrong."""
    src, dst, rel, norm, n, R = random_graph(seed=5)
    plans = rl.build_layer_plans(src, dst, rel, norm, n, 8, 8, row_block=16,
                                 edge_block=8, kind="identity")
    with pytest.raises(ValueError, match="identity_basis plans"):
        rl.featureless_basis(torch.zeros(R, 2),
                             torch.zeros(2, plans.n_in_rows, 128), plans, 16)


@pytest.mark.parametrize("k,d", [(8, 16), (4, 21), (1, 200)])
def test_place_scatter_equals_expand_then_scatter(k, d):
    """``_place_scatter`` through the plain fused_place_scatter gives what
    the earlier route gave: scale, expand to lines, sorted_scatter."""
    src, dst, rel, norm, n, R = random_graph(seed=7)
    plans = rl.build_layer_plans(src, dst, rel, norm, n, k, k, row_block=16,
                                 edge_block=8, kind="identity")
    f = plans.fwd
    L = rl.line_width(k, d)
    V = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (f.num_padded_edges, d + 3)).astype(np.float32))
    got = rl._place_scatter(V, f.out_mod, f, plans.n_out_rows, k, d, L)
    msgs = rl._expand_sub(V[:, :d] * f.norm[:, None], f.out_mod, k)
    want = sorted_scatter(msgs, f.scatter_local, f.scatter_blk,
                          plans.n_out_rows, f.row_block, f.edge_block)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hidden", [(16, 5), (200, 24)])
def test_rgcn_takes_the_basis_route_over_budget(monkeypatch, hidden):
    """With the composed-table budget forced down, both packages run the
    featureless input layer through featureless_basis (``:idb`` plans):
    the same weights give the same outputs and gradients (1e-4: the layers
    above sum in other orders too)."""
    src, dst, rel, norm, n, R = random_graph(seed=23)
    monkeypatch.setattr(jrl, "COMPOSED_TABLE_MAX_ELEMS", 1)
    monkeypatch.setattr(rl, "COMPOSED_TABLE_MAX_ELEMS", 1)
    shapes = [(None, hidden[0]), (hidden[0], hidden[1])]
    kw = dict(row_block=16, edge_block=8, identity_basis=True)
    plans = rl.plans_for_layers(src, dst, rel, norm, n, shapes, **kw)
    jplans = jrl.plans_for_layers(src, dst, rel, norm, n, shapes, **kw)
    assert any(key.endswith(":idb") for key in plans)

    jmodel = JaxRGCN(hidden_dims=hidden, num_relations=R, num_nodes=n,
                     num_bases=3, featureless=True, link_prediction=True)
    jedges = JaxEdgeBlock(src=jnp.asarray(src), dst=jnp.asarray(dst),
                          rel=jnp.asarray(rel), norm=jnp.asarray(norm),
                          num_out=n, plans=jplans)
    params = jmodel.init(jax.random.PRNGKey(0), None, jedges)["params"]
    cot = np.random.default_rng(5).standard_normal(
        (n, hidden[1])).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jmodel.apply({"params": p}, None, jedges),
                        params)
    want_grads = vjp(jnp.asarray(cot))[0]

    model = RGCN(hidden_dims=hidden, num_relations=R, num_nodes=n,
                 generator=torch.Generator().manual_seed(0), num_bases=3,
                 featureless=True, link_prediction=True)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    edges = EdgeBlock(src=torch.from_numpy(src), dst=torch.from_numpy(dst),
                      rel=torch.from_numpy(rel), norm=torch.from_numpy(norm),
                      num_out=n, plans=plans)
    got = model(None, edges)
    got.backward(torch.from_numpy(cot))
    assert_close(got.detach().numpy(), want, 1e-4)
    assert (got >= 0).all()                       # LP: ReLU on every layer
    weight_i = "weight_i" if hidden[0] > 64 else "weight_i_packed"
    assert set(dict(model.named_parameters())) == {
        "relations", "layer_0.comp_i", f"layer_0.{weight_i}",
        "layer_1.comp_f", "layer_1.weight_f"}
    for name, p in model.named_parameters():
        if name == "relations":
            assert p.grad is None                 # not used by the forward
            continue
        layer, leaf = name.split(".")
        assert_close(p.grad.numpy(), want_grads[layer][leaf], 1e-4)
