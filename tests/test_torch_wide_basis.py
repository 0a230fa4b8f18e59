"""The port's wide-line basis engine against the JAX package's.

Small graphs in the style of tests/test_relational.py (n=57, R=7, E=311,
row_block=16, edge_block=8), made with numpy from a seed and fed to both
packages, the JAX functions on their default path:

* ``stream_basis_aggregate`` on the combined ``(rows, B*L)`` table of
  the packed identity weight against JAX's ``featureless_basis_wide``, at
  out 16 (k = 8) and 200 (k = 1), 2 and 3 bases: forward, ``d_comp`` and
  ``d_packed``;
* ``dense_basis`` at in = out = 200, 2 bases, against JAX's
  ``dense_basis`` and against JAX's relation-grouped layer
  (``rspmm.transform_aggregate_grouped``, the route it replaces): forward,
  ``d_H``, ``d_basis`` and ``d_comp``;

each within 1e-5 of the largest value (f32 sums in other orders). The ops
refuse plans without a real dst-sorted ``bwd_h`` stream and
``dense_basis`` packed input rows. At the model level, an LP-shaped R-GCN
(hidden 200 x 200, 2 bases, 40 relations over few row blocks so that the
dense plan has no relation-constant slabs, the composed-table budget
forced down so that layer 0 takes the basis stream) runs layer 1 on
``dense_basis`` and never on the grouped path, and gives the JAX model's
output and gradients from the same parameters within 1e-4 of the largest
value (the layers sum in other orders) under every value of the JAX
package's ``MRGCN_WIDE_BASIS`` and ``MRGCN_DENSE_BASIS``, each of which
takes the route it names there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.encodings.structure import group_by_relation as jax_groups
from mrgcn_tpu.models.rgcn import RGCN as JaxRGCN
from mrgcn_tpu.models.rgcn import EdgeBlock as JaxEdgeBlock
from mrgcn_tpu.ops import relational as jrl
from mrgcn_tpu.ops import rspmm as jrs
from mrgcn_tpu_torch.encodings.structure import group_by_relation
from mrgcn_tpu_torch.models.rgcn import RGCN, EdgeBlock
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops import rspmm
from mrgcn_tpu_torch.tasks.jax_import import load_jax_params

from tests.test_torch_basis import assert_close, basis_case
from tests.test_torch_layers import random_graph

ROUTES = ("featureless_basis", "dense_basis")
JAX_ROUTES = ROUTES + ("featureless_basis_wide", "dense_basis_hybrid")


def t(a):
    return torch.from_numpy(np.asarray(a))


def torch_op(fn, arrays, cot):
    xs = [t(a).requires_grad_() for a in arrays]
    out = fn(*xs)
    out.backward(t(cot))
    return [out.detach().numpy()] + [x.grad.numpy() for x in xs]


def jax_op(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return [out] + list(vjp(jnp.asarray(cot)))


def combined(packed):
    """``(B, rows, L) -> (rows, B*L)``: the per-basis planes side by
    side, JAX's ``combine_planes``."""
    B, rows, L = packed.shape
    return packed.transpose(0, 1).reshape(rows, B * L)


@pytest.mark.parametrize("out_dim,B", [(16, 2), (16, 3), (200, 2),
                                       (200, 3)])
def test_stream_basis_aggregate_matches_jax(out_dim, B):
    plans, jplans, comp, packed, cot = basis_case(out_dim, B, seed=17)
    got = torch_op(lambda c, p: rl.stream_basis_aggregate(
        c, combined(p), plans, out_dim), (comp, packed), cot)
    want = jax_op(lambda c, p: jrl.featureless_basis_wide(c, p, jplans,
                                                          out_dim),
                  (comp, packed), cot)
    for g, w in zip(got, want):
        assert_close(g, w)


def dense_case(seed, B=2, in_dim=200, out_dim=200):
    src, dst, rel, norm, n, R = random_graph(seed=seed)
    args = (src, dst, rel, norm, n, 1, 1)
    kw = dict(row_block=16, edge_block=8, kind="dense")
    plans = rl.build_layer_plans(*args, **kw)
    jplans = jrl.build_layer_plans(*args, **kw)
    rng = np.random.default_rng(seed + 1)
    H = rng.standard_normal((n, in_dim)).astype(np.float32)
    basis = rng.standard_normal((B, in_dim, out_dim)).astype(np.float32)
    comp = rng.standard_normal((R, B)).astype(np.float32)
    cot = rng.standard_normal((n, out_dim)).astype(np.float32)
    return (src, dst, rel, norm, n), plans, jplans, (H, basis, comp), cot


def test_dense_basis_matches_jax():
    _, plans, jplans, arrays, cot = dense_case(seed=19)
    got = torch_op(lambda h, b, c: rl.dense_basis(h, b, c, plans, 200, 200),
                   arrays, cot)
    want = jax_op(lambda h, b, c: jrl.dense_basis(h, b, c, jplans, 200,
                                                  200), arrays, cot)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_dense_basis_matches_the_grouped_path():
    """The port's route for a wide basis layer against the JAX package's
    default route for it, the relation-grouped layer."""
    (src, dst, rel, norm, n), plans, _, arrays, cot = dense_case(seed=41)
    jg = jax_groups(src, dst, rel, norm, n, group_size=8)
    got = torch_op(lambda h, b, c: rl.dense_basis(h, b, c, plans, 200,
                                                  200), arrays, cot)
    want = jax_op(lambda h, b, c: jrs.transform_aggregate_grouped(
        h, jnp.asarray(jg.src), jnp.asarray(jg.dst), jnp.asarray(jg.norm),
        jnp.asarray(jg.group_rel), jg.group_size, n, b, comp=c), arrays,
        cot)
    for g_, w in zip(got, want):
        assert_close(g_, w)


def test_the_wide_ops_refuse_plans_they_cannot_differentiate():
    src, dst, rel, norm, n, R = random_graph(seed=5)
    kw = dict(row_block=16, edge_block=8)
    identity = rl.build_layer_plans(src, dst, rel, norm, n, 1, 1,
                                    kind="identity", **kw)
    with pytest.raises(ValueError, match="real dst-sorted bwd_h"):
        rl.stream_basis_aggregate(torch.zeros(R, 2),
                                  torch.zeros(identity.n_in_rows, 512),
                                  identity, 200)
    with pytest.raises(ValueError, match="real dst-sorted bwd_h"):
        rl.dense_basis(torch.zeros(n, 200), torch.zeros(2, 200, 200),
                       torch.zeros(R, 2), identity, 200, 200)
    packed_in = rl.build_layer_plans(src, dst, rel, norm, n, 8, 1,
                                     kind="dense", **kw)
    with pytest.raises(ValueError, match="k_in must be 1"):
        rl.dense_basis(torch.zeros(n, 16), torch.zeros(2, 16, 200),
                       torch.zeros(R, 2), packed_in, 16, 200)


# --------------------------------------------------------------------------
# the model's route, against the JAX model under each of its switches
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lp_shaped():
    """Both packages' LP-shaped R-GCN, edges and the JAX parameters: many
    relations over few row blocks, so the dense plan's composite (block,
    relation) split would pad far past the plain layout and is rejected,
    as on FB15k-237."""
    src, dst, rel, norm, n, R = random_graph(seed=37, R=40, E=500)
    shapes = [(None, 200), (200, 200)]
    kw = dict(row_block=16, edge_block=8, identity_basis=True)
    plans = rl.plans_for_layers(src, dst, rel, norm, n, shapes, **kw)
    jplans = jrl.plans_for_layers(src, dst, rel, norm, n, shapes, **kw)
    assert not plans["1:1"].fwd.rel_const and "1:1:idb" in plans
    g = group_by_relation(src, dst, rel, norm, n, group_size=8)
    jg = jax_groups(src, dst, rel, norm, n, group_size=8)
    edges = EdgeBlock(src=t(src), dst=t(dst), rel=t(rel), norm=t(norm),
                      num_out=n, plans=plans, grp_src=t(g.src),
                      grp_dst=t(g.dst), grp_norm=t(g.norm),
                      group_rel=t(g.group_rel), group_size=g.group_size)
    jedges = JaxEdgeBlock(src=jnp.asarray(src), dst=jnp.asarray(dst),
                          rel=jnp.asarray(rel), norm=jnp.asarray(norm),
                          num_out=n, plans=jplans,
                          grp_src=jnp.asarray(jg.src),
                          grp_dst=jnp.asarray(jg.dst),
                          grp_norm=jnp.asarray(jg.norm),
                          group_rel=jnp.asarray(jg.group_rel),
                          group_size=jg.group_size)
    kw = dict(num_relations=R, num_nodes=n, num_bases=2, featureless=True,
              link_prediction=True)
    jmodel = JaxRGCN(hidden_dims=(200, 200), **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrl, "COMPOSED_TABLE_MAX_ELEMS", 1)
        params = jmodel.init(jax.random.PRNGKey(0), None, jedges)["params"]
    model = RGCN(hidden_dims=(200, 200),
                 generator=torch.Generator().manual_seed(0), **kw)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    cot = np.random.default_rng(8).standard_normal((n, 200)).astype(
        np.float32)
    return model, edges, jmodel, jedges, params, cot


def spy_routes(monkeypatch, module, names, seen):
    for name in names:
        fn = getattr(module, name)

        def spy(*args, fn=fn, name=name, **kwargs):
            seen.append(name)
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("wide,dense,jax_routes", [
    ("0", "0", {"featureless_basis"}),
    ("0", "1", {"featureless_basis", "dense_basis"}),
    # the hybrid's forward is dense_basis
    ("0", "hybrid", {"featureless_basis", "dense_basis_hybrid",
                     "dense_basis"}),
    ("1", "0", {"featureless_basis_wide"}),
    ("1", "1", {"featureless_basis_wide", "dense_basis"})])
def test_model_matches_jax_under_each_of_its_switches(
        lp_shaped, monkeypatch, wide, dense, jax_routes):
    model, edges, jmodel, jedges, params, cot = lp_shaped
    monkeypatch.setenv("MRGCN_WIDE_BASIS", wide)
    monkeypatch.setenv("MRGCN_DENSE_BASIS", dense)
    monkeypatch.setattr(jrl, "COMPOSED_TABLE_MAX_ELEMS", 1)
    monkeypatch.setattr(rl, "COMPOSED_TABLE_MAX_ELEMS", 1)
    seen, jseen = [], []
    spy_routes(monkeypatch, rl, ROUTES, seen)
    spy_routes(monkeypatch, rspmm, ("transform_aggregate_grouped",), seen)
    spy_routes(monkeypatch, jrl, JAX_ROUTES, jseen)

    want, vjp = jax.vjp(lambda p: jmodel.apply({"params": p}, None,
                                               jedges), params)
    want_grads = vjp(jnp.asarray(cot))[0]
    model.zero_grad()
    got = model(None, edges)
    got.backward(t(cot))
    # the port reads neither switch
    assert set(seen) == {"featureless_basis", "dense_basis"}
    assert set(jseen) == jax_routes
    assert_close(got.detach().numpy(), want, 1e-4)
    for name, p in model.named_parameters():
        if name == "relations":
            continue
        layer, leaf = name.split(".")
        assert_close(p.grad.numpy(), want_grads[layer][leaf], 1e-4)
