"""The identity compose's one route in the port against the JAX package.

``rspmm.compose_packed`` (forward :func:`compose_table`, backward
:func:`compose_grad_pass` where both gradients are needed; on the CPU their
plain versions) against ``mrgcn_tpu.ops.rspmm.compose_packed`` and its VJP,
on DMG's relation and basis counts, ragged R, B, rows and line widths, and a
row-strided ``packed`` cut as ``models/rgcn._fit_rows`` cuts the parameter.
Then the R-GCN whose input layer is the planned identity layer, packed
(``k == 8``) and wide (``k == 1``) tables: output, loss and every gradient
against the JAX model with its ``MRGCN_FUSED_COMPOSE_BWD`` at 0 and at 1
(the JAX package's two routes), and the port's bits with that variable set
and unset (the port reads it nowhere).

Inputs come from numpy generators with fixed seeds. Tolerances: outputs and
``d_packed`` within 1e-5 of the largest value; ``d_comp``, a sum of
``rows * L`` products an entry, within 1e-5 of the sum of its terms'
absolute values (f32 sums taken in other orders); the R-GCN, whose layer
above sums in other orders too, within 1e-4 of the largest value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.models.rgcn import RGCN as JaxRGCN
from mrgcn_tpu.models.rgcn import EdgeBlock as JaxEdgeBlock
from mrgcn_tpu.ops import relational as jrl
from mrgcn_tpu.ops import rspmm as jrs
from mrgcn_tpu_torch.models.rgcn import RGCN, EdgeBlock
from mrgcn_tpu_torch.ops import compose_kernels as ck
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops import rspmm
from mrgcn_tpu_torch.ops import sorted_stream as ss
from mrgcn_tpu_torch.tasks.jax_import import load_jax_params

from tests.test_torch_basis import assert_close
from tests.test_torch_layers import random_graph


@pytest.mark.parametrize("R,B,rows,L,param_rows", [
    (121, 40, 16, 128, 16),      # DMG's relations and bases
    (5, 3, 8, 128, 8),
    (475, 2, 40, 256, 40),       # FB15k-237's relations, two bases
    (33, 17, 72, 36, 72),
    (7, 4, 24, 20, 24),          # lines 20 wide
    (6, 3, 24, 128, 40)])        # a row slice of a 40-row parameter
def test_compose_packed_matches_jax_vjp(R, B, rows, L, param_rows):
    rng = np.random.default_rng(R * rows + L)
    comp = rng.standard_normal((R, B)).astype(np.float32)
    param = rng.standard_normal((B, param_rows, L)).astype(np.float32)
    param[:, rows:] = 0.0
    cot = rng.standard_normal((R, rows, L)).astype(np.float32)
    packed = param[:, :rows]

    want, vjp = jax.vjp(jrs.compose_packed, jnp.asarray(comp),
                        jnp.asarray(packed))
    want_dc, want_dp = vjp(jnp.asarray(cot))

    c = torch.tensor(comp, requires_grad=True)
    p = torch.tensor(param, requires_grad=True)
    pk = p[:, :rows, :]
    assert pk.is_contiguous() == (rows == param_rows)
    got = rspmm.compose_packed(c, pk)
    assert got.shape == (R, rows, L)
    got.backward(torch.from_numpy(cot))

    assert_close(got.detach().numpy(), want)
    assert_close(p.grad[:, :rows].numpy(), want_dp)
    assert not p.grad[:, rows:].any()
    d = cot.reshape(R, -1).astype(np.float64)
    q = packed.reshape(B, -1).astype(np.float64)
    scale = np.abs(d) @ np.abs(q).T
    assert (np.abs(c.grad.numpy() - np.asarray(want_dc))
            <= 1e-5 * scale).all()
    assert (np.abs(c.grad.numpy() - d @ q.T) <= 1e-5 * scale).all()


def test_row_strided_packed_is_taken_without_a_copy():
    """The wrappers see a row slice of the parameter as ``(B, rows * L)``
    rows ``param_rows * L`` apart: a view, which the kernels take by its
    stride; the plain versions give what a contiguous copy gives."""
    rng = np.random.default_rng(3)
    R, B, rows, L = 4, 3, 12, 16
    param = torch.from_numpy(rng.standard_normal((B, 20, L))
                             .astype(np.float32))
    pk = param[:, :rows]
    view = ss._packed_rows(pk, B)
    assert view.data_ptr() == param.data_ptr()
    assert view.shape == (B, rows * L) and view.stride() == (20 * L, 1)
    comp = torch.from_numpy(rng.standard_normal((R, B)).astype(np.float32))
    d_t = torch.from_numpy(rng.standard_normal((R * rows, L))
                           .astype(np.float32))
    for got, want in zip(ss.compose_grad_pass(d_t, pk, comp, R, B),
                         ss.compose_grad_pass(d_t, pk.contiguous()
                                              .reshape(-1, L), comp, R, B)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ck.compose_table(comp, view),
                               comp @ pk.reshape(B, -1),
                               rtol=1e-6, atol=1e-6)


def test_compose_grad_pass_rejects_a_3d_packed_that_does_not_fit():
    d_t = torch.zeros(4 * 8, 16)
    comp = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="do not fit"):
        ss.compose_grad_pass(d_t, torch.zeros(3, 7, 16), comp, 4, 3)
    with pytest.raises(ValueError, match="do not fit"):
        ss.compose_grad_pass(d_t, torch.zeros(3 * 8, 16).reshape(8, 3, 16),
                             comp, 4, 3)


def rgcn_case(hidden, num_bases, seed=31):
    """Both packages' R-GCN on one small graph with plans, the JAX model's
    initial parameters loaded into the port, and a cotangent."""
    src, dst, rel, norm, n, R = random_graph(seed=seed)
    shapes = [(None, hidden[0]), (hidden[0], hidden[1])]
    kw = dict(row_block=16, edge_block=8)
    plans = rl.plans_for_layers(src, dst, rel, norm, n, shapes, **kw)
    jplans = jrl.plans_for_layers(src, dst, rel, norm, n, shapes, **kw)
    cot = np.random.default_rng(seed + 1).standard_normal(
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

    def port():
        model = RGCN(hidden_dims=hidden, num_relations=R, num_nodes=n,
                     generator=torch.Generator().manual_seed(0),
                     num_bases=num_bases, featureless=True)
        load_jax_params(model, jax.tree.map(np.asarray, params))
        out = model(None, edges)
        loss = (out * torch.from_numpy(cot)).sum()
        loss.backward()
        return (out.detach().numpy(), loss.item(),
                {name: p.grad.numpy() for name, p in model.named_parameters()})

    return port, jmodel, jedges, params, cot


# hidden widths 16 (k == 8: packed lines) and 200 (k == 1: wide lines)
TABLES = [((16, 5), 3), ((200, 6), 2)]


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("hidden,num_bases", TABLES)
def test_rgcn_identity_layer_matches_jax_on_either_jax_route(
        monkeypatch, hidden, num_bases, fused):
    port, jmodel, jedges, params, cot = rgcn_case(hidden, num_bases)
    out, loss, grads = port()
    assert {"layer_0.comp_i"} <= set(grads)

    monkeypatch.setenv("MRGCN_FUSED_COMPOSE_BWD", fused)

    def f(p):
        o = jmodel.apply({"params": p}, None, jedges)
        return (o * jnp.asarray(cot)).sum(), o

    (want_loss, want_out), want_grads = jax.value_and_grad(
        f, has_aux=True)(params)
    assert_close(out, want_out, 1e-4)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-4)
    for name, g in grads.items():
        layer, leaf = name.split(".")
        assert_close(g, want_grads[layer][leaf], 1e-4)


@pytest.mark.parametrize("hidden,num_bases", TABLES)
def test_port_ignores_the_fused_compose_switch(monkeypatch, hidden,
                                               num_bases):
    port = rgcn_case(hidden, num_bases)[0]
    monkeypatch.delenv("MRGCN_FUSED_COMPOSE_BWD", raising=False)
    out_a, loss_a, grads_a = port()
    monkeypatch.setenv("MRGCN_FUSED_COMPOSE_BWD", "1")
    out_b, loss_b, grads_b = port()
    np.testing.assert_array_equal(out_a, out_b)
    assert loss_a == loss_b
    for name, g in grads_a.items():
        np.testing.assert_array_equal(g, grads_b[name])
