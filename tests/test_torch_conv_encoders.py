"""The port's convolutional encoders against the JAX package's.

``TCNN`` (WKT geometries; sizes S / M / L, each at its minimal length) and
``ImageCNN`` (``sep`` and ``dense`` blocks; an even and an odd image side,
where XLA's ``SAME`` padding at stride 2 differs from torch's symmetric
``padding=1``) get the same inputs, made with numpy from a seed, and the
JAX module's ``init`` carried into the port by the weight bridge
(``tasks/jax_import``: parameters and the BatchNorm ``batch_stats`` both).
Compared on the CPU, in eval mode (the running statistics normalize; they
are set to random values first, so the test sees them used) and in train
mode (the batch's statistics normalize and the buffers move):

* ``TCNN`` in f32: outputs and parameter gradients within 1e-5 of their
  largest entry; train mode at eight rows (the batch statistics of the
  last layer are taken over the rows alone: at two rows they amplify f32
  rounding to 1e-3). A ReLU input within rounding of zero can fall on
  different sides in the two packages (at eight rows it did in one of six
  seeds at sizes M and L, the gradients then 1e-2 apart): the test counts
  the pre-ReLU signs that differ, and where any does it holds the
  gradients by norm, 1e-2, instead;
* ``ImageCNN`` on eight images, each of its own contrast and brightness:
  its bf16 body (the model's) in eval mode, outputs within 1e-2 and
  gradients within 1e-1 of their largest entry, the text encoder's bf16
  bounds (measured: 1e-7, both packages round alike); the same network
  in f32 (``dtype``, a field of both modules) in train mode, outputs and
  gradients within 1e-5 (measured: 4.6e-6). The bf16 body in train mode
  is held by its running statistics alone, within 1e-2 (measured:
  2.7e-3): the two packages take the batch statistics in f32 sums of
  other orders, a few normalized values then round to the other bf16
  neighbour, and fifteen BatchNorms over eight images amplify those steps
  to 1e-2 in the outputs and 0.05-0.3 by norm in the gradients, as they
  would between any two bf16 implementations;
* the updated running statistics after a train-mode call equal the JAX
  package's ``batch_stats`` to 1e-5 of their largest entry (f32 in both);
* ``BatchNorm`` alone against flax's, f32 and bf16, including one value
  per channel (torch refuses batch statistics there; flax normalizes it to
  the bias); ``same_padding`` against ``lax.padtype_to_pads``;
  ``adaptive_max_pool1d`` exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from mrgcn_tpu.models import encoders as jenc
from mrgcn_tpu_torch.models import encoders as enc
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              params_to_state_dict,
                                              state_dict_to_batch_stats,
                                              state_dict_to_params)

GEN = torch.Generator().manual_seed(0)


def jax_variables(module, x, seed=0):
    variables = module.init(jax.random.PRNGKey(seed), x)
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"]}


def randomize_stats(variables, rng):
    """Running statistics away from their 0 / 1 init, so eval mode shows
    whether they are used."""
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(
            rng.uniform(0.5, 2.0, a.shape) if path[-1].key == "var"
            else rng.standard_normal(a.shape) * 0.1, np.float32),
        variables["batch_stats"])
    return {**variables, "batch_stats": jax.tree.map(jnp.asarray, stats)}


def pre_relu_signs_jax(module, variables, x, train):
    """Each BatchNorm's output > 0, by the port's module path (NC..., the
    port's layout)."""
    _, state = module.apply(
        variables, x, train=train, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.BatchNorm))
    out = {}
    for path, val in jax.tree_util.tree_leaves_with_path(
            state["intermediates"]):
        keys = [p.key for p in path if hasattr(p, "key")][:-1]
        a = np.asarray(val.astype(jnp.float32))
        out[".".join(keys)] = np.moveaxis(a, -1, 1) > 0
    return out


def run_both(jmod, tmod, variables, x_np, jx, cot, train):
    """Outputs, parameter gradients (of ``sum(out * cot)``) and the updated
    batch stats of both packages."""
    def loss(params):
        out, upd = jmod.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              jx, train=train, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * cot), (out, upd)

    (_, (want, upd)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    signs = {}
    hooks = [m.register_forward_hook(
        lambda mod, _, o, name=name: signs.__setitem__(
            name, o.detach().float().numpy() > 0))
        for name, m in tmod.named_modules() if isinstance(m, enc.BatchNorm)]
    tmod.zero_grad()
    got = tmod(torch.from_numpy(x_np), train=train)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    for h in hooks:
        h.remove()
    return (got, np.asarray(want.astype(jnp.float32)), upd["batch_stats"],
            params_to_state_dict(grads), signs)


def max_rel(got, want):
    return float(np.abs(np.asarray(got, np.float32) - want).max()) \
        / max(float(np.abs(want).max()), 1e-30)


def assert_grads(tmod, want, bound, by_norm=False):
    got = {n: p.grad.float().numpy() for n, p in tmod.named_parameters()}
    assert sorted(got) == sorted(want)
    if by_norm:
        num = sum(float(((got[k] - want[k].numpy()) ** 2).sum()) for k in got)
        den = sum(float((want[k].numpy() ** 2).sum()) for k in got)
        assert (num / den) ** 0.5 <= bound
        return
    scale = max(float(w.abs().max()) for w in want.values())
    err = max(float(np.abs(got[k] - want[k].numpy()).max()) for k in got)
    assert err <= bound * scale, (err, scale)


def assert_stats(tmod, upd, bound=1e-5):
    want = params_to_state_dict(upd)
    got = state_dict_to_batch_stats(tmod.state_dict())
    got = params_to_state_dict(got)
    assert sorted(got) == sorted(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= bound * scale, k


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size,rows", [("S", 8), ("M", 8), ("L", 8)])
def test_tcnn_matches_jax(size, rows, train):
    rng = np.random.default_rng(0)
    length = enc.TCNN_MINIMAL_LENGTH[size]
    x = rng.standard_normal((rows, 9, length)).astype(np.float32)
    jx = jnp.asarray(x.transpose(0, 2, 1))          # the JAX package's NLC
    jmod = jenc.TCNN(output_dim=5, size=size)
    variables = randomize_stats(jax_variables(jmod, jx), rng)
    tmod = enc.TCNN(9, 5, GEN, size=size)
    load_jax_params(tmod, variables["params"], variables["batch_stats"])
    cot = rng.standard_normal((rows, 5)).astype(np.float32)

    got, want, upd, grads, signs = run_both(jmod, tmod, variables, x, jx,
                                            cot, train)
    flips = sum(int((signs[k] != s).sum()) for k, s in
                pre_relu_signs_jax(jmod, variables, jx, train).items())
    assert got.shape == (rows, 5)
    assert max_rel(got.detach().numpy(), want) <= 1e-5
    assert_grads(tmod, grads, 1e-2 if flips else 1e-5, by_norm=bool(flips))
    if train:
        assert_stats(tmod, upd)
    else:   # the running statistics normalized and stayed
        assert_stats(tmod, variables["batch_stats"], bound=0.0)


@pytest.mark.parametrize("mode", ["bf16_eval", "bf16_train", "f32_train"])
@pytest.mark.parametrize("side", [32, 33])
@pytest.mark.parametrize("block_impl", ["sep", "dense"])
def test_image_cnn_matches_jax(block_impl, side, mode):
    dtype, train = mode.split("_")
    train = train == "train"
    rng = np.random.default_rng(side)
    rows = 8
    # images of their own contrast and brightness, as photographs differ
    x = (rng.standard_normal((rows, 3, side, side))
         * rng.uniform(0.2, 3.0, (rows, 1, 1, 1))
         + rng.standard_normal((rows, 3, 1, 1))).astype(np.float32)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))       # NHWC
    jmod = jenc.ImageCNN(output_dim=6, width=8, block_impl=block_impl,
                         p_dropout=0.0, dtype=getattr(jnp, dtype.replace(
                             "f32", "float32").replace("bf16", "bfloat16")))
    variables = randomize_stats(jax_variables(jmod, jx), rng)
    tmod = enc.ImageCNN(6, GEN, width=8, block_impl=block_impl,
                        p_dropout=0.0, dtype=torch.float32
                        if dtype == "f32" else torch.bfloat16)
    load_jax_params(tmod, variables["params"], variables["batch_stats"])
    cot = rng.standard_normal((rows, 6)).astype(np.float32)

    got, want, upd, grads, _ = run_both(jmod, tmod, variables, x, jx, cot,
                                        train)
    assert got.dtype == torch.float32 and got.shape == (rows, 6)
    if not train:
        assert max_rel(got.detach().numpy(), want) <= 1e-2
        assert_grads(tmod, grads, 1e-1)
        assert_stats(tmod, variables["batch_stats"], bound=0.0)
    elif dtype == "f32":
        assert max_rel(got.detach().numpy(), want) <= 1e-5
        assert_grads(tmod, grads, 1e-5)
        assert_stats(tmod, upd)
    else:   # bf16 and batch statistics: see the module docstring
        assert_stats(tmod, upd, bound=1e-2)


@pytest.mark.parametrize("shape,dtype", [
    ((6, 5, 7), torch.float32), ((3, 4, 5, 6), torch.bfloat16),
    ((1, 5, 1), torch.float32), ((1, 4, 1, 1), torch.bfloat16)],
    ids=["ncl_f32", "nchw_bf16", "one_value_f32", "one_value_bf16"])
def test_batchnorm_matches_flax(shape, dtype):
    rng = np.random.default_rng(len(shape))
    C = shape[1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.moveaxis(jnp.asarray(xt.float().numpy()), 1, -1).astype(jdtype)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        dtype=jdtype if dtype == torch.bfloat16 else None)
    variables = jbn.init(jax.random.PRNGKey(0), jx)
    params = {"scale": jnp.asarray(rng.uniform(0.5, 2, C), jnp.float32),
              "bias": jnp.asarray(rng.standard_normal(C), jnp.float32)}
    stats = {"mean": jnp.asarray(rng.standard_normal(C), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2, C), jnp.float32)}
    bn = enc.BatchNorm(C)
    load_jax_params(bn, params, stats)
    cot = rng.standard_normal(shape).astype(np.float32)
    for train in (True, False):
        def loss(p, train=train):
            y, upd = fnn.BatchNorm(
                use_running_average=not train, momentum=0.9,
                dtype=jbn.dtype).apply(
                {"params": p, "batch_stats": stats}, jx,
                mutable=["batch_stats"])
            y = jnp.moveaxis(y.astype(jnp.float32), -1, 1)
            return jnp.sum(y * cot), (y, upd["batch_stats"])

        (_, (want, upd)), want_g = jax.value_and_grad(loss, has_aux=True)(
            params)
        before = {k: v.clone() for k, v in bn.state_dict().items()}
        bn.zero_grad()
        xg = xt.clone().requires_grad_(True)
        y = bn(xg, train=train)
        assert y.dtype == dtype
        (y.float() * torch.from_numpy(cot)).sum().backward()
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        assert max_rel(y.detach().float().numpy(), np.asarray(want)) <= tol
        for name in ("scale", "bias"):
            assert max_rel(getattr(bn, name).grad.numpy(),
                           np.asarray(want_g[name])) <= tol
        if train:
            for k in ("mean", "var"):
                assert max_rel(getattr(bn, k).numpy(),
                               np.asarray(upd[k])) <= 1e-6, k
            # back to the stats both sides start from
            load_jax_params(bn, params, stats)
        else:
            assert all(torch.equal(v, before[k])
                       for k, v in bn.state_dict().items())


@pytest.mark.parametrize("size", [6, 7, 32, 33, 224])
def test_same_padding_is_xla_s(size):
    for window, stride in ((3, 2), (3, 1), (1, 1), (2, 2)):
        want = jax.lax.padtype_to_pads((size,), (window,), (stride,),
                                       "SAME")[0]
        assert enc.same_padding(size, window, stride) == tuple(want)


@pytest.mark.parametrize("length,k", [(5, 2), (7, 3), (33, 3), (2, 2),
                                      (10, 4)])
def test_adaptive_max_pool1d_matches_jax(length, k):
    x = np.random.default_rng(length).standard_normal(
        (3, 4, length)).astype(np.float32)
    want = jenc.adaptive_max_pool1d(jnp.asarray(x.transpose(0, 2, 1)), k)
    got = enc.adaptive_max_pool1d(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).transpose(0, 2, 1))


@pytest.mark.parametrize("name", ["TCNN_S", "TCNN_M", "ImageCNN_sep",
                                  "ImageCNN_dense"])
def test_conv_param_names_are_the_jax_tree(name):
    """Every parameter and running statistic at the JAX package's path and
    shape; the bridge splits them back into ``params`` and
    ``batch_stats``."""
    if name.startswith("TCNN"):
        size = name[-1]
        x = jnp.zeros((2, enc.TCNN_MINIMAL_LENGTH[size], 9))
        jmod, tmod = jenc.TCNN(output_dim=3, size=size), \
            enc.TCNN(9, 3, GEN, size=size)
    else:
        impl = name.split("_")[1]
        x = jnp.zeros((2, 17, 17, 3))
        jmod = jenc.ImageCNN(output_dim=3, width=4, block_impl=impl)
        tmod = enc.ImageCNN(3, GEN, width=4, block_impl=impl)
    variables = jax_variables(jmod, x)
    shapes = {k: tuple(v.shape) for k, v in tmod.state_dict().items()}
    want = {k: tuple(v.shape) for tree in variables.values()
            for k, v in params_to_state_dict(tree).items()}
    assert shapes == want
    sd = tmod.state_dict()
    back_params = params_to_state_dict(state_dict_to_params(sd))
    back_stats = params_to_state_dict(state_dict_to_batch_stats(sd))
    assert sorted(back_params) == sorted(
        params_to_state_dict(variables["params"]))
    assert sorted(back_stats) == sorted(
        params_to_state_dict(variables["batch_stats"]))
    assert enc.TCNN_MINIMAL_LENGTH == jenc.TCNN_MINIMAL_LENGTH
