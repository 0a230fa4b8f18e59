"""The port's link prediction over literal features against the JAX
package's (``mrgcn_tpu.tasks.link_prediction``).

The LP artifact (``tasks/synthetic.save_lp_artifact(features=...)``, a
small graph from seed 0) carries numeric values (an MLP encoder), WKT
geometries (``TCNN`` S) and 32 x 32 images (``ImageCNN``, its body in f32
in both packages, as ``tests/test_torch_allmodal_slice.py`` runs it). Both
packages build their inputs and full-graph batch with their own code; the
JAX model's initial parameters and ``batch_stats`` go into the port
through the weight bridge, and both sides are fed the triples the port's
corruptor drew (the JAX step's ``make_corruptor`` monkeypatched, as
``tests/test_torch_lp_slice.py`` does). Held:

* the loss from equal parameters, rtol 1e-4; every gradient of the R-GCN,
  the gates and the MLP encoder within rtol 1e-4 and 1e-4 of its largest
  entry (no penalty, so the data gradients set the scale);
* the convolutional encoders' gradients, each encoder on its own input
  and output cotangent from the step: the port's within 1e-4 of the
  largest entry of the encoder's gradients in float64 (measured 5e-6 WKT,
  1.7e-6 image), and the JAX package's encoder in float64
  (``jax.enable_x64``) against the port's in float64 within 1e-8. Its f32
  gradients are no yardstick here. Op by op they sit 1e-2 (WKT) and 5e-3
  (image) of that entry from float64: flax's ``BatchNorm`` takes the
  batch variance as E[x^2] - E[x]^2, which loses digits in f32, where the
  port's ``F.batch_norm`` does not. And the JAX package's ``TCNN``
  gradient under ``jit`` is wrong even in float64 on the CPU: 0.2-0.33 of
  the largest entry from op by op, whose directional derivative equals a
  central difference (h = 1e-8) to 1e-8 where the compiled one is 23 %
  off (its loss is right; its pools alone agree; cause not shown). So the
  JAX TCNN is differentiated op by op, the image CNN compiled (equal to
  op by op to 5e-15). A convolution bias ahead of BatchNorm has gradient
  0 in exact arithmetic, so each encoder is held on the scale of its
  largest entry, not each parameter on its own;
* the running statistics after the first training step, within 1e-6
  (4.2e-7 measured);
* the eval-mode embeddings (``embed``, the running statistics) and the
  test ranks, raw and filtered, after that step: equal ranks.
"""

import copy
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.config import apply_defaults
from mrgcn_tpu.data import artifact as jax_artifact_io
from mrgcn_tpu.models import encoders as jenc
from mrgcn_tpu.models import mrgcn as jmrgcn
from mrgcn_tpu.ops import distmult as jdm
from mrgcn_tpu.tasks import link_prediction as jlp
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.models import encoders as enc
from mrgcn_tpu_torch.models import mrgcn as tmrgcn
from mrgcn_tpu_torch.tasks import link_prediction as lp
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              params_to_state_dict,
                                              state_dict_to_batch_stats)
from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                             save_lp_artifact)

CPU = torch.device("cpu")
SIZES = dict(num_nodes=120, num_props=4, num_train=600, num_valid=80,
             num_test=90)
TRANSFORM = {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
FEATURES = [
    {"datatype": "xsd.numeric", "include": True, "embedding_dim": 4},
    {"datatype": "ogc.wktLiteral", "include": True, "embedding_dim": 4},
    {"datatype": "blob.image", "include": True, "embedding_dim": 8,
     "transform": TRANSFORM},
]
CONV_ENCODERS = ("ogc_wktLiteral_0", "blob_image_0")


def make_config(epochs=2):
    return apply_defaults({
        "name": "LPF", "graph": {"features": [dict(f) for f in FEATURES]},
        "task": {"type": "link prediction", "seed": 0, "eval_interval": 2},
        "model": {"epoch": epochs, "num_bases": 2, "gates_lr": 0.01,
                  "layers": [{"hidden_nodes": 16}, {"hidden_nodes": 16},
                             {"type": "mrgcn"}]}})


@pytest.fixture(scope="module")
def lp_features_artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpf") / "lpf.npz")
    F = multimodal_features(SIZES["num_nodes"], seed=0, num_numeric=60,
                            num_years=10, num_strings=10, max_len=8,
                            num_geometries=40, num_images=24, image_size=32)
    save_lp_artifact(path, seed=0, features=F, **SIZES)
    return path


@pytest.fixture(scope="module")
def sides(lp_features_artifact):
    """Inputs, full-graph batch and model of both packages with the image
    CNN's body in f32, the JAX model's initial state in the port. The
    patch stays for the module's tests: flax builds the image CNN at each
    ``apply``."""
    config = make_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmrgcn, "ImageCNN", functools.partial(
            jenc.ImageCNN, dtype=jnp.float32))
        mp.setattr(tmrgcn, "ImageCNN", functools.partial(
            enc.ImageCNN, dtype=torch.float32))
        jart = jax_artifact_io.load(lp_features_artifact)
        art = artifact_io.load(lp_features_artifact)
        train = np.asarray(art.data["train"])
        jin = jax_prepare_inputs(jart, config, False)
        jbatch = jlp.make_lp_batches(jin, train, -1, -1, 2)[0]
        jmodel = jlp.build_model(jin, config)
        variables = jmodel.init(jax.random.PRNGKey(0), jin.features,
                                jin.edges)
        tin = prepare_inputs(art, config, False, CPU)
        tbatch = lp.make_lp_batches(tin, train, -1, -1, 2)[0]
        tmodel = lp.build_model(tin, config, torch.Generator().manual_seed(1))
        assert sorted(variables["batch_stats"]) == sorted(CONV_ENCODERS)
        assert tmodel.blob_image_0.Conv_0.dtype == torch.float32
        assert isinstance(tmodel.ogc_wktLiteral_0, enc.TCNN)
        yield (config, (jin, jbatch, jmodel, variables),
               (tin, tbatch, tmodel), art)


def fresh(sides):
    """The port model reset to the JAX model's initial state."""
    _, (_, _, _, variables), (_, _, tmodel), _ = sides
    load_jax_params(tmodel, jax.tree.map(np.asarray, variables["params"]),
                    jax.tree.map(np.asarray, variables["batch_stats"]))
    return tmodel


def drawn_triples(tbatch, seed=0):
    return lp.make_corruptor(0.2)(
        torch.from_numpy(tbatch.data), tbatch.num_triples,
        torch.from_numpy(tbatch.corrupt_pool), tbatch.num_pool,
        torch.Generator().manual_seed(seed))


def encoder_grads(module, x, cot, dtype):
    """A train-mode encoder's parameter gradients for input ``x`` and
    output cotangent ``cot``, computed in ``dtype`` on a copy."""
    module = copy.deepcopy(module).to(dtype)
    for m in module.modules():       # the image body's fixed compute type
        if getattr(m, "dtype", None) is not None:
            m.dtype = dtype
    module(x.to(dtype), train=True).backward(cot.to(dtype))
    return {n: p.grad.double() for n, p in module.named_parameters()}


def jax_encoder_grads_f64(name, args, variables, x, cot):
    """The JAX package's encoder ``name`` (built from its ``modules_config``
    entry ``args``) in float64: its train-mode parameter gradients for the
    port's input ``x`` (channels first) and cotangent ``cot``."""
    with jax.enable_x64(True):
        if name.startswith("ogc"):
            _, dim, size, dropout = args
            module = jenc.TCNN(output_dim=dim, size=size, p_dropout=dropout)
            x = x.permute(0, 2, 1)                     # NLC
        else:
            _, _, dim, dropout = args
            module = jenc.ImageCNN(output_dim=dim, p_dropout=dropout,
                                   dtype=jnp.float64)
            x = x.permute(0, 2, 3, 1)                  # NHWC
        f64 = functools.partial(jnp.asarray, dtype=jnp.float64)
        params = jax.tree.map(f64, variables["params"][name])
        stats = jax.tree.map(f64, variables["batch_stats"][name])

        def apply(p):
            out, _ = module.apply({"params": p, "batch_stats": stats},
                                  f64(x.numpy()), train=True,
                                  mutable=["batch_stats"])
            return out

        def grads_of(p, c):
            return jax.vjp(apply, p)[1](c)[0]

        # the TCNN op by op: compiled, its gradient is off (module
        # docstring)
        if not name.startswith("ogc"):
            grads_of = jax.jit(grads_of)
        grads = grads_of(params, f64(cot.double().numpy()))
        return {k: v.double() for k, v in params_to_state_dict(
            jax.tree.map(np.asarray, grads)).items()}


def test_lp_features_loss_and_every_gradient_match_jax(sides):
    _, (jin, _, jmodel, variables), (tin, tbatch, _), _ = sides
    tmodel = fresh(sides)
    triples, labels, weights = drawn_triples(tbatch)

    def loss_fn(p):      # link_prediction.make_steps' loss, given triples
        out, _ = jmodel.apply({**variables, "params": p}, jin.features,
                              jin.edges, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
        t = jnp.asarray(triples.numpy())
        y_hat = jdm.score(t[:, 0], t[:, 1], t[:, 2], out,
                          p["rgcn"]["relations"])
        bce = optax.sigmoid_binary_cross_entropy(
            y_hat, jnp.asarray(labels.numpy()))
        w = jnp.asarray(weights.numpy())
        return jnp.sum(bce * w) / jnp.maximum(jnp.sum(w), 1.0)

    want, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    # each conv encoder's input and output cotangent in the port's step
    seen = {}

    def keep(name):
        def hook(module, args, out):
            seen[name] = [args[0].detach(), None]
            out.register_hook(lambda g: seen[name].__setitem__(1, g))
        return hook

    hooks = [getattr(tmodel, n).register_forward_hook(keep(n))
             for n in CONV_ENCODERS]
    got = lp.loss_and_grads(tmodel, tbatch, triples, labels, weights)
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)

    want_grads = params_to_state_dict(want_grads)
    named = dict(tmodel.named_parameters())
    assert sorted(named) == sorted(want_grads)
    for name, p in named.items():
        if name.split(".")[0] in CONV_ENCODERS:
            continue
        w = want_grads[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    modules = dict(zip(tmodel.names, tin.modules_config))
    for encoder in CONV_ENCODERS:
        x, cot = seen[encoder]
        exact = encoder_grads(getattr(tmodel, encoder), x, cot,
                              torch.float64)
        scale = max(float(g.abs().max()) for g in exact.values())
        port = {n[len(encoder) + 1:]: p.grad.double()
                for n, p in named.items() if n.startswith(encoder + ".")}
        assert sorted(port) == sorted(exact)
        err = max(float((port[n] - g).abs().max()) for n, g in exact.items())
        assert err <= 1e-4 * scale, (encoder, err, scale)
        theirs = jax_encoder_grads_f64(encoder, modules[encoder][1],
                                       variables, x, cot)
        assert sorted(theirs) == sorted(exact)
        err = max(float((theirs[n] - g).abs().max())
                  for n, g in exact.items())
        assert err <= 1e-8 * scale, (encoder, err, scale)


@pytest.fixture(scope="module")
def jax_step(sides):
    """One step of the JAX package's own jitted train step (running
    statistics mutable), its corruptor handing out the triples the port
    drew: ``(triples, params, batch_stats, loss, embed)``."""
    config, (jin, jbatch, jmodel, variables), (_, tbatch, _), _ = sides
    drawn = drawn_triples(tbatch, seed=3)
    fixed = tuple(jnp.asarray(t.numpy()) for t in drawn)
    params, stats = jax.tree.map(
        jnp.copy, (variables["params"], variables["batch_stats"]))
    optimizer = jutils.build_optimizer(params, config, jin.optimizer_config,
                                       False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlp, "make_corruptor", lambda ratio: lambda *args: fixed)
        train_step, _, embed_fn = jlp.make_steps(jmodel, optimizer, config)
    params, stats, _, loss = train_step(
        params, stats, optimizer.init(params), jbatch.features, jbatch.edges,
        jnp.asarray(jbatch.data), jnp.asarray(jbatch.corrupt_pool),
        jnp.int32(jbatch.num_triples), jnp.int32(jbatch.num_pool),
        jax.random.PRNGKey(0))
    return drawn, params, stats, float(loss), embed_fn


def test_lp_features_first_step_statistics_match_jax(sides, jax_step):
    config, _, (tin, tbatch, _), _ = sides
    drawn, _, stats, want, _ = jax_step
    tmodel = fresh(sides)
    topt = tutils.build_optimizer(tmodel, config, tin.optimizer_config,
                                  False)
    got = lp.loss_and_grads(tmodel, tbatch, *drawn)
    topt.step()
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    want_stats = params_to_state_dict(stats)
    got_stats = params_to_state_dict(state_dict_to_batch_stats(
        tmodel.state_dict()))
    assert sorted(got_stats) == sorted(want_stats) and got_stats
    for k, w in want_stats.items():
        err = float((got_stats[k] - w).abs().max())
        assert err <= 1e-6, (k, err)


def test_lp_features_eval_ranks_match_jax(sides, jax_step):
    """After the JAX training step, the port given its parameters and
    running statistics embeds in eval mode as the JAX ``embed`` does and
    ranks the test triples the same."""
    _, (jin, _, _, variables), (tin, _, _), art = sides
    _, params, stats, _, embed_fn = jax_step
    tmodel = fresh(sides)
    load_jax_params(tmodel, jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, stats))
    moved = state_dict_to_batch_stats(tmodel.state_dict())
    assert not np.array_equal(
        moved["ogc_wktLiteral_0"]["_ConvBNRelu_0"]["BatchNorm_0"]["mean"],
        np.asarray(variables["batch_stats"]["ogc_wktLiteral_0"]
                   ["_ConvBNRelu_0"]["BatchNorm_0"]["mean"]))

    test = np.asarray(art.data["test"])
    jbatches = jlp.make_lp_batches(jin, test, -1, -1, 2)
    tbatches = lp.make_lp_batches(tin, test, -1, -1, 2)
    want = np.asarray(embed_fn(params, stats, jin.features, jin.edges))
    got = lp.embed(tmodel, tbatches[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    _, _, jranks = jlp.evaluate(jbatches, embed_fn, params, stats, -1, True)
    _, _, ranks = lp.evaluate(tbatches, tmodel, -1, True)
    for kind in ("raw", "flt"):
        assert len(ranks[kind]) == 2 * SIZES["num_test"]
        np.testing.assert_array_equal(ranks[kind], jranks[kind])
