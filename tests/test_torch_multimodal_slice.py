"""The port's multimodal full-batch NC slice against the JAX package's.

A small synthetic graph (numpy, seed 0) carries numeric, gYear and
byte-token string features (``tasks/synthetic.multimodal_features``, the
string feature on the from-scratch text encoder). Both packages build
their inputs with their own ``prepare_inputs``/``make_batches``; the JAX
model's initial parameters (R-GCN, the three encoders, the gates) go into
the port through the weight bridge. Compared on the CPU:

* the logits of the frontier-restricted chain, and three training steps
  (CE, L2, clip, Adam): logits to 2e-4 x max(1, max |logit|), losses to
  rtol 1e-4. The text encoder's body is bf16 in both packages (the config
  has no switch for it). On the CPU the JAX package runs its plain chains
  (``xla_attention``, the unfused MLP), which round to bf16 at a few other
  places than the fused kernels the port mirrors; the encoder outputs
  then differ by bf16 steps, and the gates (0.1) and the f32 R-GCN keep
  that far below 1e-4 in the logits and losses (tests/test_torch_encoders.py
  holds the encoder itself to the kernels' arithmetic). 1e-4 also covers
  the two clips (optax divides by the norm, torch by norm + 1e-6);
* the unrestricted branch (labels on every node: the full edge set, every
  layer planned, ``dense_aggregate`` in both layers), featureless and
  multimodal, at the same bounds;
* the CLI end to end on the multimodal artifact.
"""

import numpy as np
import pytest
import torch

import jax

from benchmarks.torch_baseline import build_workload
from mrgcn_tpu.config import apply_defaults
from mrgcn_tpu.data import artifact as artifact_io
from mrgcn_tpu.tasks import node_classification as jnc
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
from mrgcn_tpu_torch import run as torch_run
from mrgcn_tpu_torch.models.mrgcn import MRGCN
from mrgcn_tpu_torch.tasks import node_classification as nc
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              state_dict_to_params)
from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                             save_nc_artifact)

CPU = torch.device("cpu")
FEATURES = [
    {"datatype": "xsd.numeric", "include": True, "embedding_dim": 4},
    {"datatype": "xsd.gYear", "include": True, "embedding_dim": 1},
    {"datatype": "xsd.string", "include": True, "embedding_dim": 16},
]


def small_workload():
    return build_workload(n=400, num_props=4, num_edges=2400, hidden=16,
                          num_classes=5, num_bases=3, num_labeled=60,
                          seed=0)


@pytest.fixture(scope="module")
def mm_artifact(tmp_path_factory):
    w = small_workload()
    path = tmp_path_factory.mktemp("mm") / "mm.npz"
    F = multimodal_features(w["n"], seed=0, num_numeric=150, num_years=90,
                            num_strings=60, max_len=20)
    save_nc_artifact(str(path), w["n"], w["R"], w["src"], w["dst"],
                     w["rel"], w["norm"], w["labels_idx"], w["labels_cls"],
                     w["num_classes"], seed=0, num_eval=40, F=F)
    return path


def make_config(features=True, l2=5e-4, epochs=3):
    return apply_defaults({
        "name": "MM", "graph": {"features": [dict(f) for f in FEATURES]
                                if features else []},
        "task": {"type": "node classification", "seed": 0},
        "model": {"epoch": epochs, "num_bases": 3, "l2_lambda": l2,
                  "gates_lr": 0.01,
                  "layers": [{"hidden_nodes": 16}, {"type": "mrgcn"}]}})


def both_sides(art, config, Y_train, featureless):
    """Inputs, full batch and models of both packages, with the JAX
    model's initial parameters loaded into the port."""
    C = len(art.class_map)
    jin = jax_prepare_inputs(art, config, featureless)
    jbatch = jnc.make_batches(jin, Y_train, -1, 2)[0]
    jmodel = jnc.build_model(jin, config, C)
    params = jmodel.init(jax.random.PRNGKey(0), jin.features,
                         jin.edges)["params"]

    tin = prepare_inputs(art, config, featureless, CPU)
    tbatch = nc.make_batches(tin, Y_train, -1, 2)[0]
    tmodel = nc.build_model(tin, config, C, torch.Generator().manual_seed(1))
    load_jax_params(tmodel, params)
    return (jin, jbatch, jmodel, params), (tin, tbatch, tmodel)


def train_both(sides, config, steps=3):
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    l2 = config["model"]["l2_lambda"]
    optimizer = jutils.build_optimizer(params, config, jin.optimizer_config,
                                       jin.featureless)
    opt_state = optimizer.init(params)
    train_step = jnc.make_steps(jmodel, optimizer, config)[0]
    topt = tutils.build_optimizer(tmodel, config, tin.optimizer_config,
                                  tin.featureless)
    want, got = [], []
    for _ in range(steps):
        params, _, opt_state, loss, _ = train_step(
            params, {}, opt_state, jbatch.features, jbatch.edges,
            jbatch.idx, jbatch.targets, jbatch.weights,
            jax.random.PRNGKey(0))
        want.append(float(loss))
        got.append(float(nc.train_step(tmodel, topt, tbatch, 0.0, l2)[0]))
    return got, want


def assert_logits_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= 2e-4 * max(1.0, float(np.abs(want).max())), err


def test_multimodal_inputs_match_jax(mm_artifact):
    art = artifact_io.load(str(mm_artifact))
    config = make_config()
    jin = jax_prepare_inputs(art, config, False)
    tin = prepare_inputs(art, config, False, CPU)
    assert (tin.X_width, tin.featureless) == (jin.X_width, False) \
        == (21, False)
    assert tin.modules_config == jin.modules_config
    assert (tin.text_vocab_size, tin.text_pad_id) \
        == (jin.text_vocab_size, jin.text_pad_id)
    assert sorted(tin.features) == sorted(jin.features) \
        == ["xsd_gYear_0", "xsd_numeric_0", "xsd_string_0"]
    for name, arrays in tin.features.items():
        for mine, theirs in zip(arrays, jin.features[name]):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert sorted(tin.edges.plans) == sorted(jin.edges.plans)


def test_multimodal_logits_and_steps_match_jax(mm_artifact):
    art = artifact_io.load(str(mm_artifact))
    config = make_config()
    Y_train = np.asarray(art.Y["train"]).reshape(-1, 2)
    sides = both_sides(art, config, Y_train, False)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides

    # layer 0 over features: identity and dense halves on rectangular plans
    assert sorted(tbatch.edges[0].plans) == ["4:8", "8:8:id"]
    want = jmodel.apply({"params": params}, jbatch.features, jbatch.edges)
    assert_logits_close(tmodel(tbatch.edges, tbatch.features), want)

    got, want_losses = train_both(sides, config)
    np.testing.assert_allclose(got, want_losses, rtol=1e-4)
    assert got[2] < got[0]


@pytest.mark.parametrize("features", [False, True])
def test_unrestricted_full_batch_matches_jax(mm_artifact, features,
                                             monkeypatch):
    monkeypatch.delenv("MRGCN_RESTRICT_OUT", raising=False)
    art = artifact_io.load(str(mm_artifact))
    config = make_config(features=features)
    n = art.structure.num_nodes
    every = np.stack([np.arange(n), np.arange(n) % len(art.class_map)],
                     axis=1).astype(np.int32)
    sides = both_sides(art, config, every, not features)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    assert tbatch.edges is tin.edges and jbatch.edges is jin.edges
    np.testing.assert_array_equal(tbatch.idx.numpy(),
                                  np.asarray(jbatch.idx))
    if features:
        assert tin.edges.plan_for(21, 16) is not None

    want = jmodel.apply({"params": params}, jbatch.features, jbatch.edges)
    assert_logits_close(tmodel(tbatch.edges, tbatch.features), want)
    got, want_losses = train_both(sides, config)
    np.testing.assert_allclose(got, want_losses, rtol=1e-4)


def test_weight_bridge_carries_encoders_and_gates(mm_artifact):
    art = artifact_io.load(str(mm_artifact))
    config = make_config()
    tin = prepare_inputs(art, config, False, CPU)
    tmodel = nc.build_model(tin, config, len(art.class_map),
                            torch.Generator().manual_seed(0))
    params = state_dict_to_params(tmodel.state_dict())
    assert sorted(params) == ["gate_weights", "rgcn", "xsd_gYear_0",
                              "xsd_numeric_0", "xsd_string_0"]
    np.testing.assert_array_equal(params["gate_weights"],
                                  np.full(3, 0.1, np.float32))
    assert sorted(params["rgcn"]["layer_0"]) == [
        "comp_f", "comp_i", "weight_f", "weight_i_packed"]
    assert params["rgcn"]["layer_0"]["weight_f"].shape == (3, 21, 16)
    # gates train under [model] gates_lr, each encoder in its datatype's
    # group, as the JAX package labels them
    labels = tutils._param_labels(tmodel, tin.optimizer_config, False)
    jlabels = jutils._param_labels(params, tin.optimizer_config, False)
    for name, label in labels.items():
        node = jlabels
        for part in name.split("."):
            node = node[part]
        assert label == node, name
    assert labels["gate_weights"] == "gates"
    assert labels["xsd_string_0._TextBlock_0.qkv.kernel"] == "xsd.string"
    mask = tutils.weight_mask(tmodel)
    assert mask["gate_weights"] and mask["xsd_string_0.LayerNorm_0.scale"]
    assert not mask["xsd_string_0._TextBlock_1.Dense_0.bias"]


def test_cli_trains_the_multimodal_artifact(mm_artifact, tmp_path,
                                            monkeypatch):
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    import chip_smoke
    cfg = tmp_path / "mm.toml"
    chip_smoke.write_config(cfg, 2, 3, 16, features=(
        "xsd.numeric", "xsd.gYear", "xsd.string"))
    res = torch_run.run_cli(["-c", str(cfg), "-i", str(mm_artifact), "-o",
                             str(tmp_path), "--dry_run", "--test"])
    losses = [h["train_loss"] for h in res.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert np.isfinite(res.loss)
    assert isinstance(res.model, MRGCN) and not res.model.featureless
    assert res.model.xsd_string_0.dtype == torch.bfloat16


def test_skipped_encoder_contributes_zeros(mm_artifact):
    art = artifact_io.load(str(mm_artifact))
    tin = prepare_inputs(art, make_config(), False, CPU)
    tmodel = nc.build_model(tin, make_config(), len(art.class_map),
                            torch.Generator().manual_seed(0))
    n = tin.num_nodes
    full = tmodel.compute_modality_embeddings(tin.features, n)
    assert full.shape == (n, 21) and full[:, 5:].abs().sum() > 0
    tmodel.skip_encoders = ("xsd_string_0",)
    skipped = tmodel.compute_modality_embeddings(tin.features, n)
    assert torch.equal(skipped[:, :5], full[:, :5])
    assert not skipped[:, 5:].any()


def test_unported_text_attention_override_raises(mm_artifact, monkeypatch):
    """``MRGCN_TEXT_ATTN=xla``, which raised before ROADMAP item 3c, builds
    the flax multi-head tree in both drivers' models and matches the JAX
    model at the logits; ``fused_core`` builds its own tree."""
    art = artifact_io.load(str(mm_artifact))
    config = make_config()
    monkeypatch.setenv("MRGCN_TEXT_ATTN", "xla")
    Y_train = np.asarray(art.Y["train"]).reshape(-1, 2)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = both_sides(
        art, config, Y_train, False)
    assert "MultiHeadDotProductAttention_0" in \
        params["xsd_string_0"]["_TextBlock_0"]
    assert tmodel.xsd_string_0.attn_impl == "xla"
    want = jmodel.apply({"params": params}, jbatch.features, jbatch.edges)
    assert_logits_close(tmodel(tbatch.edges, tbatch.features), want)
    monkeypatch.setenv("MRGCN_TEXT_ATTN", "fused_core")
    model = nc.build_model(tin, config, len(art.class_map),
                           torch.Generator().manual_seed(0))
    assert hasattr(model.xsd_string_0._TextBlock_0, "qkv")
    # the argument wins over the environment
    model = nc.build_model(tin, config, len(art.class_map),
                           torch.Generator().manual_seed(0),
                           text_attn="plain")
    assert model.xsd_string_0.attn_impl == "plain"


class _NoRows:
    def writerow(self, row):
        pass


def test_nc_driver_skips_a_zero_gated_encoder(mm_artifact, monkeypatch):
    """The NC driver skips an encoder whose gate is exactly zero, as the
    LP driver and the JAX package's (``with_gate_skip``) do: the encoder
    runs no time in ``nc.run`` (0 epochs, then the test split's
    evaluation), and the model's logits equal the JAX model's with the same
    encoder skipped, at the same parameters."""
    import jax.numpy as jnp
    art = artifact_io.load(str(mm_artifact))
    config = make_config(epochs=0)
    Y_test = np.asarray(art.Y["test"]).reshape(-1, 2)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = both_sides(
        art, config, Y_test, False)
    gates = np.asarray(params["gate_weights"]).copy()
    gates[tmodel.names.index("xsd_string_0")] = 0.0
    params = {**params, "gate_weights": jnp.asarray(gates)}

    built, calls = [], []
    build = nc.build_model

    def build_with_dead_gate(*args, **kwargs):
        model = build(*args, **kwargs)
        load_jax_params(model, params)
        model.xsd_string_0.register_forward_hook(
            lambda *_: calls.append(1))
        built.append(model)
        return model

    monkeypatch.setattr(nc, "build_model", build_with_dead_gate)
    res = nc.run(art, config, _NoRows(), False, "test", 0, CPU)
    assert res.model is built[0]
    assert res.model.skip_encoders == ("xsd_string_0",)
    assert not calls and np.isfinite(res.loss)

    jskip = jutils.with_gate_skip(jmodel, params)
    assert jskip.skip_encoders == ("xsd_string_0",)
    want = jskip.apply({"params": params}, jbatch.features, jbatch.edges)
    with torch.no_grad():
        assert_logits_close(res.model(tbatch.edges, tbatch.features), want)
    assert not calls



@pytest.mark.parametrize("kept", [("xsd.numeric", "xsd.gYear"),
                                  ("xsd.numeric", "xsd.string")],
                         ids=["numeric_gyear", "numeric_string"])
def test_featured_nc_without_bases_matches_jax(mm_artifact, kept):
    """``num_bases = 0`` over features (as configs/aifb.toml and
    configs/synth.toml run): one weight per relation in both halves of
    layer 0, the identity half on its plan and the dense half on
    ``dense_aggregate`` (its plan), then the grouped layer 1, from the
    JAX model's parameters. Over the f32 MLP encoders the training loss
    within 1e-5 relative and every parameter's gradient within 1e-4 of
    its largest entry. With the string feature the text encoder's bf16
    body rounds at other places in the two packages (see above) and
    everything downstream of it carries that: the loss within 1e-4
    relative, the text encoder's gradients within 1e-1 of their norm and
    every other gradient within 1e-2 of its norm (the bounds the card's
    text encoder is held to against the CPU)."""
    from mrgcn_tpu_torch.tasks.jax_import import params_to_state_dict
    art = artifact_io.load(str(mm_artifact))
    config = make_config()
    config["graph"]["features"] = [f for f in config["graph"]["features"]
                                   if f["datatype"] in kept]
    config["model"]["num_bases"] = 0
    Y_train = np.asarray(art.Y["train"]).reshape(-1, 2)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = both_sides(
        art, config, Y_train, False)
    layer0 = dict(tmodel.rgcn.layer_0.named_parameters())
    assert "comp_i" not in layer0 and "comp_f" not in layer0
    assert layer0["weight_f"].shape[0] == art.structure.num_relations
    assert "8:8:id" in tbatch.edges[0].plans
    assert tbatch.edges[0].plan_for(tin.X_width, 16) is not None
    assert tbatch.edges[1].grouped and not tbatch.edges[1].plans
    l2 = config["model"]["l2_lambda"]

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jbatch.features, jbatch.edges,
                           train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jnc._loss_and_metrics(out, jbatch.idx, jbatch.targets,
                                     jbatch.weights)[0] \
            + jutils.regularization(p, 0.0, l2)

    want, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    got = nc.loss_and_grads(tmodel, tbatch, 0.0, l2)[0]
    text = "xsd.string" in kept
    np.testing.assert_allclose(float(got), float(want),
                               rtol=1e-4 if text else 1e-5)
    want_grads = params_to_state_dict(want_grads)
    got_grads = {n: p.grad.numpy() for n, p in tmodel.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for name, g in got_grads.items():
        w = want_grads[name].numpy()
        if not text:
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name
        else:
            bound = 1e-1 if name.startswith("xsd_string_0.") else 1e-2
            assert np.linalg.norm(g - w) <= bound * np.linalg.norm(w), name
