"""The port's full-batch and mini-batch NC over all five of DMG's modalities
against the JAX package's.

A small synthetic graph (numpy, seed 0) carries numeric, gYear, byte-token
string, WKT geometry (9 x 4-64 points, so the lengths pick TCNN size S)
and 32 x 32 uint8 image features (``tasks/synthetic.multimodal_features``).
The image embedding is 72 wide, so ``X_width`` is 4 + 2 + 8 + 4 + 72 = 90
and the dense half of layer 0 takes the ``k = 1`` plan (256-lane lines),
as DMG's 165 does. Both packages build their inputs with their own
``prepare_inputs`` / ``make_batches``; the JAX model's initial parameters
and ``batch_stats`` go into the port through the weight bridge. Compared
on the CPU:

* inputs: modules, widths, feature arrays (geometries padded to at least
  TCNN S's minimal length), plans;
* eval-mode logits (running statistics) within 2e-4 x max(1, max |logit|),
  the multimodal slice's bound;
* one train-mode forward and backward, the image CNN's body in bf16 as
  the model builds it and in f32 in both packages: logits within 1e-3 x
  max(1, max |logit|) and the running statistics within 1e-4 on the
  scale of their activations (``assert_stats_close``), the bf16 image
  CNN's within 2e-2 (its body drifts by bf16 steps under batch
  statistics, ``tests/test_torch_conv_encoders.py``); with the f32 image body, each encoder's, the gates'
  and the R-GCN's gradients within 1e-2 of their largest entry, the bf16
  text encoder's within 1e-1 (measured: 4.8e-6 image, 2e-6 numeric and
  gYear, 4.1e-3 WKT, 1.8e-3 gates, 3.3e-4 R-GCN, 8.6e-2 text: the
  cotangent carries the text encoder's bf16 steps). With the bf16 image
  body its drift reaches every gradient (the image CNN's 0.3 apart by
  norm), so they are not held there;
* three full-batch steps and one mini-batch epoch, both image bodies:
  losses within 1e-3 relative, and the running statistics after the first
  step (at equal parameters; the feature rows of a mini-batch are padded
  with zero rows, which enter BatchNorm's batch statistics in both
  packages) as above. Later statistics are not held: Adam moves a
  parameter whose gradient is rounding noise by lr either way, such as a
  convolution's bias ahead of BatchNorm, and the running means follow;
* ``_prepare`` of images with and without ``mean`` / ``std``, and of
  geometries;
* the bridge both ways (params and ``batch_stats``);
* the CLI trains the artifact full batch and in mini-batches; early
  stopping restores the running statistics with the parameters; an image
  ``model`` spec with a MobileNetV2 checkpoint on disk builds the frozen
  backbone (its encoder held against the JAX package's within 1e-5 of the
  largest entry), without one the model takes ``ImageCNN``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.torch_baseline import build_workload
from mrgcn_tpu.config import apply_defaults
from mrgcn_tpu.data import artifact as jax_artifact_io
from mrgcn_tpu.models import encoders as jenc
from mrgcn_tpu.models import mrgcn as jmrgcn
from mrgcn_tpu.tasks import node_classification as jnc
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
from mrgcn_tpu_torch import run as torch_run
from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.models import encoders as enc
from mrgcn_tpu_torch.models import mrgcn as tmrgcn
from mrgcn_tpu_torch.models.mrgcn import MRGCN
from mrgcn_tpu_torch.tasks import node_classification as nc
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              params_to_state_dict,
                                              state_dict_to_batch_stats,
                                              state_dict_to_params)
from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                             save_nc_artifact)

CPU = torch.device("cpu")
TRANSFORM = {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
FEATURES = [
    {"datatype": "xsd.numeric", "include": True, "embedding_dim": 4},
    {"datatype": "xsd.gYear", "include": True, "embedding_dim": 2},
    {"datatype": "xsd.string", "include": True, "embedding_dim": 8},
    {"datatype": "ogc.wktLiteral", "include": True, "embedding_dim": 4},
    {"datatype": "blob.image", "include": True, "embedding_dim": 72,
     "transform": TRANSFORM},
]
X_WIDTH = 90
IMAGE_SIDE = 32


@pytest.fixture(scope="module")
def am_artifact(tmp_path_factory):
    w = build_workload(n=300, num_props=4, num_edges=1800, hidden=16,
                       num_classes=5, num_bases=3, num_labeled=48, seed=0)
    path = tmp_path_factory.mktemp("am") / "am.npz"
    F = multimodal_features(w["n"], seed=0, num_numeric=100, num_years=60,
                            num_strings=40, max_len=12, num_geometries=50,
                            num_images=30, image_size=IMAGE_SIDE)
    save_nc_artifact(str(path), w["n"], w["R"], w["src"], w["dst"],
                     w["rel"], w["norm"], w["labels_idx"], w["labels_cls"],
                     w["num_classes"], seed=0, num_eval=30, F=F)
    return path


def make_config(epochs=3, batchsize=-1, l2=5e-4):
    return apply_defaults({
        "name": "AM", "graph": {"features": [dict(f) for f in FEATURES]},
        "task": {"type": "node classification", "seed": 0,
                 "batchsize": batchsize},
        "model": {"epoch": epochs, "num_bases": 3, "l2_lambda": l2,
                  "gates_lr": 0.01,
                  "layers": [{"hidden_nodes": 16}, {"type": "mrgcn"}]}})


_SIDES = {}


def both_sides(path, config, Y, batchsize=-1, image_dtype="image_bf16"):
    """Batches and models of both packages, the JAX model's initial
    parameters and running statistics loaded into a new port model. The
    JAX side and the inputs are built once per artifact and batch size
    (the JAX init of five encoders takes half a minute on the CPU)."""
    key = (str(path), batchsize, image_dtype)
    if key not in _SIDES:
        art = artifact_io.load(str(path))
        jart = jax_artifact_io.load(str(path))
        jin = jax_prepare_inputs(jart, config, False)
        jbatches = jnc.make_batches(jin, Y, batchsize, 2,
                                    rng=np.random.default_rng(1))
        jmodel = jnc.build_model(jin, config, len(art.class_map))
        variables = jmodel.init(jax.random.PRNGKey(0), jin.features,
                                jin.edges)
        tin = prepare_inputs(art, config, False, CPU)
        tbatches = nc.make_batches(tin, Y, batchsize, 2,
                                   rng=np.random.default_rng(1))
        _SIDES[key] = (jin, jbatches, jmodel, variables, tin, tbatches,
                       len(art.class_map))
    jin, jbatches, jmodel, variables, tin, tbatches, C = _SIDES[key]
    tmodel = nc.build_model(tin, config, C, torch.Generator().manual_seed(1))
    load_jax_params(tmodel, variables["params"], variables["batch_stats"])
    return (jin, jbatches, jmodel, variables), (tin, tbatches, tmodel)


def train_labels(path):
    return np.asarray(artifact_io.load(str(path)).Y["train"]).reshape(-1, 2)


def assert_logits_close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), err


def assert_stats_close(tmodel, batch_stats, image_dtype="image_bf16"):
    """The running statistics after one train-mode forward against the
    JAX package's ``batch_stats``, each BatchNorm's on the scale of its
    activations: means within 1e-4 of the largest of their magnitudes and
    standard deviations, variances within 1e-4 of the largest (f32 sums of
    16,384 values a channel in other orders: 1.5e-5 measured); the bf16
    image CNN's within 2e-2 (see the module docstring)."""
    want = params_to_state_dict(batch_stats)
    got = params_to_state_dict(state_dict_to_batch_stats(
        tmodel.state_dict()))
    assert sorted(got) == sorted(want) and got
    for k, w in want.items():
        bound = 2e-2 if k.startswith("blob_image") \
            and image_dtype == "image_bf16" else 1e-4
        var = want[k.rsplit(".", 1)[0] + ".var"]
        scale = float(var.max() if k.endswith(".var")
                      else max(w.abs().max(), var.sqrt().max()))
        err = float((got[k] - w).abs().max())
        assert err <= bound * scale, (k, err, scale)


def test_allmodal_inputs_match_jax(am_artifact):
    config = make_config()
    (jin, _, _, variables), (tin, _, tmodel) = both_sides(
        am_artifact, config, train_labels(am_artifact))
    assert tin.X_width == jin.X_width == X_WIDTH
    assert tin.modules_config == tuple(jin.modules_config)
    wkt = dict(tin.modules_config)["ogc.wktLiteral"]
    assert wkt[0] == 9 and wkt[2] == "S"
    assert sorted(tin.features) == sorted(jin.features) == [
        "blob_image_0", "ogc_wktLiteral_0", "xsd_gYear_0", "xsd_numeric_0",
        "xsd_string_0"]
    for name, arrays in tin.features.items():
        for mine, theirs in zip(arrays, jin.features[name]):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    data = tin.features["ogc_wktLiteral_0"][0]
    assert data.shape[1:] == (9, 64) and data.dtype == torch.float32
    assert tin.features["blob_image_0"][0].dtype == torch.uint8
    # the dense half of layer 0 packs one 90-wide row a 128-lane line
    assert sorted(tin.edges.plans) == sorted(jin.edges.plans) \
        == ["1:8", "8:16", "8:8:id"]
    assert isinstance(tmodel.ogc_wktLiteral_0, enc.TCNN)
    assert isinstance(tmodel.blob_image_0, enc.ImageCNN)


@pytest.fixture(params=["image_bf16", "image_f32"])
def image_dtype(request, monkeypatch):
    """The image CNN's body as the model builds it (bf16), or in f32 in
    both packages (``dtype``, a field of both modules), where batch
    statistics leave no bf16 drift and the gradients can be held."""
    if request.param == "image_f32":
        monkeypatch.setattr(jmrgcn, "ImageCNN", functools.partial(
            jenc.ImageCNN, dtype=jnp.float32))
        monkeypatch.setattr(tmrgcn, "ImageCNN", functools.partial(
            enc.ImageCNN, dtype=torch.float32))
    return request.param


def test_allmodal_forward_backward_match_jax(am_artifact, image_dtype):
    config = make_config()
    (jin, jbatches, jmodel, variables), (tin, tbatches, tmodel) = \
        both_sides(am_artifact, config, train_labels(am_artifact),
                   image_dtype=image_dtype)
    jb, tb = jbatches[0], tbatches[0]
    assert sorted(tb.edges[0].plans) == ["1:8", "8:8:id"]

    want = jmodel.apply(variables, jb.features, jb.edges)
    with torch.no_grad():
        got = tmodel(tb.edges, tb.features)
    assert_logits_close(got, want, 2e-4)

    def loss(params):
        out, upd = jmodel.apply({**variables, "params": params},
                                jb.features, jb.edges, train=True,
                                mutable=["batch_stats"])
        return jnc._loss_and_metrics(out, jb.idx, jb.targets,
                                     jb.weights)[0], (out, upd)

    (_, (want, upd)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    out = tmodel(tb.edges, tb.features, train=True)
    nc._loss_and_metrics(out, tb.idx, tb.targets, tb.weights)[0].backward()
    assert_logits_close(out, want, 1e-3)
    assert_stats_close(tmodel, upd["batch_stats"], image_dtype)
    if image_dtype == "image_bf16":
        return      # the gradients carry the image CNN's bf16 drift
    want_g = params_to_state_dict(grads)
    got_g = {n: p.grad for n, p in tmodel.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    groups = {}
    for name, g in got_g.items():
        top = name.split(".")[0]
        err = float((g - want_g[name]).abs().max())
        e, m = groups.get(top, (0.0, 0.0))
        groups[top] = (max(e, err), max(m, float(want_g[name].abs().max())))
    for top, (err, scale) in groups.items():
        bound = 1e-1 if top == "xsd_string_0" else 1e-2
        assert err <= bound * scale, (top, err, scale)


@pytest.mark.parametrize("batchsize", [-1, 16], ids=["full", "minibatch"])
def test_allmodal_steps_match_jax(am_artifact, batchsize, image_dtype):
    config = make_config(batchsize=batchsize)
    Y = train_labels(am_artifact)
    (jin, jbatches, jmodel, variables), (tin, tbatches, tmodel) = \
        both_sides(am_artifact, config, Y, batchsize, image_dtype)
    if batchsize > 0:
        assert len(tbatches) == len(jbatches) == -(-len(Y) // batchsize)
        # the image rows of a mini-batch are padded to the 64-row bucket,
        # and the zero rows enter the batch statistics
        data = tbatches[0].features["blob_image_0"][0]
        assert data.shape[0] == 64 and not data[-1].any()
        steps = [(j, t) for j, t in zip(jbatches, tbatches)]
    else:
        steps = [(jbatches[0], tbatches[0])] * 3
    # the train step donates its inputs: copies, so the cached ones stay
    params, batch_stats = jax.tree.map(
        jnp.copy, (variables["params"], variables["batch_stats"]))
    optimizer = jutils.build_optimizer(params, config, jin.optimizer_config,
                                       False)
    opt_state = optimizer.init(params)
    train_step = jnc.make_steps(jmodel, optimizer, config)[0]
    topt = tutils.build_optimizer(tmodel, config, tin.optimizer_config,
                                  False)
    want, got = [], []
    for jb, tb in steps:
        params, batch_stats, opt_state, loss, _ = train_step(
            params, batch_stats, opt_state, jb.features, jb.edges, jb.idx,
            jb.targets, jb.weights, jax.random.PRNGKey(0))
        want.append(float(loss))
        got.append(float(nc.train_step(tmodel, topt, tb, 0.0,
                                       config["model"]["l2_lambda"])[0]))
        if len(got) == 1:
            # the first step's statistics, taken at equal parameters (a
            # mini-batch's padding rows among them); later ones follow
            # parameters that Adam moved by lr where a gradient is noise,
            # such as a convolution bias ahead of BatchNorm
            assert_stats_close(tmodel, batch_stats, image_dtype)
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("transform", [TRANSFORM, {"mean": [0.5] * 3}, {}],
                         ids=["mean_std", "mean_only", "none"])
def test_prepare_matches_jax(transform):
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (3, 3, 7, 5), dtype=np.uint8)
    args = (None, transform, 8, 0.0)
    want = jmrgcn.MRGCN._prepare(None, "blob.image", args,
                                 jnp.asarray(images))
    got = MRGCN._prepare("blob.image", args, torch.from_numpy(images))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-6, atol=1e-6)
    if "std" not in transform:
        np.testing.assert_array_equal(got.numpy(), images)
    geometries = rng.standard_normal((2, 9, 20)).astype(np.float32)
    want = jmrgcn.MRGCN._prepare(None, "ogc.wktLiteral", (9, 4, "S", 0.0),
                                 jnp.asarray(geometries))
    got = MRGCN._prepare("ogc.wktLiteral", (9, 4, "S", 0.0),
                         torch.from_numpy(geometries))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).transpose(0, 2, 1))


def test_weight_bridge_carries_params_and_batch_stats(am_artifact):
    """The port's state (parameters and running statistics moved by a
    train-mode forward) splits into the JAX package's two trees, and the
    JAX model given them computes the port's eval-mode logits."""
    config = make_config()
    (jin, jbatches, jmodel, variables), (tin, tbatches, tmodel) = \
        both_sides(am_artifact, config, train_labels(am_artifact))
    with torch.no_grad():
        tmodel(tbatches[0].edges, tbatches[0].features, train=True)
        got = tmodel(tbatches[0].edges, tbatches[0].features)
    sd = tmodel.state_dict()
    params, stats = state_dict_to_params(sd), state_dict_to_batch_stats(sd)
    assert jax.tree.structure(jax.tree.map(np.asarray, params)) \
        == jax.tree.structure(variables["params"])
    assert jax.tree.structure(stats) \
        == jax.tree.structure(variables["batch_stats"])
    assert sorted(stats) == ["blob_image_0", "ogc_wktLiteral_0"]
    assert not np.array_equal(
        stats["ogc_wktLiteral_0"]["_ConvBNRelu_0"]["BatchNorm_0"]["mean"],
        np.zeros(64, np.float32))
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jbatches[0].features, jbatches[0].edges)
    assert_logits_close(got, want, 2e-4)
    # and back: the same state, bit for bit
    load_jax_params(tmodel, params, stats)
    assert all(torch.equal(v, sd[k]) for k, v in tmodel.state_dict().items())


class _NoRows:
    def writerow(self, row):
        pass


@pytest.mark.parametrize("task", [{}, {"batchsize": 16}],
                         ids=["full", "minibatch"])
def test_cli_trains_the_allmodal_artifact(am_artifact, tmp_path,
                                          monkeypatch, task):
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    import chip_smoke
    cfg = tmp_path / "am.toml"
    chip_smoke.write_config(cfg, 2, 3, 16, features=chip_smoke.ALLMODAL,
                            task=task)
    res = torch_run.run_cli(["-c", str(cfg), "-i", str(am_artifact), "-o",
                             str(tmp_path), "--dry_run", "--test"])
    losses = [h["train_loss"] for h in res.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert np.isfinite(res.loss)
    assert isinstance(res.model.ogc_wktLiteral_0, enc.TCNN)
    assert isinstance(res.model.blob_image_0, enc.ImageCNN)
    assert res.model.modality_dim == 4 + 1 + 16 + 16 + 128
    stats = state_dict_to_batch_stats(res.model.state_dict())
    for module in ("ogc_wktLiteral_0", "blob_image_0"):
        bn = stats[module]
        bn = bn["_ConvBNRelu_0"] if module.startswith("ogc") else bn
        assert np.all(np.isfinite(bn["BatchNorm_0"]["mean"]))
        assert not np.array_equal(bn["BatchNorm_0"]["var"],
                                  np.ones_like(bn["BatchNorm_0"]["var"]))


def test_early_stop_restores_running_statistics(am_artifact, monkeypatch):
    """The best state early stopping keeps is ``model.state_dict()``: the
    running statistics come back with the parameters, not the last
    epoch's."""
    made, seen = [], []

    class Short(tutils.EarlyStop):
        def __init__(self, patience, tolerance):
            super().__init__(patience, tolerance, delay=1)
            made.append(self)

        def record(self, score, state):
            seen.append(tutils._to_host(state[0]))
            super().record(score, state)

    monkeypatch.setattr(tutils, "EarlyStop", Short)
    config = make_config(epochs=30)
    config["task"]["early_stopping"] = {"patience": 1, "tolerance": 10.0}
    res = nc.run(artifact_io.load(str(am_artifact)), config, _NoRows(),
                 False, "valid", 0, CPU)
    stop = made[-1]
    assert stop.stop and res.epoch < 30
    best, last = stop.best_state[0], seen[-1]
    final = res.model.state_dict()
    assert all(torch.equal(v, best[k]) for k, v in final.items())
    moved = [k for k in best
             if k.endswith(".mean") and not torch.equal(best[k], last[k])]
    assert moved and all("BatchNorm_" in k for k in moved)


def test_image_backbone_on_disk_raises(tmp_path, monkeypatch):
    """An image ``model`` spec with a MobileNetV2 checkpoint on disk (which
    raised before ROADMAP item 3c) builds the frozen backbone with its
    head, from ``MRGCN_VISION_WEIGHTS`` or the torch.hub cache, exactly
    where the JAX package's ``load_image_backbone`` takes it, and the
    backbone holds the file's feature tensors bit for bit; without a checkpoint,
    or without a model spec, the model takes ``ImageCNN``. (The encoder's
    numbers against the JAX package's on one checkpoint and head:
    ``tests/test_torch_pretrained.py``.)"""
    from mrgcn_tpu.models import mobilenet as jmobilenet
    from mrgcn_tpu_torch.models.pretrained import PretrainedImageEncoder
    from mrgcn_tpu_torch.tasks.synthetic import save_mobilenet_checkpoint
    spec = ["pytorch/vision:v0.10.0", "mobilenet_v2"]
    args = (spec, TRANSFORM, 8, 0.0)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "hub_home"))
    monkeypatch.delenv("MRGCN_VISION_WEIGHTS", raising=False)

    def build(model_cfg_args):
        return MRGCN(hidden_dims=(4, 2),
                     modules_config=(("blob.image", model_cfg_args),),
                     num_relations=3, num_nodes=5,
                     generator=torch.Generator(), featureless=False)

    assert isinstance(build(args).blob_image_0, enc.ImageCNN)
    assert jmobilenet.load_image_backbone(spec) is None
    # as many input channels as the image mode has bands
    grey = build((None, {"mode": "L"}, 8, 0.0)).blob_image_0
    assert grey.Conv_0.kernel.shape == (3, 3, 1, 32)
    assert build(args).blob_image_0.Conv_0.kernel.shape == (3, 3, 3, 32)
    weights = tmp_path / "mobilenet_v2-b0353104.pth"
    save_mobilenet_checkpoint(weights, seed=0)
    stored = torch.load(weights, weights_only=True)
    monkeypatch.setenv("MRGCN_VISION_WEIGHTS", str(weights))
    encoder = build(args).blob_image_0
    assert isinstance(encoder, PretrainedImageEncoder)
    assert jmobilenet.load_image_backbone(spec) is not None
    held = encoder.backbone.state_dict()
    # all of the file but torchvision's classifier, which no feature uses
    assert sorted(held) == sorted(k for k in stored
                                  if not k.startswith("classifier."))
    assert all(torch.equal(v, stored[k]) for k, v in held.items())
    # no model spec: the from-scratch CNN, whatever is on disk
    assert isinstance(build((None, TRANSFORM, 8, 0.0)).blob_image_0,
                      enc.ImageCNN)
    # the torch.hub cache counts as on disk
    monkeypatch.delenv("MRGCN_VISION_WEIGHTS")
    cache = tmp_path / "hub_home" / "hub" / "checkpoints"
    cache.mkdir(parents=True)
    weights.rename(cache / weights.name)
    assert isinstance(build(args).blob_image_0, PretrainedImageEncoder)
    assert jmobilenet.load_image_backbone(spec) is not None
