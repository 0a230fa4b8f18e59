"""``configs/dmg_reference.toml``'s sections in mini-batches of 32, the
port against the JAX package on the CPU.

The config's own ``[task]``, ``[model]`` (hidden 16, 40 bases,
``gates_lr``) and every ``[[graph.features]]``: numeric, date, boolean,
gYear, string through ``distilbert-base-multilingual-cased`` (here a tiny
random DistilBERT under that name in an offline hub cache: width 32, 2
layers), images through MobileNetV2 (a random torchvision ``.pth``, 32 x
32 images) and WKT through a ``TCNN`` whose BatchNorm trains. The graph
has 400 nodes; its features are ``tasks/synthetic.multimodal_features``'
draws with the date and boolean sets. Held:

* both packages' mini-batches, array for array: the edge blocks, every
  encoder's bucket-padded rows (uint8 images, token ids), their node
  maps and placement rows, the labels;
* the first step from the JAX model's initial state: the loss within
  rtol 1e-4, every gradient within 1e-4 of its largest entry. The
  ``TCNN`` is held as ``tests/test_torch_lp_features.py`` holds it (the
  JAX package's compiled TCNN gradient is wrong on XLA:CPU): the port's
  gradients within 1e-4 of the largest entry of the port's float64 ones
  on the step's own input and cotangent (by norm within 1e-2 where a
  ReLU input lies on the other side of zero in float32 than in float64:
  counted; the test's batch has one, 9.4e-7 from zero, and sits at
  6.4e-5 by norm), and the JAX TCNN differentiated op by op in float64
  within 1e-8 of the largest entry;
* the running statistics after that step, within 1e-6. The batch's
  zero padding rows enter them in both packages;
* the optimizer step from the port's first-step gradients: the port's
  ``ClippedAdam`` and the JAX package's optax chain land within 1e-4 of
  the learning rate of each other (1.2e-5 measured: one f32 step);
* the eval-mode logits of a batch from the stepped parameters and the
  JAX step's running statistics, within 1e-5 of the largest.

And ``multimodal_features``' draws: without dates and booleans they are
the arrays they were before the two sets were added (a pinned digest);
with them every earlier set stays bit-equal, and both packages'
``setup_features`` turn the seven sets into the same encoder configs and
arrays.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import copy  # noqa: E402
import hashlib  # noqa: E402
import tomllib  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402

from mrgcn_tpu.config import apply_defaults  # noqa: E402
from mrgcn_tpu.data import artifact as jax_artifact_io  # noqa: E402
from mrgcn_tpu.encodings import features as jfeatures  # noqa: E402
from mrgcn_tpu.tasks import node_classification as jnc  # noqa: E402
from mrgcn_tpu.tasks import utils as jutils  # noqa: E402
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs  # noqa: E402
from mrgcn_tpu_torch.data import artifact as artifact_io  # noqa: E402
from mrgcn_tpu_torch.encodings import features as tfeatures  # noqa: E402
from mrgcn_tpu_torch.models import pretrained  # noqa: E402
from mrgcn_tpu_torch.models.encoders import TCNN  # noqa: E402
from mrgcn_tpu_torch.tasks import node_classification as nc  # noqa: E402
from mrgcn_tpu_torch.tasks import synthetic  # noqa: E402
from mrgcn_tpu_torch.tasks import utils as tutils  # noqa: E402
from mrgcn_tpu_torch.tasks.common import prepare_inputs  # noqa: E402
from mrgcn_tpu_torch.tasks.jax_import import (  # noqa: E402
    load_jax_params, params_to_state_dict, state_dict_to_batch_stats,
    state_dict_to_params)

from tests.test_torch_batching import assert_blocks_equal  # noqa: E402
from tests.test_torch_lp_features import (encoder_grads,  # noqa: E402
                                          jax_encoder_grads_f64)
from tests.test_torch_minibatch_slice import assert_features_equal  # noqa: E402
from tests.test_torch_multimodal_slice import small_workload  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
BATCHSIZE = 32
TINY = dict(synthetic.DISTILBERT_MULTILINGUAL, dim=32, n_layers=2, n_heads=2,
            hidden_dim=64, vocab_size=1200, max_position_embeddings=64)
WKT = "ogc_wktLiteral_0"
# multimodal_features(**DRAWS) before the date and boolean sets existed
DRAWS = dict(num_nodes=500, seed=3, num_numeric=50, num_years=20,
             num_strings=10, max_len=16, num_geometries=7, num_images=3,
             image_size=8, wordpiece_vocab=1200)
DRAWS_SHA256 = \
    "4e3ef03b853b56a0aeaee65c106ebd10e3711ddfdf39556942f09a2d65482684"


def reference_config():
    """``configs/dmg_reference.toml`` with the JAX package's defaults and
    the seed 0 (the file draws one)."""
    with open(REPO / "configs" / "dmg_reference.toml", "rb") as f:
        config = tomllib.load(f)
    config["task"]["seed"] = 0
    return apply_defaults(config)


def reference_features(n, **extra):
    """The seven datatypes' sets at the test's counts."""
    return synthetic.multimodal_features(
        n, seed=0, num_numeric=120, num_years=60, num_strings=40, max_len=8,
        num_geometries=60, num_images=16, image_size=32,
        wordpiece_vocab=TINY["vocab_size"], num_dates=60, num_booleans=60,
        **extra)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both packages' inputs, mini-batches and models on the reference
    config, the JAX model's initial state in the port. The hub stays
    offline and patched for the module's tests: flax loads the text
    backbone at each trace."""
    pytest.importorskip("transformers")
    import huggingface_hub.constants as hub_constants
    import transformers.utils.hub as transformers_hub
    tmp = tmp_path_factory.mktemp("dmg_reference")
    cache = tmp / "hub"
    cache.mkdir()
    synthetic.save_text_backbone_snapshot(cache, config=TINY)
    pth = tmp / "mobilenet_v2-test.pth"
    synthetic.save_mobilenet_checkpoint(pth, seed=0)
    w = small_workload()
    path = str(tmp / "reference.npz")
    synthetic.save_nc_artifact(
        path, w["n"], w["R"], w["src"], w["dst"], w["rel"], w["norm"],
        w["labels_idx"], w["labels_cls"], w["num_classes"], seed=0,
        num_eval=40, F=reference_features(w["n"]))
    with pytest.MonkeyPatch.context() as mp:
        for name in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE"):
            mp.setenv(name, "1")
        mp.setenv("HF_HUB_CACHE", str(cache))
        mp.setenv("MRGCN_VISION_WEIGHTS", str(pth))
        mp.setattr(hub_constants, "HF_HUB_OFFLINE", True)
        mp.setattr(hub_constants, "HF_HUB_CACHE", str(cache))
        mp.setattr(transformers_hub, "_is_offline_mode", True)
        mp.setattr(transformers_hub, "TRANSFORMERS_CACHE", str(cache))
        config = reference_config()
        art, jart = artifact_io.load(path), jax_artifact_io.load(path)
        C = len(art.class_map)
        Y = np.concatenate([np.asarray(art.Y[s]).reshape(-1, 2)
                            for s in ("train", "valid")])
        jin = jax_prepare_inputs(jart, config, False)
        tin = prepare_inputs(art, config, False, CPU)
        jbatches = jnc.make_batches(jin, Y, BATCHSIZE, 2)
        tbatches = nc.make_batches(tin, Y, BATCHSIZE, 2)
        jmodel = jnc.build_model(jin, config, C)
        variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                         jbatches[0].features,
                                         jbatches[0].edges)
        tmodel = nc.build_model(tin, config, C,
                                torch.Generator().manual_seed(1))
        yield (config, (jin, jbatches, jmodel, variables),
               (tin, tbatches, tmodel))


def fresh(sides):
    """The port model reset to the JAX model's initial state."""
    _, (_, _, _, variables), (_, _, tmodel) = sides
    load_jax_params(tmodel, jax.tree.map(np.asarray, variables["params"]),
                    jax.tree.map(np.asarray, variables["batch_stats"]))
    return tmodel


def test_reference_minibatches_equal_jax(sides):
    config, (jin, jbatches, _, _), (tin, tbatches, tmodel) = sides
    assert config["task"]["batchsize"] == BATCHSIZE
    assert tin.modules_config == tuple(jin.modules_config)
    assert tmodel.names == ("blob_image_0", WKT, "xsd_boolean_0",
                            "xsd_date_0", "xsd_gYear_1", "xsd_numeric_1",
                            "xsd_string_0")
    assert isinstance(tmodel.xsd_string_0, pretrained.PretrainedTextEncoder)
    assert isinstance(tmodel.blob_image_0,
                      pretrained.PretrainedImageEncoder)
    assert isinstance(getattr(tmodel, WKT), TCNN)
    assert len(tbatches) == len(jbatches) == -(-(60 + 40) // BATCHSIZE)
    for a, b in zip(tbatches, jbatches):
        assert a.num_real == b.num_real
        assert_blocks_equal(a.edges, b.edges)
        assert_features_equal(a.features, b.features)
        for name in ("idx", "targets", "weights"):
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          np.asarray(getattr(b, name)), name)
    first = tbatches[0].features
    assert sorted(first) == sorted(tmodel.names)
    assert first["blob_image_0"][0].dtype == torch.uint8
    assert first["xsd_string_0"][0].dtype == torch.int32
    # every encoder's rows are bucket-padded: the WKT rows' zero padding
    # is what enters the TCNN's batch statistics
    rows = first[WKT][0]
    real = int((first[WKT][1] < 2 ** 30).sum())
    assert rows.shape[0] == 64 and 0 < real < 64
    assert not bool(rows[real:].any())


@pytest.fixture(scope="module")
def first_step(sides):
    """The first training batch's step from the JAX model's initial state
    in both packages: the JAX loss, gradients and running statistics
    (compiled), the port model after ``nc.loss_and_grads`` with each
    TCNN input and output cotangent it saw, and its loss."""
    config, (_, jbatches, jmodel, variables), (_, tbatches, _) = sides
    l1, l2 = config["model"]["l1_lambda"], config["model"]["l2_lambda"]
    jb = jbatches[0]

    def loss_fn(p):
        out, updates = jmodel.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jb.features, jb.edges, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        loss = jnc._loss_and_metrics(out, jb.idx, jb.targets, jb.weights)[0]
        return loss + jutils.regularization(p, l1, l2), \
            updates["batch_stats"]

    (want, stats), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                      has_aux=True))(
        variables["params"])
    tmodel = fresh(sides)
    seen = {}

    def keep(module, args, out):
        seen["x"] = args[0].detach()
        out.register_hook(lambda g: seen.__setitem__("cot", g))

    hook = getattr(tmodel, WKT).register_forward_hook(keep)
    got = nc.loss_and_grads(tmodel, tbatches[0], l1, l2)[0]
    hook.remove()
    return {"want": float(want), "grads": grads, "stats": stats,
            "got": float(got), "model": tmodel, "seen": seen}


def relu_flips(tcnn, x) -> int:
    """The ReLU inputs (each BatchNorm's output) of a train-mode copy of
    ``tcnn`` on ``x`` that lie on the other side of zero in float32 than
    in float64."""
    sides = []
    for dtype in (torch.float32, torch.float64):
        module = copy.deepcopy(tcnn).to(dtype)
        seen = []
        for name, m in module.named_modules():
            if name.endswith("BatchNorm_0"):
                m.register_forward_hook(
                    lambda _m, _a, y: seen.append(y.detach() > 0))
        with torch.no_grad():
            module(x.to(dtype), train=True)
        sides.append(seen)
    return sum(int((a != b).sum()) for a, b in zip(*sides))


def test_reference_first_step_matches_jax(sides, first_step):
    _, (jin, _, _, variables), _ = sides
    step = first_step
    np.testing.assert_allclose(step["got"], step["want"], rtol=1e-4)
    want_grads = params_to_state_dict(step["grads"])
    named = dict(step["model"].named_parameters())
    assert sorted(named) == sorted(want_grads)
    for name, p in named.items():
        if name.startswith(WKT + "."):
            continue
        w = want_grads[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    # the gates of the date and boolean encoders carry a gradient
    for i, name in enumerate(step["model"].names):
        if name in ("xsd_date_0", "xsd_boolean_0"):
            assert float(named["gate_weights"].grad[i]) != 0.0, name
    x, cot = step["seen"]["x"], step["seen"]["cot"]
    tcnn = getattr(step["model"], WKT)
    exact = encoder_grads(tcnn, x, cot, torch.float64)
    scale = max(float(g.abs().max()) for g in exact.values())
    port = {n[len(WKT) + 1:]: p.grad.double() for n, p in named.items()
            if n.startswith(WKT + ".")}
    assert sorted(port) == sorted(exact)
    if relu_flips(tcnn, x):
        err = (sum(float((port[n] - g).square().sum())
                   for n, g in exact.items())
               / sum(float(g.square().sum()) for g in exact.values())) ** 0.5
        assert err <= 1e-2, err
    else:
        err = max(float((port[n] - g).abs().max())
                  for n, g in exact.items())
        assert err <= 1e-4 * scale, (err, scale)
    args = dict(zip(step["model"].names, jin.modules_config))[WKT][1]
    theirs = jax_encoder_grads_f64(WKT, args, variables, x, cot)
    assert sorted(theirs) == sorted(exact)
    err = max(float((theirs[n] - g).abs().max()) for n, g in exact.items())
    assert err <= 1e-8 * scale, (err, scale)


def test_reference_first_step_statistics_match_jax(first_step):
    want = params_to_state_dict(first_step["stats"])
    got = params_to_state_dict(state_dict_to_batch_stats(
        first_step["model"].state_dict()))
    assert sorted(got) == sorted(want) and got
    assert all(k.startswith(WKT + ".") for k in got)
    for k, w in want.items():
        assert not torch.equal(got[k], torch.zeros_like(got[k])) \
            or k.endswith(".var")
        err = float((got[k] - w).abs().max())
        assert err <= 1e-6, (k, err)


def test_reference_step_and_eval_logits_match_jax(sides, first_step):
    """From the port's first-step gradients, the port's optimizer
    (``ClippedAdam``: the clip, the encoders' and the gates' groups) and
    the JAX package's step to the same parameters; given those and the
    JAX step's running statistics, the port gives a batch's eval-mode
    logits. (The JAX package's own TCNN gradients are not fed to either
    side: compiled, they are wrong, and Adam's first step moves each
    entry by the learning rate times the sign of its gradient.)"""
    config, (jin, jbatches, jmodel, variables), (tin, tbatches, _) = sides
    optimizer = jutils.build_optimizer(variables["params"], config,
                                       jin.optimizer_config, False)

    @jax.jit
    def stepped(params, grads):
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        return jax.tree.map(lambda p, u: p + u, params, updates)

    model = first_step["model"]
    grads = state_dict_to_params({n: p.grad
                                  for n, p in model.named_parameters()})
    params = stepped(variables["params"], grads)
    stats = first_step["stats"]
    tutils.build_optimizer(model, config, tin.optimizer_config,
                           False).step()
    want = params_to_state_dict(params)
    lr = config["model"]["learning_rate"]
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 1e-4 * lr, (name, err)
    tmodel = fresh(sides)
    load_jax_params(tmodel, jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, stats))
    jb, tb = jbatches[1], tbatches[1]
    want = np.asarray(jax.jit(lambda p, s, f, e: jmodel.apply(
        {"params": p, "batch_stats": s}, f, e, train=False))(
            params, stats, jb.features, jb.edges))
    with torch.no_grad():
        tmodel.eval()
        got = tmodel(tb.edges, tb.features).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err


def draws_digest(F) -> str:
    """sha256 over every set of ``F`` in datatype order: each array's
    bytes, the object arrays' entries one by one."""
    h = hashlib.sha256()
    for datatype in sorted(F):
        for enc, idx, lengths in F[datatype]:
            h.update(datatype.encode())
            parts = list(enc) if enc.dtype == object else [enc]
            for part in (*parts, idx, np.asarray(lengths)):
                h.update(np.ascontiguousarray(part).tobytes())
    return h.hexdigest()


def test_draws_without_dates_or_booleans_are_unchanged():
    F = synthetic.multimodal_features(**DRAWS)
    assert "xsd.date" not in F and "xsd.boolean" not in F
    assert draws_digest(F) == DRAWS_SHA256
    more = synthetic.multimodal_features(**DRAWS, num_dates=9,
                                         num_booleans=11)
    assert draws_digest({k: more[k] for k in F}) == DRAWS_SHA256
    dates, date_nodes, date_lengths = more["xsd.date"][0]
    booleans, _, boolean_lengths = more["xsd.boolean"][0]
    assert dates.shape == (9, synthetic.DATE_WIDTH)
    assert dates.dtype == booleans.dtype == np.float32
    assert (date_lengths == synthetic.DATE_WIDTH).all()
    assert booleans.shape == (11, 1) and set(booleans.ravel()) <= {-1, 1}
    assert (boolean_lengths == 1).all()
    assert (np.diff(date_nodes) > 0).all()
    # the century column scaled to [-1, 1], the rest on the unit circle
    assert dates[:, 1].min() == -1.0 and dates[:, 1].max() == 1.0
    np.testing.assert_allclose(np.hypot(dates[:, 2::2], dates[:, 3::2]),
                               1.0, rtol=1e-6)


def test_reference_features_set_up_the_same_encoders():
    """The seven sets through both packages' ``setup_features`` (its
    ``construct_feature_matrix``) under the reference config's feature
    sections: the same encoder configs, optimizer groups, width and
    arrays."""
    config = reference_config()
    F = reference_features(400)
    got = tfeatures.setup_features(F, 400, False, config)
    want = jfeatures.setup_features(F, 400, False, config)
    X, width, modules, optim = got
    assert width == want[1] == 4 + 3 + 4 + 1 + 16 + 128 + 16
    assert modules == want[2]
    assert ("xsd.date", (synthetic.DATE_WIDTH, 3, 0.0)) in modules
    assert ("xsd.boolean", (1, 4, 0.0)) in modules
    assert optim == want[3]
    assert optim["gate_weights"] == {"lr": 0.01}
    assert [d for d, _ in X[1:]] == [d for d, _ in want[0][1:]]
    for (_, sets), (_, their_sets) in zip(X[1:], want[0][1:]):
        for ours, theirs in zip(sets, their_sets):
            for a, b in zip(ours, theirs):
                if a.dtype == object:
                    assert all(np.array_equal(x, y) for x, y in zip(a, b))
                else:
                    np.testing.assert_array_equal(a, b)
