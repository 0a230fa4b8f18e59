"""Checkpoints: the port writes and reads the JAX package's file.

A checkpoint is a pickle-free ``.npz`` (``params/...``, ``batch_stats/...``,
``opt_state/...``, ``meta/epoch``, ``meta/loss``, ``__empty__`` markers
where the JAX tree has an empty node). Held against ``mrgcn_tpu``:

* the same file from both packages: for the same model and config, the
  port's file has exactly the keys, shapes and dtypes of the JAX
  package's, featureless and over all five modalities with a ``gates``
  group and a datatype group with ``weight_decay > 0``;
* resuming across packages, both ways, through each package's ``run``:
  the JAX package saves after 2 epochs and the port resumes for 1, then
  the port saves and the JAX package resumes; the third epoch's loss
  agrees (rtol 1e-4 featureless, 1e-3 over all five modalities with the
  image CNN's body in f32), the running statistics within 1e-6, and the
  epoch is 3;
* AMSGrad: the port's state (``nu_max`` as ``max_exp_avg_sq``) makes the
  round trip, with and without weight decay (two chain layouts), and the
  JAX package's ``restore_opt_state`` accepts it against
  ``optimizer.init`` (stepping is not held: the JAX package's AMSGrad
  fails at its first donated step, ROADMAP Queue 3);
* a resumed port run equals an unbroken one (``p_dropout`` 0, rtol 1e-6);
* link prediction: the JAX package saves, the port resumes with equal
  eval-mode ranks, and its epochs count on from the file's;
* refusals: a legacy pickle checkpoint, a flax-MHA or split-QKV text tree
  (ROADMAP item 3c), a file that does not fit the model;
* the CLI: ``--save_checkpoint`` writes ``<base>_model_state_<epoch>.npz``
  and ``--load_checkpoint`` prints ``[LOAD]``.
"""

import functools
import pickle

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
from mrgcn_tpu.tasks import link_prediction as jlp
from mrgcn_tpu.tasks import node_classification as jnc
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
from mrgcn_tpu_torch import run as torch_run
from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.models import encoders as enc
from mrgcn_tpu_torch.models import mrgcn as tmrgcn
from mrgcn_tpu_torch.tasks import link_prediction as lp
from mrgcn_tpu_torch.tasks import node_classification as nc
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import (params_to_state_dict,
                                              state_dict_to_batch_stats,
                                              state_dict_to_params)
from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                             save_lp_artifact,
                                             save_nc_artifact)

CPU = torch.device("cpu")
TRANSFORM = {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
ALLMODAL = [
    {"datatype": "xsd.numeric", "include": True, "embedding_dim": 4,
     "optim_weight_decay": 0.01},
    {"datatype": "xsd.gYear", "include": True, "embedding_dim": 2},
    {"datatype": "xsd.string", "include": True, "embedding_dim": 8},
    {"datatype": "ogc.wktLiteral", "include": True, "embedding_dim": 4},
    {"datatype": "blob.image", "include": True, "embedding_dim": 72,
     "transform": TRANSFORM},
]


class Rows:
    """A TSV writer that keeps its rows."""

    def __init__(self):
        self.rows = []

    def writerow(self, row):
        self.rows.append(list(row))


def train_losses(rows):
    """The per-epoch training losses of an NC TSV (test row dropped)."""
    return [float(r[1]) for r in rows[1:] if r[0] != "-1"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Small featureless and all-modality NC graphs (numpy, seed 0)."""
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for kind, n, edges, labeled in (("featureless", 400, 2400, 60),
                                    ("allmodal", 300, 1800, 48)):
        w = build_workload(n=n, num_props=4, num_edges=edges, hidden=16,
                           num_classes=5, num_bases=3, num_labeled=labeled,
                           seed=0)
        F = multimodal_features(
            n, seed=0, num_numeric=100, num_years=60, num_strings=40,
            max_len=12, num_geometries=50, num_images=30, image_size=32) \
            if kind == "allmodal" else None
        path = str(d / f"{kind}.npz")
        save_nc_artifact(path, w["n"], w["R"], w["src"], w["dst"], w["rel"],
                         w["norm"], w["labels_idx"], w["labels_cls"],
                         w["num_classes"], seed=0, num_eval=30, F=F)
        out[kind] = path
    return out


def make_config(kind, epochs=2, features=None, **model):
    feats = features if features is not None else \
        (ALLMODAL if kind == "allmodal" else [])
    return apply_defaults({
        "name": "CK", "graph": {"features": [dict(f) for f in feats]},
        "task": {"type": "node classification", "seed": 0},
        "model": {"epoch": epochs, "num_bases": 3, "l2_lambda": 5e-4,
                  "gates_lr": 0.01, **model,
                  "layers": [{"hidden_nodes": 16}, {"type": "mrgcn"}]}})


@pytest.fixture
def f32_image_body(monkeypatch):
    """The image CNN's body in f32 in both packages (flax builds it at each
    ``apply``, so the patch stays for the test)."""
    monkeypatch.setattr(jmrgcn, "ImageCNN", functools.partial(
        jenc.ImageCNN, dtype=jnp.float32))
    monkeypatch.setattr(tmrgcn, "ImageCNN", functools.partial(
        enc.ImageCNN, dtype=torch.float32))


def layout(path):
    with np.load(path) as npz:
        return {k: (npz[k].shape, npz[k].dtype) for k in npz.files}


@pytest.mark.parametrize("kind", ["featureless", "allmodal"])
def test_port_file_has_the_jax_packages_layout(artifacts, tmp_path, kind):
    """Both packages save the same model after one optimizer step (all
    gradients one) with the same config: equal keys, shapes and dtypes."""
    config = make_config(kind)
    featureless = kind == "featureless"
    art = artifact_io.load(artifacts[kind])
    jin = jax_prepare_inputs(jax_artifact_io.load(artifacts[kind]), config,
                             featureless)
    jmodel = jnc.build_model(jin, config, len(art.class_map))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jin.features, jin.edges)
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          shapes["params"])
    stats = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         shapes.get("batch_stats", {}))
    optimizer = jutils.build_optimizer(params, config, jin.optimizer_config,
                                       featureless)
    init = jax.jit(optimizer.init)
    _, opt_state = jax.jit(optimizer.update)(
        jax.tree.map(jnp.ones_like, params), init(params), params)
    jutils.save_checkpoint(str(tmp_path / "jax.npz"), 2, params, opt_state,
                           stats, 0.5)

    tin = prepare_inputs(art, config, featureless, CPU)
    tmodel = nc.build_model(tin, config, len(art.class_map),
                            torch.Generator().manual_seed(0))
    topt = tutils.build_optimizer(tmodel, config, tin.optimizer_config,
                                  featureless)
    for p in tmodel.parameters():
        p.grad = torch.ones_like(p)
    topt.step()
    tutils.save_checkpoint(str(tmp_path / "port.npz"), 2, tmodel, topt, 0.5)

    mine, theirs = layout(tmp_path / "port.npz"), layout(tmp_path / "jax.npz")
    assert sorted(mine) == sorted(theirs)
    assert mine == theirs
    labels = {k.split("/")[3] for k in mine
              if k.startswith("opt_state/1/inner_states/")}
    if featureless:
        assert labels == {"default"}
        assert "batch_stats/__empty__" in mine
    else:
        assert labels == {"default", "gates", "xsd.numeric", "xsd.gYear",
                          "xsd.string", "ogc.wktLiteral", "blob.image"}
        # weight decay puts add_decayed_weights' empty state first
        assert "opt_state/1/inner_states/xsd.numeric/inner_state/0/" \
               "__empty__" in mine
        assert mine["opt_state/1/inner_states/xsd.numeric/inner_state/1/0/"
                    "count"] == ((), np.dtype(np.int32))
    assert mine["meta/epoch"] == ((), np.dtype(np.int64))
    assert mine["meta/loss"] == ((), np.dtype(np.float64))
    # the JAX package reads the port's file back into its optimizer
    state = jutils.load_checkpoint(str(tmp_path / "port.npz"))
    restored = jutils.restore_opt_state(init(params), state["opt_state"])
    assert jax.tree.structure(restored) == jax.tree.structure(opt_state)


def _stats_err(port_model, jax_stats):
    want = params_to_state_dict(jax_stats)
    got = params_to_state_dict(state_dict_to_batch_stats(
        port_model.state_dict()))
    assert sorted(got) == sorted(want)
    return max((float((got[k] - w).abs().max()) for k, w in want.items()),
               default=0.0)


@pytest.mark.parametrize("kind,rtol", [("featureless", 1e-4),
                                       ("allmodal", 1e-3)])
def test_resume_across_packages(artifacts, tmp_path, f32_image_body, kind,
                                rtol):
    featureless = kind == "featureless"
    jart = jax_artifact_io.load(artifacts[kind])
    art = artifact_io.load(artifacts[kind])

    def jax_run(epochs, checkpoint=None):
        rows = Rows()
        state, epoch, loss, *_ = jnc.run(
            jart, make_config(kind, epochs), rows, featureless, "test",
            checkpoint, 0)
        return state, epoch, loss, train_losses(rows.rows)

    def port_run(epochs, checkpoint=None):
        return nc.run(art, make_config(kind, epochs), Rows(), featureless,
                      "test", 0, CPU, checkpoint=checkpoint)

    # the JAX package writes, both resume
    (params, opt_state, stats), epoch, loss, _ = jax_run(2)
    jax_file = str(tmp_path / "jax.npz")
    jutils.save_checkpoint(jax_file, epoch, params, opt_state, stats, loss)
    (_, _, want_stats), want_epoch, _, want = jax_run(1, jax_file)
    got = port_run(1, jax_file)
    assert want_epoch == got.epoch == 3
    assert [h["epoch"] for h in got.history] == [3]
    np.testing.assert_allclose([h["train_loss"] for h in got.history], want,
                               rtol=rtol)
    assert _stats_err(got.model, want_stats) <= 1e-6

    # the port writes, both resume
    first = port_run(2)
    port_file = str(tmp_path / "port.npz")
    tutils.save_checkpoint(port_file, first.epoch, first.model,
                           first.optimizer, first.loss)
    (_, _, want_stats), want_epoch, _, want = jax_run(1, port_file)
    got = port_run(1, port_file)
    assert want_epoch == got.epoch == 3
    np.testing.assert_allclose([h["train_loss"] for h in got.history], want,
                               rtol=rtol)
    assert _stats_err(got.model, want_stats) <= 1e-6


@pytest.mark.parametrize("decay", [0.0, 0.1], ids=["no_decay", "decay"])
def test_amsgrad_state_round_trip(artifacts, tmp_path, decay):
    feature = {"datatype": "xsd.numeric", "include": True,
               "embedding_dim": 4, "optim_amsgrad": True,
               "optim_weight_decay": decay}
    config = make_config("allmodal", features=[feature])
    art = artifact_io.load(artifacts["allmodal"])
    tin = prepare_inputs(art, config, False, CPU)
    batch = nc.make_batches(tin, np.asarray(art.Y["train"]).reshape(-1, 2),
                            -1, 2)[0]

    def fresh():
        model = nc.build_model(tin, config, len(art.class_map),
                               torch.Generator().manual_seed(0))
        return model, tutils.build_optimizer(model, config,
                                             tin.optimizer_config, False)

    model, opt = fresh()
    for _ in range(2):
        nc.train_step(model, opt, batch, 0.0, 5e-4)
    path = str(tmp_path / "amsgrad.npz")
    tutils.save_checkpoint(path, 2, model, opt, 0.0)
    keys = layout(path)
    at = f"opt_state/1/inner_states/xsd.numeric/inner_state/{int(decay > 0)}"
    assert f"{at}/count" in keys and f"{at}/nu_max/xsd_numeric_0/Dense_0/" \
        "kernel" in keys and f"{at[:-1]}{int(decay > 0) + 1}/__empty__" in keys

    back, back_opt = fresh()
    assert tutils.restore_checkpoint(back, back_opt,
                                     tutils.load_checkpoint(path)) == 2
    for name, p in model.named_parameters():
        q = dict(back.named_parameters())[name]
        assert torch.equal(p, q)
        have, want = back_opt.adam.state[q], opt.adam.state[p]
        keys = {"step", "exp_avg", "exp_avg_sq"} | (
            {"max_exp_avg_sq"} if name.startswith("xsd_") else set())
        assert set(have) == set(want) == keys, name
        for key in keys:
            assert torch.equal(have[key], want[key]), (name, key)

    # the JAX package accepts it against its own optimizer's init
    jin = jax_prepare_inputs(jax_artifact_io.load(artifacts["allmodal"]),
                             config, False)
    state = jutils.load_checkpoint(path)
    params = jax.tree.map(jnp.asarray, state["params"])
    optimizer = jutils.build_optimizer(params, config, jin.optimizer_config,
                                       False)
    template = optimizer.init(params)
    restored = jutils.restore_opt_state(template, state["opt_state"])
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    inner = restored[1].inner_states["xsd.numeric"].inner_state
    moments = inner[int(decay > 0)]
    np.testing.assert_array_equal(
        np.asarray(moments["nu_max"]["xsd_numeric_0"]["Dense_0"]["kernel"]),
        opt.adam.state[model.xsd_numeric_0.Dense_0.kernel]
        ["max_exp_avg_sq"].numpy())
    assert int(moments["count"]) == 2


def test_resumed_run_equals_unbroken(artifacts, tmp_path):
    art = artifact_io.load(artifacts["featureless"])
    config = make_config("featureless", 3)
    assert config["model"]["p_dropout"] == 0
    whole = nc.run(art, config, Rows(), True, "test", 0, CPU)
    first = nc.run(art, make_config("featureless", 2), Rows(), True, "test",
                   0, CPU)
    path = str(tmp_path / "two.npz")
    tutils.save_checkpoint(path, first.epoch, first.model, first.optimizer,
                           first.loss)
    rest = nc.run(art, make_config("featureless", 1), Rows(), True, "test",
                  0, CPU, checkpoint=path)
    assert rest.epoch == whole.epoch == 3
    np.testing.assert_allclose(
        [h["train_loss"] for h in first.history + rest.history],
        [h["train_loss"] for h in whole.history], rtol=1e-6)
    np.testing.assert_allclose(rest.loss, whole.loss, rtol=1e-6)
    for (name, a), b in zip(whole.model.state_dict().items(),
                            rest.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.fixture(scope="module")
def lp_artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt_lp") / "lp.npz")
    save_lp_artifact(path, num_nodes=120, num_props=4, num_train=600,
                     num_valid=80, num_test=90, seed=0)
    return path


def lp_config(epochs):
    return apply_defaults({
        "name": "LPCK", "graph": {},
        "task": {"type": "link prediction", "seed": 0, "eval_interval": 2},
        "model": {"epoch": epochs, "num_bases": 2,
                  "layers": [{"hidden_nodes": 16}, {"hidden_nodes": 16},
                             {"type": "mrgcn"}]}})


def test_lp_resume_across_packages(lp_artifact, tmp_path):
    """The JAX package trains 2 LP epochs and saves; the port loads the
    file and ranks the test split with the JAX run's final ranks (eval
    mode, the same parameters), and its epochs count on from 3."""
    state, epoch, loss, _, _, want = jlp.run(
        jax_artifact_io.load(lp_artifact), lp_config(2), Rows(), True,
        "test", None, 0)
    path = str(tmp_path / "lp.npz")
    jutils.save_checkpoint(path, epoch, *state, loss)
    art = artifact_io.load(lp_artifact)
    got = lp.run(art, lp_config(0), Rows(), True, "test", 0, CPU,
                 checkpoint=path)
    assert got.epoch == 2 and not got.history
    for kind in ("raw", "flt"):
        assert len(got.ranks[kind]) == 2 * 90
        np.testing.assert_array_equal(got.ranks[kind], want[kind])
    rows = Rows()
    more = lp.run(art, lp_config(2), rows, True, "test", 0, CPU,
                  checkpoint=path)
    assert [h["epoch"] for h in more.history] == [3, 4] and more.epoch == 4
    # eval_interval 2 counts absolute epochs: epoch 4 ranks train
    assert rows.rows[1][2] == -1 and rows.rows[2][2] != -1


def _npz(path, flat):
    with open(path, "wb") as f:
        np.savez(f, **flat)


@pytest.mark.parametrize("marker,flavour", [
    ("MultiHeadDotProductAttention_0", "flax-MHA"),
    ("query", "split-QKV")])
def test_unbuildable_text_tree_names_item_3c(tmp_path, marker, flavour):
    flat = {"meta/epoch": np.asarray(1, np.int64),
            "meta/loss": np.asarray(0.0, np.float64)}
    tutils._flatten_state({"xsd_string_0": {"_TextBlock_0": {
        marker: {"kernel": np.zeros((4, 4), np.float32)}}}}, "params", flat)
    path = str(tmp_path / "text.npz")
    _npz(path, flat)
    with pytest.raises(NotImplementedError, match="item 3c") as err:
        tutils.load_checkpoint(path)
    assert flavour in str(err.value)
    # the fused-QKV tree the port builds loads
    flat = {k: v for k, v in flat.items() if not k.startswith("params/")}
    tutils._flatten_state({"xsd_string_0": {"_TextBlock_0": {
        "qkv": {"kernel": np.zeros((4, 12), np.float32)}}}}, "params", flat)
    _npz(path, flat)
    assert tutils.load_checkpoint(path)["epoch"] == 1


def test_legacy_pickle_and_mismatched_files_raise(artifacts, tmp_path):
    path = tmp_path / "legacy.pkl"
    path.write_bytes(pickle.dumps({"epoch": 1, "params": {}}))
    with pytest.raises(ValueError, match="legacy pickle.*mrgcn_tpu"):
        tutils.load_checkpoint(str(path))
    # a featureless file does not fit a model over features
    art = artifact_io.load(artifacts["allmodal"])
    first = nc.run(artifact_io.load(artifacts["featureless"]),
                   make_config("featureless", 1), Rows(), True, "test", 0,
                   CPU)
    saved = str(tmp_path / "featureless.npz")
    tutils.save_checkpoint(saved, 1, first.model, first.optimizer, 0.0)
    numeric = [dict(ALLMODAL[0])]
    with pytest.raises(RuntimeError, match="state_dict"):
        nc.run(art, make_config("allmodal", 1, features=numeric), Rows(),
               False, "test", 0, CPU, checkpoint=saved)
    # nor optimizer groups that differ from the model's
    state = tutils.load_checkpoint(saved)
    inner = state["opt_state"]["1"]["inner_states"]
    inner["gates"] = inner["default"]
    with pytest.raises(ValueError, match="optimizer groups"):
        tutils.restore_opt_state(first.model, first.optimizer,
                                 state["opt_state"])


def test_cli_saves_and_resumes(artifacts, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    cfg = tmp_path / "ck.toml"
    cfg.write_text('name = "CKCLI"\n[task]\ntype = "node classification"\n'
                   'seed = 0\n[model]\nepoch = 2\nnum_bases = 3\n'
                   '[[model.layers]]\nhidden_nodes = 16\n'
                   '[[model.layers]]\ntype = "mrgcn"\n')
    args = ["-c", str(cfg), "-i", artifacts["featureless"], "-o",
            str(tmp_path), "--test"]
    first = torch_run.run_cli(args + ["--save_checkpoint"])
    saved, = tmp_path.glob("CKCLI*_model_state_2.npz")
    assert f"[SAVE] Writing model state to {saved}" in capsys.readouterr().out
    state = tutils.load_checkpoint(str(saved))
    assert state["epoch"] == first.epoch == 2
    assert state["loss"] == pytest.approx(first.loss)
    for name, t in first.model.state_dict().items():
        np.testing.assert_array_equal(
            params_to_state_dict(state["params"])[name].numpy(), t.numpy())
    resumed = torch_run.run_cli(args + ["--load_checkpoint", str(saved)])
    assert "[LOAD] Loading model state - 2 epoch" in capsys.readouterr().out
    assert resumed.epoch == 4
    assert [h["epoch"] for h in resumed.history] == [3, 4]
    assert state_dict_to_params(resumed.model.state_dict()).keys() \
        == state["params"].keys()
