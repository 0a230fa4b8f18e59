"""The port's featureless full-batch NC slice against the JAX package's.

Both packages read the same artifact (a small synthetic graph made with
numpy from a seed) and build their inputs with their own
``prepare_inputs``/``make_batches``; the JAX model's initial parameters go
into the port through the weight bridge. The two-layer logits on the
frontier-restricted chain must agree to 1e-4, and three full training
steps (CE, L2, clip, Adam) must give the same losses to rtol 1e-4 (optax's
clip divides by the norm, torch's by norm + 1e-6). The CLI runs end to end
on the repository's classification fixture made featureless, and a
subprocess with ``jax`` blocked runs the slice to show the port needs no
JAX.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

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
from mrgcn_tpu_torch.models.encoders import TCNN, ImageCNN
from mrgcn_tpu_torch.models.mrgcn import MRGCN
from mrgcn_tpu_torch.models.rgcn import RGCN
from mrgcn_tpu_torch.parallel import mesh as pmesh
from mrgcn_tpu_torch.tasks import node_classification as nc
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              params_to_state_dict,
                                              state_dict_to_params)
from mrgcn_tpu_torch.tasks.synthetic import (save_lp_artifact,
                                             save_nc_artifact,
                                             save_reference_tar)
from mrgcn_tpu_torch.utils import device as port_device

from tests.test_torch_layers import assert_plans_equal

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def small_workload():
    return build_workload(n=400, num_props=4, num_edges=2400, hidden=16,
                          num_classes=5, num_bases=3, num_labeled=60,
                          seed=0)


@pytest.fixture(scope="module")
def small_artifact(tmp_path_factory):
    w = small_workload()
    path = tmp_path_factory.mktemp("slice") / "small.npz"
    save_nc_artifact(str(path), w["n"], w["R"], w["src"], w["dst"],
                     w["rel"], w["norm"], w["labels_idx"], w["labels_cls"],
                     w["num_classes"], seed=0, num_eval=40)
    return artifact_io.load(str(path))


def make_config(num_bases=3, l2=0.0, epochs=3):
    return apply_defaults({
        "name": "T", "graph": {},
        "task": {"type": "node classification", "seed": 0},
        "model": {"epoch": epochs, "num_bases": num_bases,
                  "l2_lambda": l2,
                  "layers": [{"hidden_nodes": 16}, {"type": "mrgcn"}]}})


def both_sides(art, config):
    """Inputs, restricted full batch and models of both packages, with the
    JAX model's initial parameters loaded into the port."""
    Y_train = np.asarray(art.Y["train"]).reshape(-1, 2)
    C = len(art.class_map)
    jin = jax_prepare_inputs(art, config, True)
    jbatch = jnc.make_batches(jin, Y_train, -1, 2)[0]
    jmodel = jnc.build_model(jin, config, C)
    params = jmodel.init(jax.random.PRNGKey(0), jin.features,
                         jin.edges)["params"]

    tin = prepare_inputs(art, config, True, CPU)
    tbatch = nc.make_batches(tin, Y_train, -1, 2)[0]
    tmodel = nc.build_model(tin, config, C, torch.Generator().manual_seed(1))
    load_jax_params(tmodel, params)
    return (jin, jbatch, jmodel, params), (tin, tbatch, tmodel)


@pytest.mark.parametrize("num_bases", [3, 0])
def test_restricted_chain_logits_match_jax(small_artifact, num_bases):
    config = make_config(num_bases=num_bases)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = \
        both_sides(small_artifact, config)

    # same restricted chain: layer-0 rectangular plans, grouped layer 1
    assert tbatch.edges[0].num_out < tin.num_nodes
    for jb, tb in zip(jbatch.edges, tbatch.edges):
        assert (tb.num_out, tb.num_in) == (jb.num_out, jb.num_in)
        np.testing.assert_array_equal(tb.grp_src.numpy(),
                                      np.asarray(jb.grp_src))
    assert sorted(tbatch.edges[0].plans) == sorted(jbatch.edges[0].plans)
    for key, plan in tbatch.edges[0].plans.items():
        assert_plans_equal(plan, jbatch.edges[0].plans[key])
    np.testing.assert_array_equal(tbatch.idx.numpy(),
                                  np.asarray(jbatch.idx))

    want = jmodel.apply({"params": params}, jin.features, jbatch.edges)
    got = tmodel(tbatch.edges)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_three_training_steps_match_jax(small_artifact):
    config = make_config(l2=5e-4)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = \
        both_sides(small_artifact, config)

    optimizer = jutils.build_optimizer(params, config, jin.optimizer_config,
                                       True)
    opt_state = optimizer.init(params)
    train_step = jnc.make_steps(jmodel, optimizer, config)[0]
    topt = tutils.build_optimizer(tmodel, config, tin.optimizer_config,
                                  True)
    want, got = [], []
    rng = jax.random.PRNGKey(0)
    for _ in range(3):
        params, _, opt_state, loss, _ = train_step(
            params, {}, opt_state, jbatch.features, jbatch.edges,
            jbatch.idx, jbatch.targets, jbatch.weights, rng)
        want.append(float(loss))
        loss_t, _ = nc.train_step(tmodel, topt, tbatch, 0.0, 5e-4)
        got.append(float(loss_t))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


def test_weight_bridge_round_trip(small_artifact):
    config = make_config()
    _, (_, _, tmodel) = both_sides(small_artifact, config)
    params = state_dict_to_params(tmodel.state_dict())
    assert sorted(params["rgcn"]) == ["layer_0", "layer_1"]
    assert sorted(params["rgcn"]["layer_0"]) == ["comp_i",
                                                 "weight_i_packed"]
    assert sorted(params["rgcn"]["layer_1"]) == ["comp_f", "weight_f"]
    back = params_to_state_dict(params)
    for name, t in tmodel.state_dict().items():
        assert torch.equal(back[name], t)
    params["rgcn"]["layer_1"]["weight_f"] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_jax_params(tmodel, params)


def test_early_stop_decisions_match_jax():
    scores = [1.0] * 10 + [0.9, 0.95, 0.89, 0.88, 0.7, 0.71, 0.72, 0.73]
    mine, theirs = tutils.EarlyStop(3, 0.01), jutils.EarlyStop(3, 0.01)
    for i, s in enumerate(scores):
        mine.record(s, ({"w": torch.tensor([float(i)])},))
        theirs.record(s, ({"w": np.asarray([float(i)])},))
        assert (mine.stop, mine.best_score, mine.patience) \
            == (theirs.stop, theirs.best_score, theirs.patience)
    assert float(mine.best_state[0]["w"]) == 14.0


def test_node_dropout_keeps_or_rescales_rows():
    model = RGCN(hidden_dims=(8, 3), num_relations=3, num_nodes=10,
                 generator=torch.Generator().manual_seed(0), p_dropout=0.5,
                 featureless=True)
    X = torch.ones(64, 4)
    out = model._node_dropout(X, True, torch.Generator().manual_seed(3))
    rows = out[:, 0]
    assert set(rows.tolist()) == {0.0, 2.0}
    assert torch.equal(out, rows[:, None].expand_as(out))
    assert torch.equal(model._node_dropout(X, False, None), X)


def test_unported_paths_raise(small_artifact, tmp_path, monkeypatch):
    config = make_config()
    tin = prepare_inputs(small_artifact, config, True, CPU)
    Y_train = np.asarray(small_artifact.Y["train"]).reshape(-1, 2)
    # mini-batches are ported: eight label rows a batch
    assert len(nc.make_batches(tin, Y_train, 8, 2)) == -(-len(Y_train) // 8)
    # the image and WKT encoders are ported: both build
    for datatype, args, encoder in (
            ("blob.image", (None, {}, 16, 0.0), ImageCNN),
            ("ogc.wktLiteral", (9, 16, "S", 0.0), TCNN)):
        model = MRGCN(hidden_dims=(4, 2), modules_config=((datatype, args),),
                      num_relations=3, num_nodes=5,
                      generator=torch.Generator(), featureless=False)
        assert isinstance(getattr(model, model.names[0]), encoder)
    # checkpoints and reference .tar datasets are ported: a run saves, a
    # run resumes from the file, and a .tar trains
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    nc_cfg = tmp_path / "nc.toml"
    nc_cfg.write_text('name = "NC"\n[task]\ntype = "node classification"\n'
                      'seed = 0\n[model]\nepoch = 1\nnum_bases = 3\n'
                      '[[model.layers]]\nhidden_nodes = 16\n'
                      '[[model.layers]]\ntype = "mrgcn"\n')
    tar = str(tmp_path / "small.tar")
    save_reference_tar(tar, small_artifact.structure, small_artifact.F,
                       Y=small_artifact.Y, data=small_artifact.data,
                       sample_map=small_artifact.sample_map,
                       class_map=small_artifact.class_map)
    args = ["-c", str(nc_cfg), "-i", tar, "-o", str(tmp_path), "--test"]
    assert torch_run.main(args + ["--save_checkpoint"]) == 0
    saved, = tmp_path.glob("NC*_model_state_1.npz")
    assert torch_run.run_cli(args + [f"--load_checkpoint={saved}"]).epoch \
        == 2
    # link prediction is ported, node-sliced batches too; a device mesh
    # is ported, and 'auto' (every card) runs one process on the CPU, as
    # the JAX package's 'auto' takes its one CPU device
    cfg = tmp_path / "lp.toml"
    cfg.write_text('name = "LP"\n[task]\ntype = "link prediction"\n'
                   'seed = 0\ngcn_batchsize = 8\nmesh = "auto"\n[model]\nepoch = 1\n'
                   '[[model.layers]]\nhidden_nodes = 8\n'
                   '[[model.layers]]\ntype = "mrgcn"\n')
    art = tmp_path / "lp.npz"
    save_lp_artifact(str(art), num_nodes=60, num_props=3, num_train=200,
                     num_valid=30, num_test=30)
    monkeypatch.setattr(pmesh, "launch", None)     # no world may start
    assert torch_run.main(["-c", str(cfg), "-i", str(art), "--dry_run"]) \
        == 0


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MRGCN_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="MRGCN_PLATFORM=cpu"):
        port_device.select_device()
    monkeypatch.setenv("MRGCN_PLATFORM", "tpu")
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        port_device.select_device()
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    assert port_device.select_device() == CPU
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.fixture(scope="module")
def classification_artifact(tmp_path_factory):
    """tests/tasks/classification with every feature excluded."""
    from mrgcn_tpu.config import load_config
    from mrgcn_tpu.mkdataset import build
    d = tmp_path_factory.mktemp("cltest")
    src = REPO / "tests" / "tasks" / "classification"
    text = (src / "config.toml").read_text()
    text = text.replace("include = true", "include = false")
    text = re.sub(r"'\./tests/tasks/classification/",
                  f"'{src.as_posix()}/", text)
    cfg = d / "config.toml"
    cfg.write_text(text)
    A, F, Y, data, sample_map, class_map = build(load_config(str(cfg)))
    assert not F
    art = d / "cltest.npz"
    artifact_io.save(str(art), A, F, Y=Y, data=data, sample_map=sample_map,
                     class_map=class_map)
    return cfg, art


def test_cli_end_to_end_on_classification_fixture(classification_artifact,
                                                  tmp_path, monkeypatch):
    cfg, art = classification_artifact
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    res = torch_run.run_cli(["-c", str(cfg), "-i", str(art), "-o",
                             str(tmp_path), "--dry_run", "--test"])
    assert len(res.history) == 10                     # [model] epoch
    losses = [h["train_loss"] for h in res.history]
    assert all(np.isfinite(losses)) and np.isfinite(res.loss)
    test_rows = np.asarray(artifact_io.load(str(art)).Y["test"])
    assert len(res.labels) == len(res.targets) == test_rows.reshape(
        -1, 2).shape[0]
    assert 0.0 <= res.acc <= 1.0
    assert {p.device.type for p in res.model.parameters()} == {"cpu"}
    # with output files: the TSV gets the header, one row per epoch and
    # the test row
    assert torch_run.main(["-c", str(cfg), "-i", str(art), "-o",
                           str(tmp_path), "--test"]) == 0
    (tsv,) = tmp_path.glob("*_acc.tsv")
    assert len(tsv.read_text().splitlines()) == 1 + 10 + 1


JAX_BLOCKED = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None          # any "import jax" now fails
import chip_smoke
import mrgcn_tpu_torch
for m in pkgutil.walk_packages(mrgcn_tpu_torch.__path__, "mrgcn_tpu_torch."):
    importlib.import_module(m.name)
from benchmarks.torch_baseline import build_workload
from mrgcn_tpu_torch import run
from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                             save_nc_artifact)
w = build_workload(n=300, num_props=3, num_edges=1500, num_labeled=40,
                   seed=1)
d = tempfile.mkdtemp()
art, cfg = os.path.join(d, "a.npz"), os.path.join(d, "c.toml")
chip_smoke.write_config(__import__("pathlib").Path(cfg), 2, 4, 16,
                        features=chip_smoke.MULTIMODAL)
F = multimodal_features(w["n"], num_numeric=50, num_years=30,
                        num_strings=20, max_len=16)
save_nc_artifact(art, w["n"], w["R"], w["src"], w["dst"], w["rel"],
                 w["norm"], w["labels_idx"], w["labels_cls"],
                 w["num_classes"], num_eval=20, F=F)
res = run.run_cli(["-c", cfg, "-i", art, "-o", d, "--dry_run", "--test"])
assert not res.model.featureless
loaded = [k for k, v in sys.modules.items()
          if v is not None and k.split(".")[0] in ("jax", "flax", "optax")]
assert not loaded, loaded
print("OK", len(res.history), res.loss)
"""


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, MRGCN_PLATFORM="cpu", TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", JAX_BLOCKED], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("OK 2 ")


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    files = sorted((REPO / "mrgcn_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
