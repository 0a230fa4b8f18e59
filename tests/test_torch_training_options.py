"""Driver options of the port against the JAX package: a device mesh,
early stopping's restore, and the optimizer's per-group options.

* A device mesh asked for through ``MRGCN_MESH`` or ``[task] mesh``
  trains one process per device (``tests/test_torch_mesh.py``); a task's
  ``run`` called with one outside a ``torch.distributed`` world raises in
  both tasks; the values that mean one device (``"1"``, ``"off"``) train
  exactly as no mesh does.
* Early stopping: both packages train the same small featureless graph
  from the same initial parameters past a stop (patience 2, the warm-up
  delay cut from 10 epochs to 2) and restore the best state. They stop
  after the same epoch (the fifth, restoring the third's state); the
  port's model holds the best state bit for bit; the restored parameters
  agree with the JAX package's to 1e-4 of each tensor's largest entry
  and the final evaluation's loss to rtol 1e-5. Adam divides each step by
  the root of the squared-gradient average, so an entry whose gradient is
  within rounding of zero in both packages can step differently: the
  identity weight table, nearly all such entries, read 4.6e-5 after three
  steps; the others 1e-6 to 8e-6.
* Optimizer options: three full-batch steps with a gate group
  (``gates_lr``, ``gates_weight_decay``, ``gates_amsgrad``), an
  ``optim_*`` datatype group (``xsd.numeric``: its own lr, weight decay,
  betas, eps and AMSGrad) and a base weight decay, against
  ``mrgcn_tpu.tasks.utils.build_optimizer``. Losses to rtol 1e-4 (optax's
  clip divides by the norm, torch's by norm + 1e-6: a relative difference
  of 1e-6 in the clipped gradients, ROADMAP hazards) and parameters to
  1e-4 of each tensor's largest entry, for the reason above (3.2e-5 on
  the identity weight table).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.config import apply_defaults
from mrgcn_tpu.data import artifact as jax_artifact_io
from mrgcn_tpu.tasks import node_classification as jnc
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.data.tsv import TSV
from mrgcn_tpu_torch.tasks import link_prediction as lp
from mrgcn_tpu_torch.tasks import node_classification as nc
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              state_dict_to_params)
from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                             save_lp_artifact,
                                             save_nc_artifact)

from tests.test_torch_slice import small_workload

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def nc_artifact(tmp_path_factory):
    w = small_workload()
    path = tmp_path_factory.mktemp("opts") / "nc.npz"
    F = multimodal_features(w["n"], seed=0, num_numeric=150, num_years=90,
                            num_strings=60, max_len=20)
    save_nc_artifact(str(path), w["n"], w["R"], w["src"], w["dst"],
                     w["rel"], w["norm"], w["labels_idx"], w["labels_cls"],
                     w["num_classes"], seed=0, num_eval=40, F=F)
    return str(path)


@pytest.fixture(scope="module")
def lp_artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("opts") / "lp.npz")
    save_lp_artifact(path, num_nodes=60, num_props=3, num_train=200,
                     num_valid=30, num_test=30, seed=0)
    return path


def nc_config(epochs=1, features=(), model=None, task=None):
    return apply_defaults({
        "name": "NC", "graph": {"features": [dict(f) for f in features]},
        "task": {"type": "node classification", "seed": 0, **(task or {})},
        "model": {"epoch": epochs, "num_bases": 3,
                  "layers": [{"hidden_nodes": 16}, {"type": "mrgcn"}],
                  **(model or {})}})


def lp_config(**task):
    return apply_defaults({
        "name": "LP", "graph": {},
        "task": {"type": "link prediction", "seed": 0, "eval_interval": 1,
                 **task},
        "model": {"epoch": 1, "num_bases": 2,
                  "layers": [{"hidden_nodes": 8}, {"type": "mrgcn"}]}})


def train_one_epoch(task, artifacts, mesh=None, env=None, monkeypatch=None):
    """One epoch of the port's driver ``task`` with ``[task] mesh`` set to
    ``mesh`` and ``MRGCN_MESH`` to ``env`` (where not None); returns the
    final evaluation loss."""
    if env is not None:
        monkeypatch.setenv("MRGCN_MESH", env)
    extra = {} if mesh is None else {"mesh": mesh}
    tsv = TSV("", "w", dry_run=True)
    if task == "nc":
        art = artifact_io.load(artifacts[0])
        return nc.run(art, nc_config(task=extra), tsv, True, "test", 0,
                      CPU).loss
    art = artifact_io.load(artifacts[1])
    return lp.run(art, lp_config(**extra), tsv, True, "test", 0, CPU).loss


@pytest.mark.parametrize("source", ["config", "environment"])
@pytest.mark.parametrize("task", ["nc", "lp"])
def test_a_device_mesh_raises_in_both_drivers(task, source, nc_artifact,
                                              lp_artifact, monkeypatch):
    monkeypatch.delenv("MRGCN_MESH", raising=False)
    with pytest.raises(RuntimeError, match="no torch.distributed world"):
        train_one_epoch(task, (nc_artifact, lp_artifact),
                        mesh="4" if source == "config" else None,
                        env="2x2" if source == "environment" else None,
                        monkeypatch=monkeypatch)


@pytest.mark.parametrize("value,source", [("1", "environment"),
                                          ("off", "config")])
@pytest.mark.parametrize("task", ["nc", "lp"])
def test_one_device_mesh_values_train_as_before(task, value, source,
                                                nc_artifact, lp_artifact,
                                                monkeypatch):
    monkeypatch.delenv("MRGCN_MESH", raising=False)
    artifacts = (nc_artifact, lp_artifact)
    before = train_one_epoch(task, artifacts)
    got = train_one_epoch(task, artifacts,
                          mesh=value if source == "config" else None,
                          env=value if source == "environment" else None,
                          monkeypatch=monkeypatch)
    assert got == before


def jax_initial_params(art, config, featureless, seed):
    """The parameters ``mrgcn_tpu.tasks.node_classification.run`` starts
    from with this seed (it splits the seed's key once for the init)."""
    jin = jax_prepare_inputs(art, config, featureless)
    model = jnc.build_model(jin, config, len(art.class_map))
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    return model.init(init_rng, jin.features, jin.edges)["params"]


def assert_params_close(state_dict, params, rel=1e-4):
    got = state_dict_to_params(
        {k: v.detach() for k, v in state_dict.items()})
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g) - w).max()) / scale
        assert err <= rel, (jax.tree_util.keystr(path), err)


def test_early_stop_restore_matches_jax(nc_artifact, monkeypatch):
    """Both drivers stop after the same epoch and restore the same best
    parameters; the final evaluation agrees."""
    made = []

    def short(base):
        class Short(base):
            def __init__(self, patience, tolerance):
                super().__init__(patience, tolerance, delay=2)
                made.append(self)
        return Short

    monkeypatch.setattr(jutils, "EarlyStop", short(jutils.EarlyStop))
    monkeypatch.setattr(tutils, "EarlyStop", short(tutils.EarlyStop))
    config = nc_config(epochs=40, model={"learning_rate": 0.05},
                       task={"early_stopping": {"patience": 2,
                                                "tolerance": 0.01}})
    jart = jax_artifact_io.load(nc_artifact)
    params0 = jax_initial_params(jart, config, True, seed=0)

    class Writer:
        def writerow(self, row):
            pass

    state, j_epoch, j_loss, j_acc, _, _ = jnc.run(
        jart, config, Writer(), True, "valid", None, 0)
    j_stop = made[-1]
    assert j_stop.stop and j_epoch < 40

    build = nc.build_model

    def build_from_jax(*args, **kwargs):
        model = build(*args, **kwargs)
        load_jax_params(model, jax.tree.map(np.asarray, params0))
        return model

    monkeypatch.setattr(nc, "build_model", build_from_jax)
    res = nc.run(artifact_io.load(nc_artifact), config, Writer(), True,
                 "valid", 0, CPU)
    t_stop = made[-1]
    assert t_stop.stop and res.epoch == j_epoch
    assert t_stop.best_score == pytest.approx(j_stop.best_score, rel=1e-5)
    # the port's model holds the best state, bit for bit
    best = t_stop.best_state[0]
    assert all(torch.equal(v, best[k]) for k, v in
               res.model.state_dict().items())
    assert_params_close(res.model.state_dict(), state[0])
    assert res.loss == pytest.approx(j_loss, rel=1e-5)
    assert res.acc == pytest.approx(j_acc, abs=1e-6)


def test_optimizer_options_match_jax(nc_artifact):
    """Gate group, one ``optim_*`` datatype group, base weight decay and
    AMSGrad: three steps give the JAX package's losses and parameters."""
    features = [
        {"datatype": "xsd.numeric", "include": True, "embedding_dim": 4,
         "optim_lr": 0.02, "optim_weight_decay": 1e-3,
         "optim_betas": [0.8, 0.99], "optim_eps": 1e-7,
         "optim_amsgrad": True},
        {"datatype": "xsd.gYear", "include": True, "embedding_dim": 1}]
    config = nc_config(epochs=3, features=features,
                       model={"weight_decay": 5e-4, "gates_lr": 0.05,
                              "gates_weight_decay": 1e-2,
                              "gates_amsgrad": True, "l2_lambda": 5e-4})
    jart = jax_artifact_io.load(nc_artifact)
    art = artifact_io.load(nc_artifact)
    Y_train = np.asarray(art.Y["train"]).reshape(-1, 2)
    C = len(art.class_map)
    jin = jax_prepare_inputs(jart, config, False)
    jbatch = jnc.make_batches(jin, Y_train, -1, 2)[0]
    jmodel = jnc.build_model(jin, config, C)
    params = jmodel.init(jax.random.PRNGKey(0), jin.features,
                         jin.edges)["params"]
    tin = prepare_inputs(art, config, False, CPU)
    tbatch = nc.make_batches(tin, Y_train, -1, 2)[0]
    tmodel = nc.build_model(tin, config, C, torch.Generator().manual_seed(1))
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))

    assert set(tin.optimizer_config) == {"xsd.numeric", "xsd.gYear",
                                         "gate_weights"}
    topt = tutils.build_optimizer(tmodel, config, tin.optimizer_config,
                                  False)
    groups = {(g["lr"], g["weight_decay"], g["amsgrad"], g["betas"],
               g["eps"]) for g in topt.adam.param_groups}
    assert groups == {(0.01, 5e-4, False, (0.9, 0.999), 1e-8),
                      (0.05, 1e-2, True, (0.9, 0.999), 1e-8),
                      (0.02, 1e-3, True, (0.8, 0.99), 1e-7)}
    optimizer = jutils.build_optimizer(params, config, jin.optimizer_config,
                                       False)
    # the JAX package's AMSGrad state holds one zeros tree three times
    # (mu, nu, nu_max) and its train step donates the state: a buffer
    # donated twice is refused, so each leaf gets its own copy
    opt_state = jax.tree.map(jnp.copy, optimizer.init(params))
    train_step = jnc.make_steps(jmodel, optimizer, config)[0]
    want, got = [], []
    for _ in range(3):
        params, _, opt_state, loss, _ = train_step(
            params, {}, opt_state, jbatch.features, jbatch.edges,
            jbatch.idx, jbatch.targets, jbatch.weights,
            jax.random.PRNGKey(0))
        want.append(float(loss))
        got.append(float(nc.train_step(tmodel, topt, tbatch, 0.0,
                                       5e-4)[0]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert_params_close(tmodel.state_dict(), params)
