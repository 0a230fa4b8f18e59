"""The port's mini-batch slice against the JAX package's.

* A mini-batch forward over the whole node set equals the full-batch
  forward (the property tests/test_minibatch.py states for the JAX model),
  packed and wide identity rows, with and without bases, with a feature
  layer below; tolerance 1e-5.
* Both packages build their NC mini-batches from the same artifact (a
  small synthetic graph made with numpy from a seed): every array equal.
* Three mini-batch epochs through each package's own ``run``, the JAX one
  under ``MRGCN_SCAN_BATCHES=0`` (strictly sequential batches, the port's
  order), from the JAX model's initial parameters carried over by the
  weight bridge: every epoch's training loss and the test loss within 1e-4
  relative for the featureless model (optax's clip divides by the norm,
  torch's by norm + 1e-6). The model over features is held to 1e-3: from
  equal parameters every batch's logits agree to 1e-5 and its gradients to
  1e-7 of the largest, but after two Adam steps (whose first updates are
  all of size lr, so sums of them cancel) a few pre-activations sit within
  rounding of zero, the two packages' ReLUs fall on different sides, and
  19 gradient entries of the third batch differ; the losses then drift to
  2.7e-4 apart by the third epoch.
  With ``neighbor_fanout`` both draw from ``np.random.default_rng(seed)``.
* Node-sliced link-prediction batches equal the JAX package's, array for
  array; one step's loss and every gradient on the same corrupted triples
  agree to 1e-4.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.config import apply_defaults
from mrgcn_tpu.data import artifact as jax_artifact_io
from mrgcn_tpu.ops import distmult as jdm
from mrgcn_tpu.tasks import link_prediction as jlp
from mrgcn_tpu.tasks import node_classification as jnc
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.data import batching
from mrgcn_tpu_torch.models.rgcn import RGCN, EdgeBlock
from mrgcn_tpu_torch.tasks import link_prediction as lp
from mrgcn_tpu_torch.tasks import node_classification as nc
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import load_jax_params
from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                             save_lp_artifact,
                                             save_nc_artifact)

from tests.test_torch_batching import assert_blocks_equal, random_structure
from tests.test_torch_slice import small_workload

CPU = torch.device("cpu")


class Rows:
    """A TSV writer that keeps its rows."""

    def __init__(self):
        self.rows = []

    def writerow(self, row):
        self.rows.append(row)


# --------------------------------------------------------------------------
# mini-batch == full batch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hidden,num_bases", [((6, 4), 0), ((16, 4), 3),
                                              ((200, 5), 2), ((16, 8, 3), 0)])
def test_minibatch_forward_matches_fullbatch(hidden, num_bases):
    """A mini-batch over every node, built by the port's sampler, against
    the same model on the full edge list without plans: the unplanned
    identity paths (``gather_aggregate_packed`` for packed rows,
    ``gather_aggregate`` for wide ones, on ``dst_global``) and the grouped
    feature layers above (on local ids)."""
    s = random_structure(seed=12, n=70, E=500)
    n, R = s.num_nodes, s.num_relations
    model = RGCN(hidden_dims=hidden, num_relations=R, num_nodes=n,
                 generator=torch.Generator().manual_seed(0),
                 num_bases=num_bases, featureless=True)
    model.eval()
    full = EdgeBlock(src=torch.from_numpy(s.src), dst=torch.from_numpy(s.dst),
                     rel=torch.from_numpy(s.rel),
                     norm=torch.from_numpy(s.norm), num_out=n)
    mb = batching.sample_minibatch(batching.EdgeIndex(s),
                                   np.arange(n, dtype=np.int32),
                                   num_layers=len(hidden), edge_bucket=32,
                                   node_bucket=8)
    edges = batching.device_put_batches(mb.layer_edges, CPU)
    assert all(e.dst_global is not None and e.grouped for e in edges)
    with torch.no_grad():
        want = model(None, full)
        got = model(None, edges)
    assert got.shape[0] == batching.bucket(n, 8) and want.shape[0] == n
    np.testing.assert_allclose(got[:n].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# node classification
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["featureless", "multimodal"])
def nc_artifact(request, tmp_path_factory):
    w = small_workload()
    F = multimodal_features(w["n"], num_numeric=50, num_years=30,
                            num_strings=20, max_len=16) \
        if request.param == "multimodal" else None
    path = str(tmp_path_factory.mktemp("mb") / "small.npz")
    save_nc_artifact(path, w["n"], w["R"], w["src"], w["dst"], w["rel"],
                     w["norm"], w["labels_idx"], w["labels_cls"],
                     w["num_classes"], seed=0, num_eval=40, F=F)
    return path, F is None


def nc_config(featureless, **task):
    features = [] if featureless else [
        {"datatype": "xsd.numeric", "include": True, "embedding_dim": 4},
        {"datatype": "xsd.gYear", "include": True, "embedding_dim": 2}]
    return apply_defaults({
        "name": "MB", "graph": {"features": features},
        "task": {"type": "node classification", "seed": 0, **task},
        "model": {"epoch": 3, "num_bases": 3, "l2_lambda": 5e-4,
                  "layers": [{"hidden_nodes": 16}, {"type": "mrgcn"}]}})


def assert_features_equal(mine, theirs):
    assert sorted(mine) == sorted(theirs)
    for name in mine:
        assert len(mine[name]) == len(theirs[name])
        for a, b in zip(mine[name], theirs[name]):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("fanout", [None, 2])
def test_nc_minibatches_equal_jax(nc_artifact, fanout):
    path, featureless = nc_artifact
    config = nc_config(featureless)
    art, jart = artifact_io.load(path), jax_artifact_io.load(path)
    Y = np.asarray(art.Y["train"]).reshape(-1, 2)
    tin = prepare_inputs(art, config, featureless, CPU)
    jin = jax_prepare_inputs(jart, config, featureless)
    mine = nc.make_batches(tin, Y, 16, 2, fanout=fanout,
                           rng=np.random.default_rng(5))
    theirs = jnc.make_batches(jin, Y, 16, 2, fanout=fanout,
                              rng=np.random.default_rng(5))
    assert len(mine) == len(theirs) == -(-len(Y) // 16)
    for a, b in zip(mine, theirs):
        assert a.num_real == b.num_real
        assert_blocks_equal(a.edges, b.edges)
        assert_features_equal(a.features, b.features)
        for name in ("idx", "targets", "weights"):
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          np.asarray(getattr(b, name)), name)
    assert bool(mine[0].features) != featureless
    # the same parameters give the same logits on every batch
    jmodel = jnc.build_model(jin, config, len(jart.class_map))
    params = jmodel.init(jax.random.PRNGKey(0), jin.features,
                         jin.edges)["params"]
    tmodel = nc.build_model(tin, config, len(art.class_map),
                            torch.Generator().manual_seed(1))
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    for a, b in zip(mine, theirs):
        want = jmodel.apply({"params": params}, b.features, b.edges)
        with torch.no_grad():
            got = tmodel(a.edges, a.features)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("task", [
    dict(batchsize=16),
    dict(batchsize=16, neighbor_fanout=2, neighbor_fanout_rounds=2)],
    ids=["full_expansion", "fanout_2_rounds_2"])
def test_three_minibatch_epochs_match_jax(nc_artifact, task, monkeypatch):
    path, featureless = nc_artifact
    config = nc_config(featureless, **task)
    art, jart = artifact_io.load(path), jax_artifact_io.load(path)
    seed = 3

    monkeypatch.setenv("MRGCN_SCAN_BATCHES", "0")
    jrows = Rows()
    _, _, jloss, jacc, _, _ = jnc.run(jart, config, jrows, featureless,
                                      "test", None, seed)
    # the parameters jnc.run started from
    jin = jax_prepare_inputs(jart, config, featureless)
    jmodel = jnc.build_model(jin, config, len(jart.class_map))
    init_rng = jax.random.split(jax.random.PRNGKey(seed))[1]
    params = jmodel.init(init_rng, jin.features, jin.edges)["params"]

    build = nc.build_model

    def build_with_jax_params(*args):
        model = build(*args)
        load_jax_params(model, jax.tree.map(np.asarray, params))
        return model

    monkeypatch.setattr(nc, "build_model", build_with_jax_params)
    res = nc.run(art, config, Rows(), featureless, "test", seed, CPU)

    want = [float(r[1]) for r in jrows.rows[1:4]]
    got = [h["train_loss"] for h in res.history]
    rtol = 1e-4 if featureless else 1e-3       # see the module docstring
    np.testing.assert_allclose(got, want, rtol=rtol)
    np.testing.assert_allclose(res.loss, jloss, rtol=rtol)
    assert got[-1] < got[0]
    assert abs(res.acc - jacc) <= 1.0 / 40 + 1e-6       # one test node
    labelled = 60 + 40                                  # train + valid
    assert res.batches["train"] == -(-labelled // 16)
    assert res.batches["rounds"] == task.get("neighbor_fanout_rounds", 1)


def test_fanout_is_ignored_in_full_batch_mode(nc_artifact, caplog):
    path, featureless = nc_artifact
    config = nc_config(featureless, batchsize=-1, neighbor_fanout=2)
    with caplog.at_level("WARNING"):
        res = nc.run(artifact_io.load(path), config, Rows(), featureless,
                     "test", 0, CPU)
    assert "ignored in full-batch mode" in caplog.text
    assert res.batches["train"] == 1 and res.batches["rounds"] == 1


# --------------------------------------------------------------------------
# node-sliced link prediction
# --------------------------------------------------------------------------

SIZES = dict(num_nodes=120, num_props=4, num_train=600, num_valid=80,
             num_test=90)


@pytest.fixture(scope="module")
def lp_artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpmb") / "lp.npz")
    save_lp_artifact(path, seed=0, **SIZES)
    return path


def lp_config(hidden=16, **task):
    return apply_defaults({
        "name": "LPMB", "graph": {},
        "task": {"type": "link prediction", "seed": 0, "eval_interval": 2,
                 **task},
        "model": {"epoch": 2, "num_bases": 2, "l2_lambda": 5e-4,
                  "layers": [{"hidden_nodes": hidden},
                             {"hidden_nodes": hidden}, {"type": "mrgcn"}]}})


def lp_sides(lp_artifact, hidden, fanout=None):
    config = lp_config(hidden)
    art, jart = artifact_io.load(lp_artifact), jax_artifact_io.load(
        lp_artifact)
    train = np.asarray(art.data["train"])
    tin = prepare_inputs(art, config, True, CPU)
    jin = jax_prepare_inputs(jart, config, True)
    mine = lp.make_lp_batches(tin, train, 32, 100, 2, fanout=fanout,
                              rng=np.random.default_rng(9))
    theirs = jlp.make_lp_batches(jin, train, 32, 100, 2, fanout=fanout,
                                 rng=np.random.default_rng(9))
    return config, (tin, mine), (jin, theirs)


@pytest.mark.parametrize("fanout", [None, 3])
def test_node_sliced_lp_batches_equal_jax(lp_artifact, fanout):
    _, (tin, mine), (jin, theirs) = lp_sides(lp_artifact, 16, fanout)
    assert len(mine) == len(theirs) > 4
    for a, b in zip(mine, theirs):
        for name in ("data", "corrupt_pool"):
            got, want = getattr(a, name), np.asarray(getattr(b, name))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert (a.num_valid, a.num_triples, a.num_pool) \
            == (b.num_valid, b.num_triples, b.num_pool)
        assert a.num_valid < tin.num_nodes
        assert_blocks_equal(a.edges, b.edges)
        # batch-local triples: heads and tails index the batch's own nodes
        real = a.real_data
        assert real[:, [0, 2]].max() < a.num_valid
        np.testing.assert_array_equal(a.corrupt_pool[:a.num_pool],
                                      np.arange(a.num_valid))


def test_node_slices_remap_equals_a_dict_lookup(lp_artifact):
    """``np.searchsorted`` on the sorted subset nodes gives the positions a
    per-triple dict lookup gives."""
    train = np.asarray(artifact_io.load(lp_artifact).data["train"])
    count = 0
    for triples, nodes in lp.node_slices(train, 32, 100):
        lookup = {int(g): i for i, g in enumerate(nodes)}
        assert (np.diff(nodes) > 0).all()
        back = nodes[triples[:, [0, 2]]]
        for (h, _, t), (gh, gt) in zip(triples, back):
            assert (lookup[int(gh)], lookup[int(gt)]) == (h, t)
        count += len(triples)
    assert count >= len(train)       # a triple rides in each slice it touches


@pytest.mark.parametrize("hidden", [16, 200])
def test_node_sliced_lp_step_matches_jax(lp_artifact, hidden):
    """One batch's loss and every gradient, both packages fed the same
    corrupted triples: packed rows (``gather_aggregate_packed``) and wide
    ones (``gather_aggregate``) in layer 0, the grouped feature layer
    above."""
    config, (tin, mine), (jin, theirs) = lp_sides(lp_artifact, hidden)
    tbatch, jbatch = mine[1], theirs[1]
    jmodel = jlp.build_model(jin, config)
    params = jmodel.init(jax.random.PRNGKey(0), jin.features,
                         jin.edges)["params"]
    tmodel = lp.build_model(tin, config, torch.Generator().manual_seed(1))
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))

    got_emb = lp.embed(tmodel, tbatch)
    want_emb = jmodel.apply({"params": params}, jbatch.features,
                            jbatch.edges, train=False)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb),
                               rtol=1e-4, atol=1e-5)

    triples, labels, weights = lp.make_corruptor(0.2)(
        torch.from_numpy(tbatch.data), tbatch.num_triples,
        torch.from_numpy(tbatch.corrupt_pool), tbatch.num_pool,
        torch.Generator().manual_seed(0))
    assert int(triples[:, [0, 2]].max()) < tbatch.num_valid
    l2 = config["model"]["l2_lambda"]

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jbatch.features, jbatch.edges,
                           train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        t = jnp.asarray(triples.numpy())
        y_hat = jdm.score(t[:, 0], t[:, 1], t[:, 2], out,
                          p["rgcn"]["relations"])
        bce = optax.sigmoid_binary_cross_entropy(
            y_hat, jnp.asarray(labels.numpy()))
        w = jnp.asarray(weights.numpy())
        return jnp.sum(bce * w) / jnp.maximum(jnp.sum(w), 1.0) \
            + jutils.regularization(p, 0.0, l2)

    want, want_grads = jax.value_and_grad(loss_fn)(params)
    got = lp.loss_and_grads(tmodel, tbatch, triples, labels, weights, l2=l2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    for name, p in tmodel.named_parameters():
        w = want_grads
        for part in name.split("."):
            w = w[part]
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("task", [
    dict(gcn_batchsize=32, test_batchsize=100),
    dict(gcn_batchsize=32, test_batchsize=100, neighbor_fanout=3,
         neighbor_fanout_rounds=2)], ids=["full_expansion", "fanout_3"])
def test_node_sliced_lp_run_trains_and_ranks(lp_artifact, task):
    """The port's own ``run`` on node-sliced batches: finite falling
    losses, ranks within each batch's own candidates."""
    art = artifact_io.load(lp_artifact)
    res = lp.run(art, lp_config(**task), Rows(), True, "test", 0, CPU)
    losses = [h["loss"] for h in res.history]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[1] < losses[0]
    assert len(res.ranks["flt"]) >= 2 * SIZES["num_test"]
    assert 1 <= min(res.ranks["flt"]) and max(res.ranks["raw"]) \
        <= SIZES["num_nodes"]
    assert 0 < res.mrr["flt"] <= 1
    assert res.batches["rounds"] == task.get("neighbor_fanout_rounds", 1)
    assert res.batches["train"] > 1 and res.batches["test"] > 1 \
        and res.batches["valid"] == 0
    assert res.batches["build_seconds"] > 0 \
        and res.batches["test_build_seconds"] > 0
