"""The port's full-graph link-prediction slice against the JAX package's.

Both packages read the same artifact (a small synthetic graph made with
numpy from a seed, ``tasks/synthetic.save_lp_artifact``) and build their
inputs with their own ``prepare_inputs``/``make_lp_batches``; the JAX
model's initial parameters go into the port through the weight bridge. Two
widths: hidden 16 (packed rows, the composed identity table) and hidden 200
with the composed-table budget forced down, so both packages take the
basis-stream input layer (``featureless_basis``) and a wide second layer.

JAX's PRNG cannot be reproduced, so both sides are fed the same corrupted
triples: the embeddings, the loss and every gradient must agree to 1e-4,
and so must three training steps' losses (optax's clip divides by the
norm, torch's by norm + 1e-6). The corruptor's properties are those
tests/test_lp_negatives.py states for the JAX one. ``evaluate`` keeps
per-subset means and filters each subset against its own facts; the CLI
writes the 26-column TSV.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.config import apply_defaults
from mrgcn_tpu.data import artifact as jax_artifact_io
from mrgcn_tpu.ops import distmult as jdm
from mrgcn_tpu.ops import relational as jrl
from mrgcn_tpu.tasks import link_prediction as jlp
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
from mrgcn_tpu_torch import run as torch_run
from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.data.tsv import TSV
from mrgcn_tpu_torch.ops import distmult
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.tasks import link_prediction as lp
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              state_dict_to_params)
from mrgcn_tpu_torch.tasks.synthetic import save_lp_artifact

CPU = torch.device("cpu")
SIZES = dict(num_nodes=120, num_props=4, num_train=600, num_valid=80,
             num_test=90)


@pytest.fixture(scope="module")
def lp_artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lp") / "lp.npz")
    save_lp_artifact(path, seed=0, **SIZES)
    return path


def make_config(hidden=16, epochs=3, l2=0.0, **task):
    return apply_defaults({
        "name": "LP", "graph": {},
        "task": {"type": "link prediction", "seed": 0, "eval_interval": 2,
                 **task},
        "model": {"epoch": epochs, "num_bases": 2, "l2_lambda": l2,
                  "layers": [{"hidden_nodes": hidden},
                             {"hidden_nodes": hidden}, {"type": "mrgcn"}]}})


@pytest.fixture(params=[16, 200])
def sides(request, lp_artifact, monkeypatch):
    """Inputs, the full train batch and the models of both packages at one
    width, the JAX model's initial parameters loaded into the port."""
    hidden = request.param
    if hidden == 200:
        monkeypatch.setattr(jrl, "COMPOSED_TABLE_MAX_ELEMS", 1)
        monkeypatch.setattr(rl, "COMPOSED_TABLE_MAX_ELEMS", 1)
    config = make_config(hidden, l2=5e-4)
    jart = jax_artifact_io.load(lp_artifact)
    art = artifact_io.load(lp_artifact)
    train = np.asarray(art.data["train"])

    jin = jax_prepare_inputs(jart, config, True)
    jbatch = jlp.make_lp_batches(jin, train, -1, -1, 2)[0]
    jmodel = jlp.build_model(jin, config)
    params = jmodel.init(jax.random.PRNGKey(0), jin.features,
                         jin.edges)["params"]

    tin = prepare_inputs(art, config, True, CPU)
    tbatch = lp.make_lp_batches(tin, train, -1, -1, 2)[0]
    tmodel = lp.build_model(tin, config, torch.Generator().manual_seed(1))
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    assert tin.identity_basis == (hidden == 200)
    return config, (jin, jbatch, jmodel, params), (tin, tbatch, tmodel)


def drawn_triples(tbatch, seed=0):
    corrupt = lp.make_corruptor(0.2)
    return corrupt(torch.from_numpy(tbatch.data), tbatch.num_triples,
                   torch.from_numpy(tbatch.corrupt_pool), tbatch.num_pool,
                   torch.Generator().manual_seed(seed))


def test_batches_and_embeddings_match_jax(sides):
    _, (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    np.testing.assert_array_equal(tbatch.data, jbatch.data)
    np.testing.assert_array_equal(tbatch.corrupt_pool, jbatch.corrupt_pool)
    assert (tbatch.num_triples, tbatch.num_pool, tbatch.num_valid) \
        == (jbatch.num_triples, jbatch.num_pool, jbatch.num_valid)
    assert sorted(tin.edges.plans) == sorted(jin.edges.plans)
    # the weight bridge carries the LP model both ways, name for name
    back = state_dict_to_params(tmodel.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for mine, theirs in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(mine, np.asarray(theirs))

    want = jmodel.apply({"params": params}, jin.features, jin.edges,
                        train=False)
    got = lp.embed(tmodel, tbatch)
    assert got.shape == want.shape and (got >= 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_loss_and_every_gradient_match_jax(sides):
    config, (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    triples, labels, weights = drawn_triples(tbatch)
    l2 = config["model"]["l2_lambda"]

    def loss_fn(p):     # link_prediction.make_steps' loss, given triples
        out = jmodel.apply({"params": p}, jin.features, jin.edges,
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
    got = lp.loss_and_grads(tmodel, tbatch, triples, labels, weights,
                            l2=l2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    named = dict(tmodel.named_parameters())
    assert len(named) == len(jax.tree.leaves(params)) == 5
    for name, p in named.items():
        w = want_grads
        for part in name.split("."):
            w = w[part]
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_three_training_steps_match_jax(sides, monkeypatch):
    """The JAX package's own jitted step, its corruptor replaced by one
    that hands out the triples the port drew."""
    config, (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    drawn = drawn_triples(tbatch, seed=3)
    fixed = tuple(jnp.asarray(t.numpy()) for t in drawn)
    monkeypatch.setattr(jlp, "make_corruptor",
                        lambda ratio: lambda *args: fixed)
    optimizer = jutils.build_optimizer(params, config, jin.optimizer_config,
                                       True)
    opt_state = optimizer.init(params)
    train_step = jlp.make_steps(jmodel, optimizer, config)[0]
    topt = tutils.build_optimizer(tmodel, config, tin.optimizer_config, True)
    l2 = config["model"]["l2_lambda"]
    want, got = [], []
    for _ in range(3):
        params, _, opt_state, loss = train_step(
            params, {}, opt_state, jbatch.features, jbatch.edges,
            jnp.asarray(jbatch.data), jnp.asarray(jbatch.corrupt_pool),
            jnp.int32(jbatch.num_triples), jnp.int32(jbatch.num_pool),
            jax.random.PRNGKey(0))
        want.append(float(loss))
        got.append(float(lp.loss_and_grads(tmodel, tbatch, *drawn, l2=l2)))
        topt.step()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


def test_adversarial_weighting_matches_jax(sides, monkeypatch):
    config, (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    config = copy.deepcopy(config)
    config["task"]["negative_adversarial_temperature"] = 1.0
    drawn = drawn_triples(tbatch, seed=4)
    fixed = tuple(jnp.asarray(t.numpy()) for t in drawn)
    monkeypatch.setattr(jlp, "make_corruptor",
                        lambda ratio: lambda *args: fixed)
    optimizer = jutils.build_optimizer(params, config, jin.optimizer_config,
                                       True)
    train_step = jlp.make_steps(jmodel, optimizer, config)[0]
    _, _, _, want = train_step(
        params, {}, optimizer.init(params), jbatch.features, jbatch.edges,
        jnp.asarray(jbatch.data), jnp.asarray(jbatch.corrupt_pool),
        jnp.int32(jbatch.num_triples), jnp.int32(jbatch.num_pool),
        jax.random.PRNGKey(0))
    l2 = config["model"]["l2_lambda"]
    got = lp.loss_and_grads(tmodel, tbatch, *drawn, adv_alpha=1.0, l2=l2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    # the reweighting keeps the negatives' mass, so the loss moves little;
    # the gradients are what it changes
    adv = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
    lp.loss_and_grads(tmodel, tbatch, *drawn, l2=l2)
    assert any(not torch.allclose(adv[n], p.grad, rtol=1e-3, atol=0)
               for n, p in tmodel.named_parameters())


# --------------------------------------------------------------------------
# the corruptor, as tests/test_lp_negatives.py states it
# --------------------------------------------------------------------------

def corrupt_once(ratio, M=64, num_triples=50, num_pool=30, seed=0):
    data = torch.stack([torch.arange(M), torch.zeros(M, dtype=torch.long),
                        torch.arange(M) + 1000], dim=1).to(torch.int32)
    pool = (torch.arange(64) + 5000).to(torch.int32)   # recognisable ids
    triples, labels, weights = lp.make_corruptor(ratio)(
        data, num_triples, pool, num_pool,
        torch.Generator().manual_seed(seed))
    return triples.numpy(), labels.numpy(), weights.numpy()


def test_default_ratio_counts_match_reference():
    triples, labels, weights = corrupt_once(0.2, M=64, num_triples=50)
    assert triples.shape[0] == 64 + 64 // 5          # padded slots
    assert weights.sum() == 50 + 50 // 5
    assert (weights * (labels == 0)).sum() == 50 // 5
    assert (weights[:50] == 1).all() and (weights[50:64] == 0).all()


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0, 2.0])
def test_ratio_scales_negative_mass(ratio):
    triples, labels, weights = corrupt_once(ratio, M=64, num_triples=50)
    ncp = int(64 * round(ratio * 1000)) // 1000
    assert triples.shape[0] == 64 + ncp
    n_real = min((50 * round(ratio * 1000)) // 1000, ncp)
    assert (weights * (labels == 0)).sum() == n_real
    corr = triples[64:]
    if ncp:
        # every corrupted row differs from its source in head xor tail,
        # and the replacement comes from the real pool entries
        from_pool = corr >= 5000
        assert np.all(from_pool[:, 0] ^ from_pool[:, 2])
        assert not from_pool[:, 1].any()
        assert corr[from_pool].max() < 5000 + 30


def test_ratio_above_one_uses_replacement_over_real_rows():
    triples, _, _ = corrupt_once(2.0, M=64, num_triples=20)
    corr = triples[64:]
    assert corr.shape[0] == 128
    assert np.all(corr[64:, 0] < 20)           # tail-corrupted: real head
    assert np.all(corr[:64, 2] - 1000 < 20)    # head-corrupted: real tail


def test_invalid_ratio_raises():
    with pytest.raises(ValueError):
        lp.make_corruptor(-0.1)


@pytest.mark.parametrize("ratio,num_triples", [(1.0, 50), (0.5, 9),
                                               (0.2, 3), (0.2, 64)])
def test_weighted_negatives_source_real_rows(ratio, num_triples):
    """Every weighted negative is a corrupted copy of a real source row,
    and the weighted sources are distinct (ratio <= 1): the weighted slots
    never hold padding rows."""
    triples, labels, weights = corrupt_once(ratio, M=64,
                                            num_triples=num_triples)
    corr = triples[64:]
    w = weights[64:].astype(bool)
    nc_head = corr.shape[0] // 2
    srcs = np.concatenate([corr[:nc_head, 2] - 1000, corr[nc_head:, 0]])
    assert np.all(srcs[w] < num_triples), srcs[w]
    assert len(np.unique(srcs[w])) == int(w.sum())


def test_corruptor_counts_match_host_oracle(sides):
    """At the default ratio the weighted counts are ``sample_negatives``'
    (the reference's n // 5, half heads and half tails)."""
    _, _, (tin, tbatch, _) = sides
    triples, labels, weights = drawn_triples(tbatch)
    host_triples, host_labels = lp.sample_negatives(
        np.random.default_rng(0), tbatch)
    n = tbatch.num_triples
    assert weights.sum() == len(host_triples) == n + n // 5
    assert (weights * (labels == 0)).sum() == (host_labels == 0).sum()
    real = triples[weights > 0].numpy()
    pool = set(tbatch.corrupt_pool[:tbatch.num_pool].tolist())
    assert set(real[:, 0].tolist()) | set(real[:, 2].tolist()) <= pool


# --------------------------------------------------------------------------
# evaluation and the training run
# --------------------------------------------------------------------------

def test_evaluate_keeps_per_subset_means_and_matches_jax(sides):
    config, (jin, _, jmodel, params), (tin, _, tmodel) = sides
    rng = np.random.default_rng(5)
    facts = np.stack([rng.integers(0, SIZES["num_nodes"], 70),
                      rng.integers(0, SIZES["num_props"], 70),
                      rng.integers(0, SIZES["num_nodes"], 70)],
                     axis=1).astype(np.int32)
    tbatches = lp.make_lp_batches(tin, facts, -1, 20, 2)
    jbatches = jlp.make_lp_batches(jin, facts, -1, 20, 2)
    assert len(tbatches) == len(jbatches) == 3

    mrr, hits, ranks = lp.evaluate(tbatches, tmodel, 7, True)
    # per-subset means, each subset filtered against its own facts
    emb = lp.embed(tmodel, tbatches[0])
    rel = tmodel.rgcn.relations.detach()
    per = [distmult.compute_ranks(b.real_data, emb, rel) for b in tbatches]
    for kind, i in (("raw", 0), ("flt", 1)):
        assert mrr[kind] == pytest.approx(np.mean(
            [distmult.mrr_hits(p[i])[0] for p in per]))
        assert hits[kind] == pytest.approx(np.mean(
            [distmult.mrr_hits(p[i])[1] for p in per], axis=0))
        np.testing.assert_array_equal(
            ranks[kind], np.concatenate([p[i] for p in per]))
    # the plan is cached on the group's first batch and reused
    plan = tbatches[0].rank_plan
    lp.evaluate(tbatches, tmodel, 7, True)
    assert tbatches[0].rank_plan is plan
    tbatches[1].data[0, 2] = (tbatches[1].data[0, 2] + 1) % 120
    lp.evaluate(tbatches, tmodel, 7, True)
    assert tbatches[0].rank_plan is not plan      # facts changed: rebuilt

    embed_fn = jlp.make_steps(jmodel, optax.identity(), config)[2]
    jmrr, jhits, jranks = jlp.evaluate(jbatches, embed_fn, params, {}, 7,
                                       True)
    for kind in ("raw", "flt"):
        same = np.mean(np.asarray(ranks[kind]) == np.asarray(jranks[kind]))
        assert same >= 0.98, (kind, same)  # near-equal scores may swap
        assert mrr[kind] == pytest.approx(jmrr[kind], rel=2e-2)
    assert lp.evaluate(tbatches, tmodel, 7, False)[0]["flt"] == -1


class Rows:
    """A TSV writer that keeps its rows."""

    def __init__(self):
        self.rows = []

    def writerow(self, row):
        self.rows.append(list(row))


@pytest.mark.parametrize("test_split", ["test", "valid"])
def test_run_merges_train_and_valid_when_testing(lp_artifact, monkeypatch,
                                                 test_split):
    sizes = []
    make = lp.make_lp_batches
    monkeypatch.setattr(lp, "make_lp_batches", lambda inputs, data, *a:
                        sizes.append(len(data)) or make(inputs, data, *a))
    writer = Rows()
    res = lp.run(artifact_io.load(lp_artifact), make_config(epochs=2),
                 writer, True, test_split, 0, CPU)
    n = SIZES
    if test_split == "test":
        assert sizes == [n["num_train"] + n["num_valid"], n["num_test"]]
    else:
        assert sizes == [n["num_train"], n["num_valid"], n["num_valid"]]
    assert all(len(row) == 26 for row in writer.rows)
    assert len(writer.rows) == 1 + 2 + 1 and res.epoch == 2
    assert len(res.ranks["raw"]) == 2 * sizes[-1]
    # eval_interval 2: epoch 1 ranks nothing, the last epoch ranks train
    # (and never valid: the last epoch's early-stopping record is moot)
    assert writer.rows[1][2:] == [-1] * 24
    assert writer.rows[2][2] != -1 and writer.rows[2][10:] == [-1] * 16
    assert writer.rows[3][:18] == [-1] * 18 and writer.rows[3][18] != -1


def test_cli_writes_the_26_column_tsv_and_the_ranks(lp_artifact, tmp_path,
                                                    monkeypatch, capsys):
    cfg = tmp_path / "lp.toml"
    cfg.write_text(
        'name = "LPCLI"\n[task]\ntype = "link prediction"\nseed = 0\n'
        'eval_interval = 1\ntest_batchsize = 200\n[model]\nepoch = 2\n'
        'num_bases = 2\n[[model.layers]]\ntype = "mrgcn"\n'
        'hidden_nodes = 16\n[[model.layers]]\ntype = "mrgcn"\n')
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    res = torch_run.run_cli(["-c", str(cfg), "-i", lp_artifact, "-o",
                             str(tmp_path), "--save_output"])
    assert "Performance on valid set: MRR (raw)" in capsys.readouterr().out
    acc = next(tmp_path.glob("LPCLI*_acc.tsv")).read_text().splitlines()
    assert len(acc) == 4 and all(len(r.split("\t")) == 26 for r in acc)
    assert acc[0].split("\t")[:3] == ["epoch", "loss", "train_mrr_raw"]
    ranks = next(tmp_path.glob("LPCLI*_ranks.tsv")).read_text().splitlines()
    assert ranks[0].split("\t") == ["raw", "filtered"]
    assert len(ranks) == 1 + 2 * SIZES["num_valid"]
    assert [int(r.split("\t")[0]) for r in ranks[1:]] == res.ranks["raw"]
    assert res.model.hidden_dims == (16,)
    assert 0 < res.mrr["flt"] <= 1


def test_unported_lp_paths_raise(lp_artifact):
    art = artifact_io.load(lp_artifact)
    tin = prepare_inputs(art, make_config(), True, CPU)
    # node-sliced batches are ported: the slice's nodes become the batch's
    # ranking candidates
    sliced = lp.make_lp_batches(tin, np.asarray(art.data["train"]), 32, -1,
                                2)
    assert len(sliced) > 1 and all(b.num_valid < tin.num_nodes
                                   for b in sliced)
    # a device mesh is ported: the task trains in a world of one
    # process per device, and raises outside one
    with pytest.raises(RuntimeError, match="no torch.distributed world"):
        lp.run(art, make_config(mesh="4"), TSV("", "w", dry_run=True),
               True, "test", 0, CPU)
