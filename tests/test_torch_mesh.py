"""The port's multi-device training against the JAX package's, on the CPU.

The port runs one process per device (``mrgcn_tpu_torch.parallel``); here
the devices are CPU processes over gloo, started by
``parallel.mesh.launch`` with ``MRGCN_PLATFORM=cpu``, two worlds of four
ranks: ``"4"`` (data 4) and ``"2x2"`` (data 2, model 2: the R-GCN basis
weights split over ``model``). Each world runs every case of this file in
one go (a module fixture), through the workers of
``mrgcn_tpu_torch.parallel.parity``, so no rank imports JAX.

* Specs: ``parallel.mesh.mesh_shape`` gives the JAX package's mesh shapes
  for every spec ``mesh_from_config`` takes, ``MRGCN_MESH`` before
  ``[task] mesh``; ``auto`` takes every visible card, and on the CPU one
  process (the JAX package's default CPU backend has one device), and
  trains there as the JAX package's task runner does; specs that the devices
  cannot serve (more ranks than cards, malformed) raise with their
  counts, and a task asked for a mesh outside a world raises.
* Plans and padding (numpy, no world): each shard's streams from
  ``shard_layer_plans`` equal the real entries of the JAX package's
  stacked slice, for 4 shards of the small NC graph's ``8:8:id`` and dense
  plans and LP's ``1:1:idb``; ``pad_edges_for_mesh`` equals the JAX one.
* Layers: a featureless R-GCN on identity plans, the same on the
  basis-stream route (the composed-table budget forced down, as
  ``tests/test_torch_basis.py`` does), an R-GCN over features on dense
  plans, and an LP-shaped R-GCN whose layer 1 runs the wide-line basis
  engine (``dense_basis``): output and every
  gradient within 1e-5 of the largest entry of the port's single-device
  layer and within 1e-4 of the JAX package's.
* Tasks, one step from the JAX package's initial parameters (the weight
  bridge): featureless NC restricted and unrestricted (labels on every
  node), LP on the full graph (both packages fed the triples the ranks
  drew), NC over numeric, gYear and WKT features (an MLP, a second MLP on
  rows that do not split over 4, the f32 ``TCNN`` with its BatchNorm) and
  mini-batch NC (replicated on every rank). The loss within 1e-5
  relative and every gradient within 1e-4 of its largest entry of the
  JAX single-device step; the same against the port's single-device step,
  and the running statistics after the step within 1e-5 relative of the
  port's. The JAX steps are compiled, as its tasks compile them (op by
  op they took a minute), and its plans left out (``MRGCN_GATHER_PLAN=0``:
  the XLA paths, the same sums without Pallas' interpret mode). Compiled
  on XLA:CPU the JAX TCNN's parameter gradient is wrong (ROADMAP, faults
  of the reference), so the TCNN's gradients are held against the port's
  single-device step alone, which ``tests/test_torch_lp_features.py``
  holds against the JAX TCNN op by op; its running statistics against
  the JAX package's within 1e-2 (flax takes the variance as
  E[x^2] - E[x]^2, which loses digits in f32: ROADMAP), the loss at
  1e-5.
* Three epochs of the tasks' own ``run`` (node dropout and encoder
  dropout on): losses within 1e-3 relative of the port's single-device
  run, test accuracy within one node, and the trained state bit-equal on
  every rank (a digest of the whole state, basis slices gathered).
* Checkpoints: a run under ``"2x2"`` saves; the file loads in a
  single-device run and under ``"4"`` (optimizer state too) and gives the
  same eval-mode logits within 1e-5.
* The CLI: ``MRGCN_PLATFORM=cpu MRGCN_MESH=2 python -m
  mrgcn_tpu_torch.run`` trains the small graph and writes one TSV and one
  log; a rank that raises ends its world with that rank's error.
"""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.torch_baseline import build_workload
from mrgcn_tpu.config import apply_defaults
from mrgcn_tpu.data import artifact as jax_artifact_io
from mrgcn_tpu.models.rgcn import RGCN as JaxRGCN
from mrgcn_tpu.models.rgcn import EdgeBlock as JaxEdgeBlock
from mrgcn_tpu.ops import distmult as jdm
from mrgcn_tpu.ops import relational as jrl
from mrgcn_tpu.parallel import mesh as jmesh
from mrgcn_tpu.tasks import link_prediction as jlp
from mrgcn_tpu.tasks import node_classification as jnc
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
from mrgcn_tpu_torch.models.rgcn import EdgeBlock
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.parallel import mesh as pmesh
from mrgcn_tpu_torch.parallel import parity
from mrgcn_tpu_torch.tasks.jax_import import params_to_state_dict
from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                             save_lp_artifact,
                                             save_nc_artifact)

from tests.test_torch_layers import random_graph

REPO = Path(__file__).resolve().parent.parent
SPECS = ("4", "2x2")
FEATURES = [
    {"datatype": "xsd.numeric", "include": True, "embedding_dim": 4},
    {"datatype": "xsd.gYear", "include": True, "embedding_dim": 2},
    {"datatype": "ogc.wktLiteral", "include": True, "embedding_dim": 4},
]
TCNN_PREFIX = "ogc_wktLiteral_0"
IMAGE = [{"datatype": "blob.image", "include": True, "embedding_dim": 8}]


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["", "0", "1", "none", "off", "8", "4x2",
                                  " 4X2 "])
def test_mesh_shapes_match_jax(spec, monkeypatch):
    monkeypatch.delenv("MRGCN_MESH", raising=False)
    config = {"task": {"mesh": spec}}
    theirs = jmesh.mesh_from_config(config)
    mine = pmesh.mesh_shape(pmesh.mesh_spec(config))
    assert mine == (None if theirs is None else
                    (theirs.shape["data"], theirs.shape["model"]))


def test_environment_comes_before_the_config(monkeypatch):
    monkeypatch.setenv("MRGCN_MESH", "4x2")
    config = {"task": {"mesh": "8"}}
    assert pmesh.mesh_spec(config) == "4x2"
    assert pmesh.mesh_shape(pmesh.mesh_spec(config)) \
        == tuple(jmesh.mesh_from_config(config).shape.values()) == (4, 2)
    monkeypatch.setenv("MRGCN_MESH", "")
    assert pmesh.mesh_spec(config) == "8"


def test_specs_the_devices_cannot_serve_raise(monkeypatch):
    # auto: one process on the CPU, every visible card on CUDA
    assert pmesh.mesh_shape("auto") is None
    assert pmesh.mesh_from_config({"task": {"mesh": "auto"}},
                                  torch.device("cpu")) is None
    assert pmesh.mesh_shape("auto", cards=3) == (3, 1)
    with pytest.raises(ValueError, match="8 ranks.*4 card"):
        pmesh.mesh_shape("4x2", cards=4)
    for bad in ("two", "0x2", "2x-1", "2x2x2"):
        with pytest.raises(ValueError, match="mesh"):
            pmesh.mesh_shape(bad)
    # a task asked for a mesh with no world around it
    monkeypatch.delenv("MRGCN_MESH", raising=False)
    with pytest.raises(RuntimeError, match="no torch.distributed world"):
        pmesh.mesh_from_config({"task": {"mesh": "4"}}, torch.device("cpu"))


# --------------------------------------------------------------------------
# plans and padding (numpy only)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["identity", "dense", "identity_basis"])
def test_shard_plans_equal_the_jax_stacked_slices(case):
    src, dst, rel, norm, n, R = random_graph(seed=5, n=300, R=6, E=1500)
    kind, k_in, k_out = {"identity": ("identity", 8, 8),
                         "dense": ("dense", 8, 8),
                         "identity_basis": ("identity_basis", 1, 1)}[case]
    kw = dict(row_block=16, edge_block=8, kind=kind)
    stacked = jrl.shard_layer_plans(src, dst, rel, norm, n, k_in, k_out, 4,
                                    **kw)
    for shard in range(4):
        mine = rl.shard_layer_plans(src, dst, rel, norm, n, k_in, k_out, 4,
                                    shard, **kw)
        for name in ("k_in", "k_out", "n_in_rows", "n_out_rows", "kind"):
            assert getattr(mine, name) == getattr(stacked, name)
        for sname in ("fwd", "bwd_table", "bwd_h"):
            a, b = getattr(mine, sname), getattr(stacked, sname)
            assert a.rel_const == b.rel_const, sname
            E, S = a.num_padded_edges, a.num_slabs
            for field in ("scatter_local", "scatter_blk", "slab_rel"):
                np.testing.assert_array_equal(
                    getattr(a, field).numpy(),
                    np.asarray(getattr(b, field))[shard][:S],
                    err_msg=f"{shard} {sname}.{field}")
            for field in ("src_row", "out_mod", "gather_row", "in_mod",
                          "rel", "norm"):
                np.testing.assert_array_equal(
                    getattr(a, field).numpy(),
                    np.asarray(getattr(b, field))[shard][:E],
                    err_msg=f"{shard} {sname}.{field}")
            # what the JAX stack pads beyond the shard is inert
            assert not np.asarray(b.norm)[shard][E:].any()


def test_pad_edges_for_mesh_equals_jax():
    from mrgcn_tpu.encodings.structure import group_by_relation
    src, dst, rel, norm, n, R = random_graph(seed=7, n=50, R=5, E=203)
    g = group_by_relation(src, dst, rel, norm, n, group_size=8)
    arrays = dict(src=src, dst=dst, rel=rel, norm=norm, grp_src=g.src,
                  grp_dst=g.dst, grp_norm=g.norm, group_rel=g.group_rel)
    theirs = jmesh.pad_edges_for_mesh(JaxEdgeBlock(
        num_out=n, group_size=g.group_size,
        **{k: jnp.asarray(v) for k, v in arrays.items()}), 4)
    mine = pmesh.pad_edges_for_mesh(EdgeBlock(
        num_out=n, group_size=g.group_size,
        **{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}),
        4)
    for name in arrays:
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    assert mine.src.shape[0] % 4 == 0 and mine.group_rel.shape[0] % 4 == 0


# --------------------------------------------------------------------------
# the worlds
# --------------------------------------------------------------------------

def nc_config(epochs=3, features=(), task=None, model=None):
    return apply_defaults({
        "name": "NC", "graph": {"features": [dict(f) for f in features]},
        "task": {"type": "node classification", "seed": 0, **(task or {})},
        "model": {"epoch": epochs, "num_bases": 4, "l2_lambda": 5e-4,
                  "layers": [{"hidden_nodes": 16}, {"type": "mrgcn"}],
                  **(model or {})}})


def lp_config(epochs=3):
    return apply_defaults({
        "name": "LP", "graph": {},
        "task": {"type": "link prediction", "seed": 0, "eval_interval": 3},
        "model": {"epoch": epochs, "num_bases": 2, "l2_lambda": 5e-4,
                  "layers": [{"hidden_nodes": 8}, {"type": "mrgcn"}]}})


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    w = build_workload(n=400, num_props=4, num_edges=2400, hidden=16,
                       num_classes=5, num_bases=4, num_labeled=60, seed=0)
    # 100 numbers and 48 geometries split over 4 ranks; 30 years do not
    F = multimodal_features(w["n"], seed=0, num_numeric=100, num_years=30,
                            num_strings=4, max_len=4, num_geometries=48,
                            geometry_points=(4, 20), num_images=32,
                            image_size=32)
    args = (w["n"], w["R"], w["src"], w["dst"], w["rel"], w["norm"])
    save_nc_artifact(str(d / "nc.npz"), *args, w["labels_idx"],
                     w["labels_cls"], w["num_classes"], seed=0, num_eval=40,
                     F=F)
    # labels on every node: the unrestricted branch
    every = np.arange(w["n"])
    save_nc_artifact(str(d / "every.npz"), *args, every,
                     every % w["num_classes"], w["num_classes"], seed=0,
                     num_eval=0)
    save_lp_artifact(str(d / "lp.npz"), num_nodes=60, num_props=3,
                     num_train=200, num_valid=30, num_test=30, seed=0)
    return {k: str(d / f"{k}.npz") for k in ("nc", "every", "lp")}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_nc_side(path, config, featureless, batchsize=-1):
    """The JAX model's initial variables and its single-device step from
    them on the first batch, compiled as the JAX task compiles it: loss,
    gradients, running statistics. The JAX side builds no sorted-stream
    plans (``MRGCN_GATHER_PLAN=0``): its layers take the XLA paths, the
    same sums without the Pallas kernels' interpret mode."""
    art = jax_artifact_io.load(path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRGCN_GATHER_PLAN", "0")
        jin = jax_prepare_inputs(art, config, featureless)
    Y = np.asarray(art.Y["train"]).reshape(-1, 2)
    jb = jnc.make_batches(jin, Y, batchsize, 2)[0]
    jmodel = jnc.build_model(jin, config, len(art.class_map))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jin.features,
                                     jin.edges)
    l2 = config["model"]["l2_lambda"]

    def loss(params):
        out, upd = jmodel.apply({**variables, "params": params},
                                jb.features, jb.edges, train=True,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        return jnc._loss_and_metrics(out, jb.idx, jb.targets, jb.weights)[0] \
            + jutils.regularization(params, 0.0, l2), upd

    (value, upd), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return {"params": np_tree(variables["params"]),
            "batch_stats": np_tree(variables.get("batch_stats", {})),
            "loss": float(value), "grads": np_tree(grads),
            "stats": np_tree(upd.get("batch_stats", {}))}


def jax_lp_params(path, config):
    art = jax_artifact_io.load(path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRGCN_GATHER_PLAN", "0")
        jin = jax_prepare_inputs(art, config, True)
    jmodel = jlp.build_model(jin, config)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jin.features,
                                  jin.edges)["params"]
    return jin, jmodel, params


def jax_lp_step(jin, jmodel, params, config, triples, labels, weights):
    l2 = config["model"]["l2_lambda"]

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jin.features, jin.edges,
                           train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        t = jnp.asarray(triples)
        y_hat = jdm.score(t[:, 0], t[:, 1], t[:, 2], out,
                          p["rgcn"]["relations"])
        bce = optax.sigmoid_binary_cross_entropy(y_hat, jnp.asarray(labels))
        w = jnp.asarray(weights)
        return jnp.sum(bce * w) / jnp.maximum(jnp.sum(w), 1.0) \
            + jutils.regularization(p, 0.0, l2)

    value, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(value), np_tree(grads)


def layer_cases():
    """Three R-GCNs on one small graph with the JAX package's parameters,
    outputs and gradients: on identity plans, on the basis-stream route
    and on dense plans (``row_block`` 16, ``edge_block`` 8) in the port;
    the JAX layers take no plans (their XLA paths: the same sums)."""
    src, dst, rel, norm, n, R = random_graph(seed=23, n=120, R=6, E=900)
    rng = np.random.default_rng(5)
    graph = (src, dst, rel, norm, n)
    X = rng.standard_normal((n, 12)).astype(np.float32)
    jedges = JaxEdgeBlock(src=jnp.asarray(src), dst=jnp.asarray(dst),
                          rel=jnp.asarray(rel), norm=jnp.asarray(norm),
                          num_out=n)
    cases = {}
    for name, hidden, featureless, basis in (
            ("identity", (16, 5), True, False),
            ("basis", (16, 5), True, True),
            ("dense", (16, 8), False, False)):
        shapes = [(None, hidden[0]), (hidden[0], hidden[1])]
        if not featureless:
            shapes.append((12, hidden[0]))
        plans = dict(row_block=16, edge_block=8, identity_basis=basis,
                     shapes=shapes)
        model = dict(hidden_dims=hidden, num_relations=R, num_nodes=n,
                     num_bases=4, featureless=featureless,
                     in_dim=None if featureless else 12)
        cot = rng.standard_normal((n, hidden[1])).astype(np.float32)
        if basis:
            # the JAX side of the identity case: the same model, weights
            # and sums (its layers take no plans)
            params, want, grads = reference
            cot = cases["identity"][0]["cot"]
        else:
            jmodel = JaxRGCN(hidden_dims=hidden, num_relations=R,
                             num_nodes=n, num_bases=4,
                             featureless=featureless)
            jX = None if featureless else jnp.asarray(X)
            params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jX,
                                          jedges)["params"]

            def fwd_bwd(p, c, jmodel=jmodel, jX=jX):
                out, vjp = jax.vjp(
                    lambda q: jmodel.apply({"params": q}, jX, jedges), p)
                return out, vjp(c)[0]

            want, grads = jax.jit(fwd_bwd)(params, jnp.asarray(cot))
            reference = (params, want, grads)
        cases[name] = ({"work": "layers", "graph": graph, "plans": plans,
                        "model": model, "params": np_tree(params),
                        "X": None if featureless else X, "cot": cot,
                        "table_max": 1 if basis else None},
                       {"out": np.asarray(want), "grads": np_tree(grads)})
    cases["wide"] = wide_layer_case()
    return cases


def wide_layer_case():
    """An LP-shaped R-GCN (hidden 200 x 200, 2 bases): the composed-table
    budget forced down and 40 relations, so that layer 0 takes the basis
    stream and layer 1's plan, without relation-constant slabs, the
    wide-line basis engine (``dense_basis``); the JAX side takes no plans
    (its XLA paths: the same sums)."""
    src, dst, rel, norm, n, R = random_graph(seed=29, n=120, R=40, E=900)
    hidden = (200, 200)
    shapes = [(None, 200), (200, 200)]
    assert not rl.plans_for_layers(src, dst, rel, norm, n, shapes[1:],
                                   row_block=16, edge_block=8)["1:1"] \
        .fwd.rel_const
    jmodel = JaxRGCN(hidden_dims=hidden, num_relations=R, num_nodes=n,
                     num_bases=2, featureless=True)
    jedges = JaxEdgeBlock(src=jnp.asarray(src), dst=jnp.asarray(dst),
                          rel=jnp.asarray(rel), norm=jnp.asarray(norm),
                          num_out=n)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2), None,
                                  jedges)["params"]
    cot = np.random.default_rng(6).standard_normal((n, 200)).astype(
        np.float32)

    def fwd_bwd(p, c):
        out, vjp = jax.vjp(lambda q: jmodel.apply({"params": q}, None,
                                                  jedges), p)
        return out, vjp(c)[0]

    want, grads = jax.jit(fwd_bwd)(params, jnp.asarray(cot))
    return ({"work": "layers", "graph": (src, dst, rel, norm, n),
             "plans": dict(row_block=16, edge_block=8, identity_basis=True,
                           shapes=shapes),
             "model": dict(hidden_dims=hidden, num_relations=R, num_nodes=n,
                           num_bases=2, featureless=True),
             "params": np_tree(params), "X": None, "cot": cot,
             "table_max": 1},
            {"out": np.asarray(want), "grads": np_tree(grads)})


def assert_grads_close(got, want, rel, what):
    """Every gradient within ``rel`` of its largest entry. A convolution's
    bias ahead of BatchNorm has gradient 0 in exact arithmetic (ROADMAP,
    hazards): its entries are rounding noise, held within ``rel`` of the
    largest gradient entry of its encoder."""
    if not want:
        assert not got, what
        return
    want = params_to_state_dict(want) if isinstance(
        next(iter(want.values())), dict) else want
    assert sorted(got) == sorted(want), what
    for name, g in got.items():
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        if re.search(r"\.Conv_\d+\.bias$", name):
            top = name.split(".")[0] + "."
            scale = max(float(np.abs(np.asarray(v)).max())
                        for k, v in want.items() if k.startswith(top))
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= rel * scale, (what, name, err, scale)


@pytest.fixture(scope="module")
def worlds(artifacts, tmp_path_factory):
    """The single-device references (the JAX package's and the port's) and
    both worlds' results of every case."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MRGCN_PLATFORM", "cpu")
    mp.delenv("MRGCN_MESH", raising=False)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "mesh_2x2.npz")
    try:
        torch.set_num_threads(2)
        jobs, refs = {}, {}
        for name, (job, want) in layer_cases().items():
            jobs[f"layer_{name}"] = job
            refs[f"layer_{name}"] = want
        steps = {
            "nc_restricted": (artifacts["nc"], nc_config(), True, -1),
            "nc_unrestricted": (artifacts["every"], nc_config(), True, -1),
            "nc_features": (artifacts["nc"], nc_config(features=FEATURES),
                            False, -1),
            "nc_minibatch": (artifacts["nc"],
                             nc_config(task={"batchsize": 16}), True, 16),
        }
        for name, (path, config, featureless, bs) in steps.items():
            side = jax_nc_side(path, config, featureless, bs)
            refs[name] = side
            jobs[name] = {"work": "first_step", "task": "nc",
                          "artifact": path, "config": config,
                          "featureless": featureless,
                          "params": side["params"],
                          "batch_stats": side["batch_stats"]}
        # the image CNN (its f64 twin): NCHW BatchNorm over rows split on
        # ``data``
        jobs["nc_image"] = {"work": "first_step", "task": "nc",
                            "artifact": artifacts["nc"],
                            "config": nc_config(features=IMAGE),
                            "featureless": False, "image_f64": True}
        lcfg = lp_config()
        jlp_side = jax_lp_params(artifacts["lp"], lcfg)
        jobs["lp"] = {"work": "first_step", "task": "lp",
                      "artifact": artifacts["lp"], "config": lcfg,
                      "params": np_tree(jlp_side[2])}
        runs = {
            "run_nc": ("nc", artifacts["nc"], nc_config(
                model={"p_dropout": 0.2}), True),
            "run_features": ("nc", artifacts["nc"], nc_config(
                features=[dict(f, dropout=0.1) for f in FEATURES]), False),
            "run_minibatch": ("nc", artifacts["nc"],
                              nc_config(task={"batchsize": 16}), True),
            "run_lp": ("lp", artifacts["lp"], lcfg, True),
        }
        for name, (task, path, config, featureless) in runs.items():
            jobs[name] = {"work": "train", "task": task, "artifact": path,
                          "config": config, "featureless": featureless}
        # the port's single-device results of the same jobs
        port = {name: parity.WORKERS[job["work"]](job)
                for name, job in jobs.items()}
        for name in ("lp",):
            triples = port[name]["triples"]
            refs[name] = dict(zip(("loss", "grads"),
                                  jax_lp_step(*jlp_side, lcfg, *triples)))
        got = {}
        for spec in ("2x2", "4"):
            mine = [{**job, "config": parity.with_mesh(job["config"], spec)}
                    if "config" in job else {**job, "mesh": spec}
                    for job in jobs.values()]
            if spec == "2x2":
                mine.append({**jobs["run_nc"], "save": ckpt,
                             "config": parity.with_mesh(
                                 jobs["run_nc"]["config"], spec)})
            else:
                mine.append({"work": "first_step", "task": "nc",
                             "artifact": artifacts["nc"], "checkpoint": ckpt,
                             "config": parity.with_mesh(nc_config(), spec)})
            d, m = pmesh.mesh_shape(spec)
            ranks = pmesh.launch(parity.rank_worker, d * m, "gloo",
                                 ["cpu"] * (d * m), args=(mine,))
            got[spec] = [dict(zip(list(jobs) + ["extra"], r))
                         for r in ranks]
        # one rank whose collectives go through gloo all the same
        one = [{**jobs[name], "one_rank_collectives": True,
                "config": parity.with_mesh(jobs[name]["config"], "1x1")}
               for name in ("nc_restricted", "nc_image")]
        t0 = time.monotonic()
        got["1x1"] = [dict(zip(("nc_restricted", "nc_image"), r)) for r in
                      pmesh.launch(parity.rank_worker, 1, "gloo", ["cpu"],
                                   args=(one,), timeout=None)]
        got["1x1"][0]["wall_s"] = time.monotonic() - t0
        port["checkpoint"] = parity.first_step(
            {"task": "nc", "artifact": artifacts["nc"], "checkpoint": ckpt,
             "config": nc_config()})
        yield refs, port, got
    finally:
        mp.undo()


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", ["identity", "basis", "dense", "wide"])
def test_layers_match_single_device_and_jax(worlds, spec, case):
    refs, port, got = worlds
    key = f"layer_{case}"
    mine = got[spec][0][key]
    for theirs, rel in ((port[key], 1e-5), (refs[key], 1e-4)):
        out = np.asarray(theirs["out"])
        scale = max(float(np.abs(out).max()), 1e-30)
        assert float(np.abs(mine["out"] - out).max()) <= rel * scale
        assert_grads_close(mine["grads"], theirs["grads"], rel, key)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", ["nc_restricted", "nc_unrestricted", "lp",
                                  "nc_features", "nc_minibatch"])
def test_one_step_matches_jax_and_single_device(worlds, spec, case):
    refs, port, got = worlds
    mine = got[spec][0][case]
    want = refs[case]
    np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(mine["loss"], port[case]["loss"], rtol=1e-5)
    assert_grads_close(mine["grads"], port[case]["grads"], 1e-4, "port")
    jax_grads = params_to_state_dict(want["grads"])
    tcnn = {k: v for k, v in mine["grads"].items()
            if k.startswith(TCNN_PREFIX)}
    assert_grads_close({k: v for k, v in mine["grads"].items()
                        if k not in tcnn},
                       {k: v.numpy() for k, v in jax_grads.items()
                        if k not in tcnn}, 1e-4, "jax")
    for name, stat in port[case]["batch_stats"].items():
        np.testing.assert_allclose(mine["batch_stats"][name], stat,
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    if case == "nc_features":
        assert any("BatchNorm" in k for k in mine["batch_stats"])
        jstats = params_to_state_dict(want["stats"])
        for name, stat in mine["batch_stats"].items():
            w = jstats[name].numpy()
            np.testing.assert_allclose(stat, w, rtol=1e-2,
                                       atol=1e-2 * np.abs(w).max())
    # every rank holds the same summed gradients
    for rank in got[spec][1:]:
        for name, g in rank[case]["grads"].items():
            np.testing.assert_array_equal(g, mine["grads"][name])


@pytest.mark.parametrize("spec", SPECS)
def test_image_cnn_step_matches_single_device(worlds, spec):
    """The image CNN's BatchNorm over NCHW rows split on ``data``, in its
    f64 twin: in f32 one ReLU input a few ulps from zero, on the other
    side of it in a rank's order of sums, moves gradients by percents."""
    _, port, got = worlds
    mine, want = got[spec][0]["nc_image"], port["nc_image"]
    np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-5)
    assert any(k.startswith("blob_image_0.") for k in mine["grads"])
    assert_grads_close(mine["grads"], want["grads"], 1e-4, "image")
    assert any("BatchNorm" in k for k in want["batch_stats"])
    for name, stat in want["batch_stats"].items():
        np.testing.assert_allclose(mine["batch_stats"][name], stat,
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for rank in got[spec][1:]:
        for name, g in rank["nc_image"]["grads"].items():
            np.testing.assert_array_equal(g, mine["grads"][name])


def test_a_world_of_one_rank_runs_every_collective(worlds):
    """``one_rank_collectives``: a world of one rank sends the all-reduces,
    the all-gathers and their reduce-scatters through the backend, and
    steps as one device does: featureless NC to the bit."""
    _, port, got = worlds
    step, image = got["1x1"][0]["nc_restricted"], got["1x1"][0]["nc_image"]
    assert step["loss"] == port["nc_restricted"]["loss"]
    for name, g in port["nc_restricted"]["grads"].items():
        np.testing.assert_array_equal(step["grads"][name], g, err_msg=name)
    assert step["traffic"]["all_reduce"] > 0
    assert all(v > 0 for v in image["traffic"].values()), image["traffic"]
    np.testing.assert_allclose(image["loss"], port["nc_image"]["loss"],
                               rtol=1e-5)
    assert_grads_close(image["grads"], port["nc_image"]["grads"], 1e-4,
                       "one rank")


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", ["run_nc", "run_features",
                                  "run_minibatch", "run_lp"])
def test_three_epochs_match_single_device(worlds, spec, case):
    _, port, got = worlds
    mine, want = got[spec][0][case], port[case]
    key = "train_loss" if case != "run_lp" else "loss"
    np.testing.assert_allclose([h[key] for h in mine["history"]],
                               [h[key] for h in want["history"]], rtol=1e-3)
    assert len(mine["history"]) == 3
    if case != "run_lp":
        n_test = len(want["labels"])
        assert abs(mine["acc"] - want["acc"]) * n_test <= 1 + 1e-6
    else:
        np.testing.assert_allclose(mine["mrr"]["raw"], want["mrr"]["raw"],
                                   rtol=1e-3)
    assert len({rank[case]["digest"] for rank in got[spec]}) == 1
    assert mine["bytes_per_step"] > 0


def test_a_mesh_checkpoint_resumes_under_another_spec_and_none(worlds):
    _, port, got = worlds
    saved = got["2x2"][0]["extra"]
    assert saved["digest"] == got["2x2"][1]["extra"]["digest"]
    under_4 = got["4"][0]["extra"]
    single = port["checkpoint"]
    scale = max(float(np.abs(single["eval"]).max()), 1.0)
    np.testing.assert_allclose(under_4["eval"], single["eval"], rtol=0,
                               atol=1e-5 * scale)
    # resumed, the next step is the same step
    np.testing.assert_allclose(under_4["loss"], single["loss"], rtol=1e-5)
    assert_grads_close(under_4["grads"], single["grads"], 1e-4, "resumed")


def test_cli_trains_under_a_mesh_and_writes_once(artifacts, tmp_path):
    cfg = tmp_path / "nc.toml"
    cfg.write_text('name = "NC"\n[task]\ntype = "node classification"\n'
                   'seed = 0\n[model]\nepoch = 2\nnum_bases = 4\n'
                   '[[model.layers]]\nhidden_nodes = 16\n'
                   '[[model.layers]]\ntype = "mrgcn"\n')
    env = {**os.environ, "MRGCN_PLATFORM": "cpu", "MRGCN_MESH": "2",
           "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-m", "mrgcn_tpu_torch.run", "-c", str(cfg), "-i",
         artifacts["nc"], "-o", str(tmp_path), "--test",
         "--save_checkpoint"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("loss ") == 1, proc.stdout
    tsvs = list(tmp_path.glob("NC*_acc.tsv"))
    assert len(tsvs) == 1 and len(list(tmp_path.glob("NC*.log"))) == 1
    rows = tsvs[0].read_text().splitlines()
    assert len(rows) == 1 + 2 + 1
    assert len(list(tmp_path.glob("NC*_model_state_2.npz"))) == 1


def test_auto_on_the_cpu_trains_as_the_jax_package_does(artifacts, tmp_path,
                                                        monkeypatch):
    """``mesh = "auto"`` on the CPU runs one process in the port's CLI
    (no world is started) and trains as the JAX package's task runner
    (``tasks.node_classification.run``) does under the same config: both
    resume the port's checkpoint and their epochs' losses agree within
    1e-4 relative. (The JAX package takes every local device: the 8
    virtual CPU devices of tests/conftest.py here, one on a default CPU
    backend.)"""
    from mrgcn_tpu.config import load_config as jax_load_config
    from mrgcn_tpu_torch import run
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    monkeypatch.delenv("MRGCN_MESH", raising=False)
    monkeypatch.setattr(pmesh, "launch", None)     # no world may start
    cfg = tmp_path / "nc.toml"
    cfg.write_text('name = "NC"\n[task]\ntype = "node classification"\n'
                   'seed = 0\nmesh = "auto"\n[model]\nepoch = 2\n'
                   'num_bases = 4\nl2_lambda = 5e-4\n'
                   '[[model.layers]]\nhidden_nodes = 16\n'
                   '[[model.layers]]\ntype = "mrgcn"\n')
    args = ["-c", str(cfg), "-i", artifacts["nc"], "-o", str(tmp_path),
            "--test"]
    first = run.run_cli(args + ["--dry_run", "--save_checkpoint"])
    assert first.model is not None and first.epoch == 2
    (saved,) = tmp_path.glob("NC*_model_state_2.npz")
    got = run.run_cli(args + ["--dry_run", f"--load_checkpoint={saved}"])

    rows = []
    writer = type("Rows", (), {"writerow": lambda _, r: rows.append(r)})()
    config = jax_load_config(str(cfg))
    assert jmesh.mesh_from_config(config) is not None
    _, epoch, *_ = jnc.run(jax_artifact_io.load(artifacts["nc"]), config,
                           writer, True, "test", str(saved), 0)
    want = [float(r[1]) for r in rows[1:] if r[0] != "-1"]
    assert epoch == got.epoch == 4 and len(want) == 2
    np.testing.assert_allclose([h["train_loss"] for h in got.history],
                               want, rtol=1e-4)


def test_the_cli_world_has_no_deadline(artifacts, tmp_path, monkeypatch):
    """A training run may take hours: ``run`` starts its world with no
    limit on its wall time (a hung rank fails in its collective)."""
    from mrgcn_tpu_torch import run
    cfg = tmp_path / "nc.toml"
    cfg.write_text('name = "NC"\n[task]\ntype = "node classification"\n'
                   '[model]\nepoch = 1\n')
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    monkeypatch.setenv("MRGCN_MESH", "2")
    seen = {}

    def launch(fn, world, backend, devices, args=(), **kw):
        seen.update(world=world, backend=backend, **kw)
        return ["rank 0's result", "rank 1's result"]

    monkeypatch.setattr(pmesh, "launch", launch)
    got = run.run_cli(["-c", str(cfg), "-i", artifacts["nc"], "-o",
                       str(tmp_path)])
    assert got == "rank 0's result"
    assert seen == {"world": 2, "backend": "gloo", "timeout": None}


def test_a_world_runs_past_a_limit_it_was_not_given(worlds):
    """The one-rank world ran with no limit (``timeout=None``) for more
    than a second; the same limit of 1 s stops a world."""
    _, _, got = worlds
    assert got["1x1"][0]["wall_s"] > 1
    with pytest.raises(TimeoutError, match="outlasted 1 s"):
        pmesh.launch(time.sleep, 1, "gloo", ["cpu"], timeout=1)


def test_a_rank_that_raises_ends_the_world_with_its_error(monkeypatch):
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    monkeypatch.delenv("MRGCN_MESH", raising=False)
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed"
                       r"(.|\n)*KeyError: 'no such work'"):
        pmesh.launch(parity.rank_worker, 2, "gloo", ["cpu"] * 2,
                     args=([{"work": "no such work", "mesh": "2"}],))



def test_first_step_relu_inputs_hold_each_encoder_batchnorm(artifacts,
                                                            monkeypatch):
    """With ``relu``, ``first_step`` keeps what each R-GCN layer hands its
    ReLU (by layer index) and what each encoder BatchNorm hands its ReLU
    (by the BatchNorm's name): the training forward's output of the
    BatchNorm, so at fresh weights (scale 1, bias 0) each channel has
    mean 0 and variance 1 over the batch's rows and positions, less the
    share of the epsilon 1e-5 in the denominator."""
    from mrgcn_tpu_torch.models.encoders import BatchNorm
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    monkeypatch.delenv("MRGCN_MESH", raising=False)
    job = {"task": "nc", "artifact": artifacts["nc"], "relu": True,
           "config": nc_config(epochs=1, features=FEATURES),
           "featureless": False}
    out = parity.first_step(job)
    _, _, model, _ = parity._setup(job, torch.device("cpu"), None)
    names = [n for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    assert names and all(n.startswith(TCNN_PREFIX) for n in names)
    layers = len(list(model.rgcn.layers()))
    assert sorted(out["relu_inputs"], key=str) \
        == sorted([*range(layers), *names], key=str)
    for name in names:
        y = out["relu_inputs"][name].astype(np.float64)
        axes = (0, *range(2, y.ndim))
        np.testing.assert_allclose(y.mean(axis=axes), 0.0, atol=1e-5)
        var = y.var(axis=axes)
        assert ((var > 0.99) & (var <= 1.0 + 1e-6)).all(), var
