"""The reference's own formats in the port, against the JAX package.

The repository holds no reference-produced file, so they are written here
from a seed (``tasks/synthetic.save_reference_tar``, the upstream
``mkdataset`` tarball layout; ``save_reference_checkpoint``, a
``torch.save`` checkpoint with the reference's names). Held:

* both packages' ``artifact_from_reference_tar`` read a tarball (NC with
  numeric, string, WKT and image features, twelve classes as a
  ``list/class_map/<i>`` of twelve members; LP triples) into equal
  artifacts, the list in numeric order, and equal to the ``.npz`` twin up
  to the tarball's canonical edge order (its CSR sums repeated edges);
* the restricted unpickler refuses a member that pickles a global off its
  list, in both packages;
* both packages' ``map_state_dict`` map a reference-named state dict (MLP
  and TCNN encoders, the TCNN's running statistics, a packed identity
  weight, the gates, a backbone key without a counterpart) onto equal
  trees with equal ``unmapped`` lists, and from that tree both packages'
  eval-mode forwards agree within 1e-5;
* a reference checkpoint given to ``--load_checkpoint`` loads with a fresh
  optimizer and the file's epoch;
* the CLI trains a ``.tar`` dataset as its ``.npz`` twin: losses within
  1e-4 relative.
"""

import io
import pickle
import tarfile

import numpy as np
import pytest
import torch

import jax

from benchmarks.torch_baseline import build_workload
from mrgcn_tpu.config import apply_defaults
from mrgcn_tpu.data import artifact as jax_artifact_io
from mrgcn_tpu.data import reference_tar as jax_reference_tar
from mrgcn_tpu.tasks import node_classification as jnc
from mrgcn_tpu.tasks import torch_import as jax_torch_import
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
from mrgcn_tpu_torch import run as torch_run
from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.data import reference_tar
from mrgcn_tpu_torch.tasks import node_classification as nc
from mrgcn_tpu_torch.tasks import torch_import
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import load_jax_params
from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                             reference_state_dict,
                                             save_lp_artifact,
                                             save_nc_artifact,
                                             save_reference_checkpoint,
                                             save_reference_tar)

CPU = torch.device("cpu")
NUM_CLASSES = 12
FEATURES = [
    {"datatype": "xsd.numeric", "include": True, "embedding_dim": 4},
    {"datatype": "ogc.wktLiteral", "include": True, "embedding_dim": 4},
]


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """An NC and an LP artifact, each as ``.npz`` and as reference
    ``.tar``: ``{kind: (npz path, tar path)}``."""
    d = tmp_path_factory.mktemp("reftar")
    w = build_workload(n=300, num_props=4, num_edges=1800, hidden=16,
                       num_classes=NUM_CLASSES, num_bases=3,
                       num_labeled=60, seed=0)
    F = multimodal_features(w["n"], seed=0, num_numeric=100, num_years=40,
                            num_strings=30, max_len=12, num_geometries=40,
                            num_images=10, image_size=16)
    out = {}
    save_nc_artifact(str(d / "nc.npz"), w["n"], w["R"], w["src"], w["dst"],
                     w["rel"], w["norm"], w["labels_idx"], w["labels_cls"],
                     NUM_CLASSES, seed=0, num_eval=30, F=F)
    save_lp_artifact(str(d / "lp.npz"), num_nodes=120, num_props=4,
                     num_train=600, num_valid=80, num_test=90, seed=0)
    for kind in ("nc", "lp"):
        art = artifact_io.load(str(d / f"{kind}.npz"))
        save_reference_tar(str(d / f"{kind}.tar"), art.structure, art.F,
                           Y=art.Y, data=art.data, sample_map=art.sample_map,
                           class_map=art.class_map)
        out[kind] = (str(d / f"{kind}.npz"), str(d / f"{kind}.tar"))
    return out


def _canon(structure):
    order = np.lexsort((structure.dst, structure.src, structure.rel))
    return [a[order] for a in (structure.src, structure.dst, structure.rel,
                               structure.norm)]


def _assert_sets_equal(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert type(a) is type(b) and a.dtype == b.dtype
        if a.dtype == object:
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["nc", "lp"])
def test_both_packages_read_the_same_artifact(twins, kind):
    npz, tar = twins[kind]
    mine = reference_tar.artifact_from_reference_tar(tar)
    theirs = jax_reference_tar.artifact_from_reference_tar(tar)
    twin = artifact_io.load(npz)

    for a, b in zip(_canon(mine.structure), _canon(theirs.structure)):
        np.testing.assert_array_equal(a, b)
    # the CSR sums the twin's repeated (subject, relation, object) edges
    assert mine.structure.num_relations == twin.structure.num_relations
    diff = mine.structure.to_scipy_hstack() - twin.structure.to_scipy_hstack()
    assert abs(diff).max() <= 1e-6
    assert sorted(mine.F) == sorted(theirs.F) == sorted(twin.F)
    for datatype in mine.F:
        for m, t, w in zip(mine.F[datatype], theirs.F[datatype],
                           twin.F[datatype]):
            _assert_sets_equal(m, t)
            for x, y in zip(m[0], w[0]):      # the encodings themselves
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(m[1], w[1])
    assert sorted(mine.Y) == sorted(theirs.Y)
    for split in mine.Y:
        np.testing.assert_array_equal(mine.Y[split], theirs.Y[split])
        assert {tuple(r) for r in mine.Y[split]} \
            == {tuple(r) for r in np.asarray(twin.Y[split]).reshape(-1, 2)}
    assert sorted(mine.data) == sorted(theirs.data) == sorted(twin.data)
    for split in mine.data:
        np.testing.assert_array_equal(mine.data[split], theirs.data[split])
        np.testing.assert_array_equal(mine.data[split], twin.data[split])
    assert mine.sample_map == theirs.sample_map == twin.sample_map
    assert mine.class_map == theirs.class_map == list(twin.class_map)
    if kind == "nc":
        # twelve list members, read back in numeric (not lexical) order
        with tarfile.open(tar) as t:
            members = [n for n in t.getnames() if n.startswith("list/")]
        assert len(members) == NUM_CLASSES >= 10
        assert mine.class_map == [f"class{c}" for c in range(NUM_CLASSES)]
        assert set(mine.F) == {"xsd.numeric", "xsd.gYear", "xsd.string",
                               "ogc.wktLiteral", "blob.image"}


class _Planted:
    def __reduce__(self):
        import os
        return (os.getcwd, ())


@pytest.mark.parametrize("read", [reference_tar.artifact_from_reference_tar,
                                  jax_reference_tar
                                  .artifact_from_reference_tar],
                         ids=["port", "jax"])
def test_unpickler_refuses_a_planted_global(twins, tmp_path, read):
    _, tar = twins["nc"]
    planted = str(tmp_path / "planted.tar")
    with tarfile.open(tar) as src, tarfile.open(planted, "w") as dst:
        for member in src.getmembers():
            raw = src.extractfile(member).read()
            if member.name == "sample_map.pkl":
                raw = pickle.dumps({"train": _Planted()}, protocol=4)
                member.size = len(raw)
            dst.addfile(member, io.BytesIO(raw))
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd|"
                       "os.getcwd|nt.getcwd"):
        read(planted)


def _config(epochs=2, features=FEATURES):
    return apply_defaults({
        "name": "REF", "graph": {"features": [dict(f) for f in features]},
        "task": {"type": "node classification", "seed": 0},
        "model": {"epoch": epochs, "num_bases": 3,
                  "layers": [{"hidden_nodes": 16}, {"type": "mrgcn"}]}})


@pytest.fixture(scope="module")
def mapped(twins):
    """A reference-named state dict from a port model whose running
    statistics moved, both packages' mappings of it onto a model of
    their own, and their inputs."""
    art = artifact_io.load(twins["nc"][0])
    config = _config()
    tin = prepare_inputs(art, config, False, CPU)
    source = nc.build_model(tin, config, NUM_CLASSES,
                            torch.Generator().manual_seed(7))
    labels = np.asarray(art.Y["train"]).reshape(-1, 2)
    batch = nc.make_batches(tin, labels, -1, 2)[0]
    with torch.no_grad():
        source(batch.edges, batch.features, train=True)
        source.gate_weights.copy_(torch.tensor([0.3, -0.2]))
    sd = reference_state_dict(source)
    assert any(k.endswith(".running_mean") for k in sd)
    assert "rgcn.layers.layer_0.weight_I" in sd
    # a frozen backbone's weight and the image normaliser: no counterpart
    sd["module_dict.xsd_numeric_0.base_model.weight"] = torch.zeros(3)
    sd["im_norm"] = torch.zeros(3)
    sd = {k: v.numpy() for k, v in sd.items()}

    target = nc.build_model(tin, config, NUM_CLASSES,
                            torch.Generator().manual_seed(8))
    params, stats, unmapped = torch_import.map_state_dict(sd, target)

    jin = jax_prepare_inputs(jax_artifact_io.load(twins["nc"][0]), config,
                             False)
    jmodel = jnc.build_model(jin, config, NUM_CLASSES)
    variables = jmodel.init(jax.random.PRNGKey(0), jin.features, jin.edges)
    jparams, jstats, junmapped = jax_torch_import.map_state_dict(
        sd, jmodel, variables["params"], variables["batch_stats"])
    return (source, target, batch, (params, stats, unmapped),
            (jin, jmodel, (jparams, jstats, junmapped)), labels)


def test_both_packages_map_the_same_tree(mapped):
    source, _, _, (params, stats, unmapped), (_, _, theirs), _ = mapped
    jparams, jstats, junmapped = theirs
    assert unmapped == junmapped == [
        "module_dict.xsd_numeric_0.base_model.weight"]
    for mine, other in ((params, jparams), (stats, jstats)):
        assert jax.tree.structure(mine) == jax.tree.structure(
            jax.tree.map(np.asarray, other))
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(other)):
            np.testing.assert_array_equal(a, np.asarray(b))
    # and the mapping is the inverse of the reference naming
    target = mapped[1]
    load_jax_params(target, params, stats)
    for name, t in source.state_dict().items():
        assert torch.equal(target.state_dict()[name], t), name


def test_both_packages_forward_the_mapped_tree(mapped):
    """Each package's own full batch over the training labels, eval mode:
    the labelled rows' logits within 1e-5."""
    _, target, batch, (params, stats, _), (jin, jmodel, theirs), _ = mapped
    load_jax_params(target, params, stats)
    jparams, jstats, _ = theirs
    jbatch = jnc.make_batches(jin, mapped[5], -1, 2)[0]
    want = np.asarray(jmodel.apply(
        {"params": jparams, "batch_stats": jstats}, jbatch.features,
        jbatch.edges, train=False))[np.asarray(jbatch.idx)]
    with torch.no_grad():
        got = target(batch.edges, batch.features)[batch.idx].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_reference_checkpoint_loads_with_a_fresh_optimizer(mapped, twins,
                                                           tmp_path,
                                                           capsys):
    source = mapped[0]
    path = str(tmp_path / "reference.pt")
    save_reference_checkpoint(path, source, epoch=5, loss=0.75)
    state = tutils.load_checkpoint(path)
    assert state["format"] == "torch" and state["epoch"] == 5
    assert state["loss"] == pytest.approx(0.75)
    assert jutils.load_checkpoint(path)["epoch"] == 5

    seen = []
    step = nc.train_step

    def first_step(model, optimizer, *args, **kwargs):
        if not seen:        # the optimizer before its first step
            seen.append(dict(optimizer.adam.state))
            seen.append({k: v.clone()
                         for k, v in model.state_dict().items()})
        return step(model, optimizer, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nc, "train_step", first_step)
        res = nc.run(artifact_io.load(twins["nc"][0]), _config(1), _Rows(),
                     False, "test", 0, CPU, checkpoint=path)
    assert "[LOAD] Loading model state - 5 epoch" in capsys.readouterr().out
    assert res.epoch == 6 and [h["epoch"] for h in res.history] == [6]
    assert seen[0] == {}
    for name, t in source.state_dict().items():
        assert torch.equal(seen[1][name], t), name
    assert {float(s["step"]) for s in res.optimizer.adam.state.values()} \
        == {1.0}


class _Rows:
    def writerow(self, row):
        pass


@pytest.mark.parametrize("kind", ["nc", "lp"])
def test_cli_trains_a_tar_as_its_npz_twin(twins, tmp_path, monkeypatch,
                                          kind):
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    cfg = tmp_path / f"{kind}.toml"
    if kind == "nc":
        cfg.write_text(
            'name = "TAR"\n[task]\ntype = "node classification"\nseed = 0\n'
            '[model]\nepoch = 2\nnum_bases = 3\n[[model.layers]]\n'
            'hidden_nodes = 16\n[[model.layers]]\ntype = "mrgcn"\n'
            '[[graph.features]]\ndatatype = "xsd.numeric"\ninclude = true\n'
            'embedding_dim = 4\n')
    else:
        cfg.write_text(
            'name = "TAR"\n[task]\ntype = "link prediction"\nseed = 0\n'
            'eval_interval = 1\n[model]\nepoch = 2\nnum_bases = 2\n'
            '[[model.layers]]\nhidden_nodes = 16\n[[model.layers]]\n'
            'hidden_nodes = 16\n[[model.layers]]\ntype = "mrgcn"\n')
    results = [torch_run.run_cli(["-c", str(cfg), "-i", path, "-o",
                                  str(tmp_path), "--dry_run", "--test"])
               for path in twins[kind]]
    key = "train_loss" if kind == "nc" else "loss"
    losses = [[h[key] for h in r.history] + [r.loss] for r in results]
    assert len(losses[0]) == 3 and all(np.isfinite(losses[0]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
