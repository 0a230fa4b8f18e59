"""The port's ETL end to end: the parity graphs, ``multiprocessing =
true``, and the ``mkdataset`` CLI into the port's ``run``.

* ``benchmarks/parity/big/{nc,lp}`` (17,500 context triples with five
  literal datatypes; 8,400 link-prediction triples): both packages'
  ``mkdataset.build`` equal array by array, and equal again once saved
  (each package's ``artifact.save``) and loaded by the port.
* The NC parity config with ``multiprocessing = true``: the JAX
  package's ``structure`` maps the triples on a forked process pool (a
  fresh process runs it, so no fork copies the threads of the test
  process's JAX); the port reads the flag and builds in its one columnar
  pass. Both packages' arrays equal the single-process build's.
* ``python -m mrgcn_tpu_torch.mkdataset`` writes an artifact of a small
  multimodal NC graph (numeric, gYear and string literals), prints its
  path as the JAX CLI does, and ``mrgcn_tpu_torch.run`` (``run_cli``, on
  the CPU) trains it two epochs to finite losses; the JAX package's
  artifact of the same graph, through the same run, gives the same losses.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mrgcn_tpu import mkdataset as jmk
from mrgcn_tpu.config import load_config
from mrgcn_tpu.data import artifact as jartifact
from mrgcn_tpu_torch import mkdataset as tmk

from tests import synth
from tests.test_torch_etl_mkdataset import same_build, same_saved

REPO = Path(__file__).resolve().parent.parent
BIG = REPO / "benchmarks" / "parity" / "big"


def parity_config(task: str) -> dict:
    """The parity config with its graph paths in this checkout."""
    config = load_config(str(BIG / f"{task}_config.toml"))
    for split in ("context", "train", "valid", "test"):
        if split in config["graph"]:
            config["graph"][split] = str(BIG / task / f"{split}.nt.gz")
    return config


@pytest.mark.parametrize("task", ["nc", "lp"])
def test_parity_graphs_build_as_the_jax_package(task, tmp_path):
    want = jmk.build(parity_config(task))
    got = tmk.build(parity_config(task))
    same_build(got, want)
    assert got[0].num_nodes >= 3500
    if task == "nc":
        assert len(got[1]) == 5 and len(got[2]["train"]) > 0
    else:
        assert {k: len(v) for k, v in got[3].items()} == \
            {k: len(v) for k, v in want[3].items()}
    same_saved(tmp_path, got, want)


POOL_BUILD = """
import os, sys
sys.path.insert(0, {repo!r})
from tests.test_torch_etl_cli import parity_config
from mrgcn_tpu import mkdataset as jmk
from mrgcn_tpu.data import artifact as jartifact
from mrgcn_tpu_torch import mkdataset as tmk
from mrgcn_tpu_torch.data import artifact as tartifact
assert "jax" not in sys.modules and "torch" not in sys.modules
assert len(os.sched_getaffinity(0)) > 1
for name, mk, art in (("jax", jmk, jartifact), ("port", tmk, tartifact)):
    config = parity_config("nc")
    config["graph"]["structural"]["multiprocessing"] = True
    A, F, Y, data, sample_map, class_map = mk.build(config)
    art.save(os.path.join({tmp!r}, name + ".npz"), A, F, Y=Y, data=data,
             sample_map=sample_map, class_map=class_map)
print("ok-pool")
"""


def test_multiprocessing_builds_equal_arrays(tmp_path):
    if len(os.sched_getaffinity(0)) < 2:
        pytest.skip("one CPU: the JAX package's pool path is not taken")
    proc = subprocess.run(
        [sys.executable, "-c", POOL_BUILD.format(repo=str(REPO),
                                                 tmp=str(tmp_path))],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok-pool")
    A, F, Y, data, sample_map, class_map = jmk.build(parity_config("nc"))
    from mrgcn_tpu_torch.data import artifact as tartifact
    single = tmp_path / "single.npz"
    jartifact.save(str(single), A, F, Y=Y, data=data, sample_map=sample_map,
                   class_map=class_map)
    want = tartifact.load(str(single))
    for name in ("jax", "port"):
        got = tartifact.load(str(tmp_path / f"{name}.npz"))
        for field in ("src", "dst", "rel", "norm"):
            assert np.array_equal(getattr(got.structure, field),
                                  getattr(want.structure, field)), field
        assert got.Y.keys() == want.Y.keys()
        assert all(np.array_equal(got.Y[k], want.Y[k]) for k in want.Y)
        assert got.sample_map == want.sample_map


CONFIG = """name = "ETL_E2E"

[graph]
context = "{context}"
train = "{train}"
valid = "{valid}"
test = "{test}"

[graph.structural]
include_inverse_properties = true
exclude_properties = []
separate_literals = false
multiprocessing = false

[[graph.features]]
datatype = "xsd.numeric"
include = true
share_weights = false
embedding_dim = 4
p_dropout = 0.0

[[graph.features]]
datatype = "xsd.gYear"
include = true
share_weights = true
embedding_dim = 4
p_dropout = 0.0

[[graph.features]]
datatype = "xsd.string"
include = true
share_weights = true
embedding_dim = 8
p_dropout = 0.0

[task]
type = "node classification"
target_property = "http://example.org/hasClass"
target_property_inv = ""
seed = 1

[model]
epoch = 2
learning_rate = 0.01
num_bases = 2

[[model.layers]]
type = "mrgcn"
hidden_nodes = 8

[[model.layers]]
type = "mrgcn"
"""


def test_cli_artifact_trains_as_the_jax_package_artifact(tmp_path,
                                                         monkeypatch):
    paths = synth.make_nc_dataset(str(tmp_path / "data"), num_entities=40,
                                  with_strings=True, seed=3)
    cfg = tmp_path / "etl.toml"
    cfg.write_text(CONFIG.format(**paths))
    out = tmp_path / "out"
    out.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "mrgcn_tpu_torch.mkdataset", "-c", str(cfg),
         "-o", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    port_art = proc.stdout.strip().splitlines()[-1]
    assert port_art.startswith(str(out)) and port_art.endswith(".npz")
    assert Path(port_art).is_file() and Path(port_art[:-4] + ".log").is_file()

    A, F, Y, data, sample_map, class_map = jmk.build(
        load_config(str(cfg)))
    jax_art = str(tmp_path / "jax.npz")
    jartifact.save(jax_art, A, F, Y=Y, data=data, sample_map=sample_map,
                   class_map=class_map)

    from mrgcn_tpu_torch import run
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    losses = []
    for art in (port_art, jax_art):
        res = run.run_cli(["-c", str(cfg), "-i", art, "-o", str(out),
                           "--dry_run", "--test"])
        losses.append([h["train_loss"] for h in res.history])
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    assert losses[0][0] == losses[1][0]
    assert losses[0] == losses[1]
