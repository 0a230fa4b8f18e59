"""The port's ``mkdataset.build`` against the JAX package's, array by
array, on every config under ``configs/``.

Each config runs on its synthetic stand-in graph
(``tests/prestage.make_dataset_for_config``: 48 entities carrying exactly
the datatypes the config includes, as N-Triples). Both packages build from
the same files; ``A`` (structure), ``F`` (every encoding set), ``Y``,
``data``, ``sample_map`` and ``class_map`` must be equal: integers exactly,
floats bit for bit. Both artifacts are then saved, each by its package's
``artifact.save``, and loaded with the port's ``artifact.load``, and must
be equal again. The configs whose string feature names
``distilbert-base-multilingual-cased`` meet an empty, offline hub cache
here, so both packages tokenize bytes (the WordPiece path is
``tests/test_torch_etl_wordpiece.py``'s). The parity graphs under
``benchmarks/parity/big`` and ``multiprocessing = true`` are
``tests/test_torch_etl_cli.py``'s.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import copy  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mrgcn_tpu import mkdataset as jmk  # noqa: E402
from mrgcn_tpu.config import load_config  # noqa: E402
from mrgcn_tpu.data import artifact as jartifact  # noqa: E402
from mrgcn_tpu_torch import mkdataset as tmk  # noqa: E402
from mrgcn_tpu_torch.data import artifact as tartifact  # noqa: E402

from tests import prestage  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.toml"))


def same(got, want, where="") -> None:
    """Equal nested lists / dicts of arrays: dtype, shape and bytes."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray) and want.dtype == object:
        assert got.dtype == object and got.shape == want.shape, where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        assert got.tobytes() == want.tobytes(), where
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def same_structure(got, want) -> None:
    assert (got.num_nodes, got.num_relations) == (want.num_nodes,
                                                  want.num_relations)
    for name in ("src", "dst", "rel", "norm"):
        same(getattr(got, name), getattr(want, name), f"A/{name}")


def same_build(got, want) -> None:
    """Two ``build()`` results: (A, F, Y, data, sample_map, class_map)."""
    same_structure(got[0], want[0])
    for i, name in enumerate(("F", "Y", "data", "sample_map", "class_map"),
                             start=1):
        same(got[i], want[i], name)


def same_saved(tmp, got, want) -> None:
    """Each build saved by its own package, both loaded by the port."""
    arts = []
    for tag, module, (A, F, Y, data, sample_map, class_map) in (
            ("port", tartifact, got), ("jax", jartifact, want)):
        path = str(tmp / f"{tag}.npz")
        module.save(path, A, F, Y=Y, data=data, sample_map=sample_map,
                    class_map=class_map)
        arts.append(tartifact.load(path))
    port, jax = arts
    same_structure(port.structure, jax.structure)
    for name in ("F", "Y", "data", "sample_map", "class_map"):
        same(getattr(port, name), getattr(jax, name), name)
    same(port.F, got[1], "F as built")


@pytest.fixture
def empty_hub(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    try:
        import huggingface_hub.constants as hub_constants
        monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
        monkeypatch.setattr(hub_constants, "HF_HUB_CACHE",
                            str(tmp_path / "hub"))
    except ImportError:
        pass


@pytest.mark.parametrize("name", CONFIGS)
def test_build_matches_the_jax_package(name, tmp_path, empty_hub):
    config = copy.deepcopy(load_config(str(REPO / "configs" / name)))
    config["graph"].update(prestage.make_dataset_for_config(
        config, str(tmp_path / "data")))
    if config["task"]["type"] == "node classification":
        config["task"]["target_property"] = prestage.EX + "hasClass"
        config["task"]["target_property_inv"] = ""
    want = jmk.build(copy.deepcopy(config))
    got = tmk.build(copy.deepcopy(config))
    same_build(got, want)
    assert got[0].num_edges > 0
    same_saved(tmp_path, got, want)
