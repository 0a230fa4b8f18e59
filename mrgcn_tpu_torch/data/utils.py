"""Host-side utilities: config access, path checks, seeding, and the
ETL's graph stripping and triple indexing.

The port's copy of :mod:`mrgcn_tpu.data.utils`.
"""

from __future__ import annotations

import logging
import os
import random
from os import F_OK, R_OK, W_OK, access
from os.path import split
from typing import Dict

import numpy as np

from mrgcn_tpu_torch.data.rdf import IRI

logger = logging.getLogger(__name__)


def getConfParam(config, name: str, default=None):
    """Access a nested dict by a dot-separated key string
    (reference: data/utils.py:19-29)."""
    for part in name.split("."):
        if not isinstance(config, dict) or part not in config:
            return default
        config = config[part]
    return config


def is_readable(filename: str) -> bool:
    path = split(filename)[0]
    if not access(path, F_OK):
        raise OSError(f":: Path does not exist: {path}")
    if not access(path, R_OK):
        raise OSError(f":: Path not readable by user: {path}")
    return True


def is_writable(filename: str) -> bool:
    path = split(filename)[0]
    if not access(path, F_OK):
        raise OSError(f":: Path does not exist: {path}")
    if not access(path, W_OK):
        raise OSError(f":: Path not writeable by user: {path}")
    return True


def is_gzip(filename: str) -> bool:
    return filename.endswith(".gz")


def set_seed(seed: int = -1) -> int:
    """Seed Python/NumPy RNGs; torch generators are seeded from the returned
    seed. ``seed < 0`` draws a random seed (reference: data/utils.py:52-62)."""
    if seed < 0:
        seed = int(np.random.randint(0, 2**31 - 1))

    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)

    logger.debug("Setting seed to %d", seed)
    return seed


def strip_graph(kg, config: Dict) -> None:
    """Remove inverse target relations from the knowledge graph ``kg`` to
    prevent label leakage (reference: data/utils.py:64-80)."""
    target_property_inv = config["task"]["target_property_inv"]
    if target_property_inv == "":
        return

    n = len(kg)
    kg.remove_triples(kg.triples((None, IRI(target_property_inv), None),
                                 separate_literals=False))
    m = len(kg)
    logger.debug("stripped %d triples (%d remain)", n - m, m)


def triples_to_indices(kg, node_map: Dict, edge_map: Dict,
                       separate_literals: bool = False) -> np.ndarray:
    """Convert a triple split (a knowledge graph) to an ``(n, 3)`` int32
    index array, rows sorted (reference: data/utils.py:88-93)."""
    data = np.zeros((len(kg), 3), dtype=np.int32)
    for i, (s, p, o) in enumerate(
            kg.triples(separate_literals=separate_literals)):
        data[i] = (node_map[s], edge_map[p], node_map[o])
    # canonical row order: the artifact (and every batch and corruption
    # drawn from it) must not follow the order in which triples were read
    return data[np.lexsort((data[:, 2], data[:, 1], data[:, 0]))]
