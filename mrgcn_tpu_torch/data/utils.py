"""Host-side utilities: config access, path checks, seeding.

The port's copy of the run-time part of :mod:`mrgcn_tpu.data.utils`
(the graph-stripping and triple-indexing helpers belong to the ETL and
are not ported).
"""

from __future__ import annotations

import logging
import os
import random
from os import F_OK, R_OK, W_OK, access
from os.path import split

import numpy as np

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
