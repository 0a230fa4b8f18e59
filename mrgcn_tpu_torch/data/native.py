"""ctypes bindings for the native BFS sampler.

Counterpart of the sampler half of :mod:`mrgcn_tpu.data.native`. Builds
``mrgcn_tpu_torch/native/sampler.cpp`` on first use (``g++ -O3 -shared``)
into the package's ``_build/`` directory, beside the CUDA kernels'
libraries and never into the source tree, and loads it with
:mod:`ctypes`. Where no compiler is there, :func:`get_sampler_lib` returns
None, says so once in the log, and :class:`..batching.EdgeIndex` walks the
hop with numpy: the same ids in the same order, host code either way.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SAMPLER_SRC = os.path.join(_PACKAGE_DIR, "native", "sampler.cpp")
_BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
_SAMPLER_SO = os.path.join(_BUILD_DIR, "_sampler.so")

_lock = threading.Lock()
_sampler_lib: Optional[ctypes.CDLL] = None
_sampler_failed = False


def _build_so(src: str, so: str, extra=()) -> bool:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # build beside the target and rename: another process that finds the
    # library finds a whole one
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, *extra,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native build of %s failed (%s)", os.path.basename(src),
                    e)
        return False


def _load_so(src: str, so: str, extra=()) -> Optional[ctypes.CDLL]:
    """(Re)build if stale, then dlopen. None on any failure."""
    if not os.path.exists(so) or \
            os.path.getmtime(so) < os.path.getmtime(src):
        if not _build_so(src, so, extra):
            return None
    try:
        return ctypes.CDLL(so)
    except OSError as e:
        logger.info("native load of %s failed (%s)", os.path.basename(so), e)
        return None


def get_sampler_lib() -> Optional[ctypes.CDLL]:
    """The native BFS sampler (``mrgcn_tpu_torch/native/sampler.cpp``), or
    None where it cannot be built or loaded."""
    global _sampler_lib, _sampler_failed
    with _lock:
        if _sampler_lib is not None or _sampler_failed:
            return _sampler_lib
        lib = _load_so(_SAMPLER_SRC, _SAMPLER_SO)
        if lib is None:
            _sampler_failed = True
            logger.warning("native BFS sampler unavailable: mini-batch "
                           "hops take the numpy path")
            return None
        lib.mg_bfs_hop.restype = ctypes.c_int64
        lib.mg_bfs_hop.argtypes = [
            ctypes.POINTER(ctypes.c_int64),   # indptr
            ctypes.POINTER(ctypes.c_int32),   # dst
            ctypes.c_int64,                   # num_nodes
            ctypes.POINTER(ctypes.c_int32),   # frontier
            ctypes.c_int64,                   # num_frontier
            ctypes.POINTER(ctypes.c_int64),   # eids_out
            ctypes.POINTER(ctypes.c_int32),   # neigh_out
            ctypes.POINTER(ctypes.c_int64),   # num_neigh_out
            ctypes.POINTER(ctypes.c_uint8),   # mark scratch
        ]
        _sampler_lib = lib
        return _sampler_lib
