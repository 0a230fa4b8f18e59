"""ctypes bindings for the native BFS sampler and N-Triples parser.

The port's copy of :mod:`mrgcn_tpu.data.native`. Builds
``mrgcn_tpu_torch/native/sampler.cpp`` and ``native/ntparse.cpp`` on first
use (``g++ -O3 -shared``; the parser links zlib) into the package's
``_build/`` directory, beside the CUDA kernels' libraries and never into
the source tree, and loads them with :mod:`ctypes`. Where a library cannot
be built or loaded, its getter returns None and says so once in the log at
warning level: :class:`..batching.EdgeIndex` then walks the hop with numpy,
and :func:`..kg._read_path` parses with :mod:`..ntriples`. Either way the
result is the same, host code either way.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from mrgcn_tpu_torch.data.ntriples import Triple
from mrgcn_tpu_torch.data.rdf import BNode, IRI, Literal

logger = logging.getLogger(__name__)

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SAMPLER_SRC = os.path.join(_PACKAGE_DIR, "native", "sampler.cpp")
_BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
_SAMPLER_SO = os.path.join(_BUILD_DIR, "_sampler.so")
_SRC = os.path.join(_PACKAGE_DIR, "native", "ntparse.cpp")
_SO = os.path.join(_BUILD_DIR, "_ntparse.so")

_lock = threading.Lock()
_sampler_lib: Optional[ctypes.CDLL] = None
_sampler_failed = False
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


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


def get_lib() -> Optional[ctypes.CDLL]:
    """The native N-Triples parser (``mrgcn_tpu_torch/native/ntparse.cpp``,
    linked with ``-lz``), or None where it cannot be built or loaded (no
    compiler, no zlib headers)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib = _load_so(_SRC, _SO, ("-lz",))
        if lib is None:
            _build_failed = True
            logger.warning("native N-Triples parser unavailable: parsing "
                           "takes the Python path")
            return None

        lib.nt_parse.restype = ctypes.c_void_p
        lib.nt_parse.argtypes = [ctypes.c_char_p]
        for name in ("nt_num_terms", "nt_num_triples", "nt_pool_size",
                     "nt_skipped", "nt_has_nul"):
            getattr(lib, name).restype = ctypes.c_uint64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.nt_error.restype = ctypes.c_char_p
        lib.nt_error.argtypes = [ctypes.c_void_p]
        for name, typ in (("nt_pool", ctypes.c_char),
                          ("nt_offsets", ctypes.c_uint64),
                          ("nt_kinds", ctypes.c_uint8),
                          ("nt_lang_ids", ctypes.c_int64),
                          ("nt_dtype_ids", ctypes.c_int64),
                          ("nt_triples", ctypes.c_uint32)):
            getattr(lib, name).restype = ctypes.POINTER(typ)
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.nt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def parse_file_native(path: str) -> Optional[List[Triple]]:
    """Parse with the native parser, in file order with duplicates kept (the
    output contract of :func:`..ntriples.parse_file`). None where the
    library is unavailable, or where the file cannot be opened or its gzip
    stream is corrupt (logged at warning level): the caller then parses
    with Python, which gives the same triples or raises."""
    lib = get_lib()
    if lib is None:
        return None

    handle = lib.nt_parse(path.encode())
    try:
        err = lib.nt_error(handle)
        if err:
            logger.warning("native parse error for %s: %s; parsing with "
                           "Python", path, err.decode())
            return None

        n_terms = lib.nt_num_terms(handle)
        n_triples = lib.nt_num_triples(handle)
        pool_size = lib.nt_pool_size(handle)
        skipped = lib.nt_skipped(handle)
        has_nul = lib.nt_has_nul(handle)
        if skipped:
            logger.debug("native parser skipped %d malformed lines", skipped)
        if n_triples == 0:
            return []   # no arrays to read (their pointers are null)

        pool = ctypes.string_at(lib.nt_pool(handle), pool_size)
        offsets = np.ctypeslib.as_array(lib.nt_offsets(handle),
                                        (n_terms + 1,)).copy()
        kinds = np.ctypeslib.as_array(lib.nt_kinds(handle),
                                      (n_terms,)).copy()
        lang_ids = np.ctypeslib.as_array(lib.nt_lang_ids(handle),
                                         (n_terms,)).copy()
        dtype_ids = np.ctypeslib.as_array(lib.nt_dtype_ids(handle),
                                          (n_terms,)).copy()
        tri = np.ctypeslib.as_array(lib.nt_triples(handle),
                                    (n_triples * 3,)).reshape(-1, 3).copy()
    finally:
        lib.nt_free(handle)

    # pool entries are NUL-terminated: one decode and one split; a term
    # whose text itself holds an escaped NUL takes the offsets instead
    if not has_nul:
        texts = pool.decode("utf-8").split("\0")
        texts.pop()  # trailing "" after the last terminator
    else:
        off = offsets.tolist()
        texts = [pool[off[i]:off[i + 1] - 1].decode("utf-8")
                 for i in range(n_terms)]
    assert len(texts) == n_terms

    # sentinel None at index n_terms: lang/dtype ids of -1 map there
    texts_arr = np.array(texts + [None], dtype=object)
    terms = np.empty(n_terms + 1, dtype=object)
    for kind, cls in ((0, IRI), (1, BNode)):
        idx = np.nonzero(kinds == kind)[0]
        if idx.size:
            terms[idx] = np.fromiter(map(cls, texts_arr[idx].tolist()),
                                     dtype=object, count=idx.size)
    lit = np.nonzero(kinds == 2)[0]
    if lit.size:
        langs = texts_arr[np.where(lang_ids[lit] >= 0, lang_ids[lit],
                                   n_terms)].tolist()
        dtypes = texts_arr[np.where(dtype_ids[lit] >= 0, dtype_ids[lit],
                                    n_terms)].tolist()
        terms[lit] = np.fromiter(
            map(Literal, texts_arr[lit].tolist(), langs, dtypes),
            dtype=object, count=lit.size)
    # kind 3: aux strings (language tags), not terms

    return list(zip(terms[tri[:, 0]].tolist(), terms[tri[:, 1]].tolist(),
                    terms[tri[:, 2]].tolist()))
