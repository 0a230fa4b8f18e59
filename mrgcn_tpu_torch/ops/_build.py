"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``mrgcn_tpu_torch/csrc/`` exposes a plain C
interface. At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library and loaded with :mod:`ctypes`; no
PyTorch header is compiled, so a build takes seconds. Libraries are cached
in ``mrgcn_tpu_torch/_build/`` under a hash of the source and the compiler
flags, so an edited source rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the CPU test suite imports every module
of the port on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# shared memory one thread block may use on Hopper (232,448 bytes)
SMEM_LIMIT = 227 * 1024

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class KernelLibrary:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when loaded from the cache
    ptxas_log: str         # registers / shared memory / spills per kernel


_loaded: dict = {}
_locks: dict = {}
_locks_guard = threading.Lock()


def _lock_for(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else the toolkit's usual home, else PATH."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels build at first "
                       "use and need the CUDA toolkit (set CUDA_HOME)")


def _digest(source: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    return h.hexdigest()[:16]


def _compile(source: Path, target: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)   # atomic: a concurrent load never sees half
    return log


def load(name: str, rebuild: bool = False) -> KernelLibrary:
    """Build (if needed, or always with ``rebuild``) and load
    ``csrc/<name>.cu``. A library already loaded in this process is
    returned as it is. Different libraries build concurrently."""
    with _lock_for(name):
        if name in _loaded:
            return _loaded[name]
        source = CSRC_DIR / f"{name}.cu"
        target = BUILD_DIR / f"lib{name}-{_digest(source)}.so"
        t0 = time.perf_counter()
        if target.is_file() and not rebuild:
            seconds = 0.0
            log_file = target.with_suffix(".log")
            log = log_file.read_text() if log_file.is_file() else ""
        else:
            log = _compile(source, target)
            seconds = time.perf_counter() - t0
        lib = KernelLibrary(ctypes.CDLL(str(target)), target, seconds, log)
        _loaded[name] = lib
        return lib


def load_all(names, rebuild: bool = False) -> dict:
    """:func:`load` for several libraries at once, one ``nvcc`` each, all
    started together. Returns ``{name: KernelLibrary}``."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        libs = pool.map(lambda n: load(n, rebuild=rebuild), names)
        return dict(zip(names, libs))


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name`` with its C functions typed:
    ``signatures`` maps a function name to ``(argtypes, restype)``. Every
    pointer and the stream go as ``c_void_p`` (a Python int would be cut
    to 32 bits)."""
    lib = load(name).lib
    if not getattr(lib, "_mrgcn_typed", False):
        for fn, (argtypes, restype) in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        lib._mrgcn_typed = True
    return lib
