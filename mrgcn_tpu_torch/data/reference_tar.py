"""Reference-tarball importer: read the upstream ``mkdataset`` archive.

The port's copy of :mod:`mrgcn_tpu.data.reference_tar` (host code).

The reference persists datasets as a tar of numpy/scipy/pickle/torch
members with six top-level names — ``A`` (scipy CSR ``(n, R*n)`` stacked
adjacency, D^-1-normalised), ``F`` (per-datatype encoding sets), ``Y``
(per-split one-hot CSR label matrices for NC), ``data`` (per-split triple
index arrays for LP), ``sample_map`` and ``class_map``
(reference: mrgcn/data/io/tarball.py:14-332, mkdataset.py:119-122).

This module reads that format WITHOUT the reference's unrestricted
``pickle.load`` (tarball.py:218-219): pickled members pass through a
restricted unpickler that admits only numpy array reconstruction,
container builtins, and rdflib term classes (mapped onto plain ``str``
stand-ins — rdflib is not installed here), so loading a tarball never
executes arbitrary code. torch ``.pt`` members load with
``weights_only=True`` for the same reason.

``artifact_from_reference_tar`` converts the members onto
:class:`mrgcn_tpu_torch.data.artifact.Artifact`, so ``run.py -i dataset.tar``
trains directly on a reference-produced archive.
"""

from __future__ import annotations

import importlib
import io
import logging
import os
import pickle
import tarfile
from typing import Dict, List

import numpy as np
import scipy.sparse as sp
import torch

from mrgcn_tpu_torch.data.artifact import Artifact
from mrgcn_tpu_torch.encodings.structure import GraphStructure

logger = logging.getLogger(__name__)


class _Str(str):
    """Stand-in for rdflib terms (URIRef/Literal/BNode are str
    subclasses, so a plain str subclass round-trips their pickles)."""

    def __new__(cls, *args, **kwargs):
        value = args[0] if args else ""
        return super().__new__(cls, value)

    def __init__(self, *args, **kwargs):  # absorb datatype/lang kwargs
        pass

    def __setstate__(self, state):  # rdflib Literal pickles extra state
        pass


_ALLOWED_GLOBALS = {
    # numpy array reconstruction (np.save of object arrays and pickled
    # ndarrays route through these)
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.dtypes", "Float32DType"),
    ("numpy.dtypes", "Float64DType"),
    ("numpy.dtypes", "Int32DType"),
    ("numpy.dtypes", "Int64DType"),
    ("numpy.dtypes", "Int8DType"),
    ("numpy.dtypes", "UInt8DType"),
    ("numpy.dtypes", "BoolDType"),
    ("numpy.dtypes", "ObjectDType"),
    ("numpy.dtypes", "StrDType"),
    ("collections", "OrderedDict"),
}

# rdflib term classes appear inside sample_map / separated-literal keys;
# map them (and the parity shim's copies) onto the str stand-in
_RDFLIB_MODULES = ("rdflib.term", "rdflib", "rdflib.plugins")


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED_GLOBALS:
            mod = importlib.import_module(module)
            return getattr(mod, name)
        if module.startswith(_RDFLIB_MODULES):
            return _Str
        raise pickle.UnpicklingError(
            f"reference tarball member pickles {module}.{name}, which is "
            f"not on the import allowlist")


def _restricted_loads(raw: bytes):
    return _RestrictedUnpickler(io.BytesIO(raw)).load()


def _read_npy(raw: bytes):
    """np.load for a .npy member; object arrays re-route their pickle
    payload through the restricted unpickler."""
    buf = io.BytesIO(raw)
    try:
        return np.load(buf, allow_pickle=False)
    except ValueError:
        # object-dtype .npy: the data section after the header is a
        # pickle.dump of the array (numpy.lib.format.write_array)
        buf.seek(0)
        version = np.lib.format.read_magic(buf)
        np.lib.format._check_version(version)
        np.lib.format._read_array_header(buf, version)
        return _restricted_loads(buf.read())


def _read_csr_npz(raw: bytes):
    with np.load(io.BytesIO(raw), allow_pickle=False) as loader:
        return sp.csr_matrix(
            (loader["data"], loader["indices"], loader["indptr"]),
            shape=loader["shape"], dtype=np.float32)


def _read_pt(raw: bytes):
    obj = torch.load(io.BytesIO(raw), map_location="cpu",
                     weights_only=True)
    return obj.numpy() if hasattr(obj, "numpy") else obj


def _read_member(name: str, raw: bytes):
    ext = os.path.splitext(name)[-1]
    if ext == ".npz":
        return _read_csr_npz(raw)
    if ext == ".npy":
        return _read_npy(raw)
    if ext == ".pt":
        return _read_pt(raw)
    return _restricted_loads(raw)  # .pkl and extension-less pickles


def read_reference_tar(path: str) -> Dict:
    """Read a reference tarball into ``{name: object}`` following the
    writer's layout (reference: tarball.py:58-117): top-level members by
    extension, ``dict/<top>/...`` nested dicts, ``list/<top>/<i>``
    ordered lists (read back in NUMERIC order — the reference's own
    reader sorts lexicographically, tarball.py:82, which scrambles lists
    of 10+ items), and ``<top>/{indices,values,size}.pt`` sparse
    tensors."""
    out: Dict = {}
    with tarfile.open(path, "r") as tar:
        members = {m.name: m for m in tar.getmembers() if m.isfile()}

        def raw(name):
            return tar.extractfile(members[name]).read()

        flats = [n for n in members if "/" not in n]
        nested = [n for n in members if "/" in n]

        for name in flats:
            base = os.path.splitext(name)[0]
            out[base] = _read_member(name, raw(name))

        dict_paths = [n for n in nested if n.split("/")[0] == "dict"]
        list_paths = [n for n in nested if n.split("/")[0] == "list"]
        other = [n for n in nested
                 if n.split("/")[0] not in ("dict", "list")]

        for name in dict_paths:
            parts = name.split("/")[1:]
            top, keys, leaf = parts[0], parts[1:-1], parts[-1]
            node = out.setdefault(top, {})
            for k in keys:
                node = node.setdefault(k, {})
            node[os.path.splitext(leaf)[0]] = _read_member(name, raw(name))

        list_tops: Dict[str, List] = {}
        for name in list_paths:
            parts = name.split("/")[1:]
            top, leaf = parts[0], parts[-1]
            idx = int(os.path.splitext(leaf)[0])
            list_tops.setdefault(top, []).append(
                (idx, _read_member(name, raw(name))))
        for top, items in list_tops.items():
            out[top] = [v for _, v in sorted(items)]

        # torch sparse tensors ({indices,values,size}.pt folders)
        sparse_tops = {n.split("/")[0] for n in other}
        for top in sparse_tops:
            leaves = {n.split("/", 1)[1] for n in other
                      if n.split("/")[0] == top}
            if leaves == {"indices.pt", "values.pt", "size.pt"}:
                idc = _read_pt(raw(f"{top}/indices.pt"))
                val = _read_pt(raw(f"{top}/values.pt"))
                size = _read_pt(raw(f"{top}/size.pt"))
                out[top] = sp.coo_matrix(
                    (val, (idc[0], idc[1])), shape=tuple(size)).tocsr()
    return out


def _structure_from_csr(A) -> GraphStructure:
    """Reference ``(n, R*n)`` CSR -> relation-partitioned COO, lexsorted
    (rel, src, dst) — the canonical order; norms come over verbatim."""
    n = A.shape[0]
    num_relations = A.shape[1] // n
    coo = A.tocoo()
    src = coo.row.astype(np.int32)
    rel = (coo.col // n).astype(np.int32)
    dst = (coo.col % n).astype(np.int32)
    norm = coo.data.astype(np.float32)
    order = np.lexsort((dst, src, rel))
    return GraphStructure(num_nodes=int(n),
                          num_relations=int(num_relations),
                          src=src[order], dst=dst[order],
                          rel=rel[order], norm=norm[order])


def _labels_from_csr(Y) -> np.ndarray:
    """One-hot ``(num_nodes, num_classes)`` CSR -> our ``(N, 2)``
    ``[node_idx, class_idx]`` rows (row-major order)."""
    rows, cols = Y.nonzero()
    return np.stack([rows.astype(np.int32), cols.astype(np.int32)],
                    axis=1)


def _convert_encoding_sets(datatype: str, sets: List) -> List:
    """Reference encoding sets ([encodings, node_idx, seq_lengths]) ->
    our F layout: dense float32/int32/uint8 arrays stay dense; lists or
    object arrays of per-literal sequences become object ndarrays (the
    densify step buckets them)."""
    out = []
    for enc_set in sets:
        enc, node_idx, lengths = enc_set[0], enc_set[1], enc_set[2]
        if isinstance(enc, list):
            arr = np.empty(len(enc), dtype=object)
            for i, e in enumerate(enc):
                arr[i] = np.asarray(e)
            enc = arr
        elif isinstance(enc, np.ndarray) and enc.dtype != np.dtype("O") \
                and enc.dtype != np.uint8:
            enc = enc.astype(np.float32) if enc.dtype.kind == "f" \
                else enc
        out.append([enc, np.asarray(node_idx, dtype=np.int32),
                    np.asarray(lengths)])
    return out


def artifact_from_reference_tar(path: str) -> Artifact:
    """Load a reference-produced ``.tar`` dataset as an
    :class:`mrgcn_tpu_torch.data.artifact.Artifact`."""
    content = read_reference_tar(path)

    structure = _structure_from_csr(content["A"])

    F: Dict[str, List] = {}
    for datatype, sets in (content.get("F") or {}).items():
        F[datatype] = _convert_encoding_sets(datatype, sets)

    Y: Dict[str, np.ndarray] = {}
    y_raw = content.get("Y")
    if isinstance(y_raw, dict):
        Y = {split: _labels_from_csr(mat) for split, mat in y_raw.items()}
    # (LP tarballs carry a dummy empty tensor here — ignored)

    data: Dict[str, np.ndarray] = {}
    d_raw = content.get("data")
    if isinstance(d_raw, dict):
        data = {split: np.asarray(mat, dtype=np.int32)
                for split, mat in d_raw.items()}

    sample_map = content.get("sample_map")
    if isinstance(sample_map, dict):
        sample_map = {split: [str(s) for s in v]
                      for split, v in sample_map.items()}
    else:
        sample_map = {}

    class_map = content.get("class_map")
    class_map = [str(c) for c in class_map] \
        if isinstance(class_map, list) else []

    logger.info("Imported reference tarball: %d nodes, %d relations, "
                "%d feature datatype(s), Y splits %s, data splits %s",
                structure.num_nodes, structure.num_relations, len(F),
                sorted(Y), sorted(data))
    return Artifact(structure, F, Y, data, sample_map, class_map)
