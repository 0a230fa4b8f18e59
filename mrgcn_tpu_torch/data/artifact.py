"""Dataset artifact: the contract between ``mkdataset`` and ``run``.

The port's copy of :mod:`mrgcn_tpu.data.artifact`; the ``.npz`` format is
shared, so either package reads what the other wrote.

Replaces the reference's pickle/npz/pt tarball
(reference: mrgcn/data/io/tarball.py:14-332) with a single compressed ``.npz``
holding flat numpy arrays plus a JSON manifest. Everything a training run
needs is stored densely or as flat+offsets ragged arrays, so loading is a
single mmap-friendly read with no pickled code execution.

Members mirror the reference tarball (reference: mkdataset.py:121-122,
run.py:63-69):

  * ``A``          — relation-partitioned COO structure (src/dst/rel/norm)
  * ``F``          — per-datatype, per-predicate encoding sets
  * ``Y``          — node-classification labels per split (empty for LP)
  * ``data``       — link-prediction triple index arrays per split
  * ``sample_map`` — per-split sample URIs (for prediction output)
  * ``class_map``  — class label strings
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from mrgcn_tpu_torch.encodings.structure import GraphStructure

FORMAT_VERSION = 1


def _store_ragged(store: Dict[str, np.ndarray], prefix: str,
                  ragged: np.ndarray) -> Dict:
    """Store an object array of 1-D int sequences or 2-D (C, L) arrays as a
    flat array + offsets."""
    sample = ragged[0]
    lengths = np.asarray([e.shape[-1] for e in ragged], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    if sample.ndim == 1:
        flat = np.concatenate(list(ragged)).astype(np.int32)
        kind = "ragged1d"
    else:
        flat = np.concatenate(list(ragged), axis=1).astype(np.float32)
        kind = "ragged2d"
    store[prefix + "/flat"] = flat
    store[prefix + "/offsets"] = offsets
    return {"kind": kind}


def _load_ragged(data, prefix: str, kind: str) -> np.ndarray:
    flat = data[prefix + "/flat"]
    offsets = data[prefix + "/offsets"]
    n = len(offsets) - 1
    out = np.empty(n, dtype=object)
    for i in range(n):
        lo, hi = offsets[i], offsets[i + 1]
        out[i] = flat[:, lo:hi] if kind == "ragged2d" else flat[lo:hi]
    return out


def save(path: str, structure: GraphStructure, F: Dict[str, List],
         Y: Optional[Dict[str, np.ndarray]] = None,
         data: Optional[Dict[str, np.ndarray]] = None,
         sample_map: Optional[Dict[str, List[str]]] = None,
         class_map: Optional[List[str]] = None) -> None:
    store: Dict[str, np.ndarray] = {
        "A/src": structure.src, "A/dst": structure.dst,
        "A/rel": structure.rel, "A/norm": structure.norm,
    }
    manifest: Dict = {
        "format_version": FORMAT_VERSION,
        "num_nodes": structure.num_nodes,
        "num_relations": structure.num_relations,
        "F": {}, "Y_splits": [], "data_splits": [],
        "class_map": class_map or [],
        "sample_map": sample_map or {},
    }

    for datatype, encoding_sets in (F or {}).items():
        set_infos = []
        for i, (enc, node_idx, seq_lengths) in enumerate(encoding_sets):
            prefix = f"F/{datatype}/{i}"
            if enc.dtype == np.dtype("O"):
                info = _store_ragged(store, prefix, enc)
            else:
                store[prefix + "/enc"] = enc
                info = {"kind": "dense"}
            store[prefix + "/node_idx"] = np.asarray(node_idx, dtype=np.int32)
            store[prefix + "/seq_lengths"] = np.asarray(seq_lengths)
            set_infos.append(info)
        manifest["F"][datatype] = set_infos

    for split, mat in (Y or {}).items():
        store[f"Y/{split}"] = np.asarray(mat, dtype=np.int32)
        manifest["Y_splits"].append(split)

    for split, mat in (data or {}).items():
        store[f"data/{split}"] = np.asarray(mat, dtype=np.int32)
        manifest["data_splits"].append(split)

    store["manifest"] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), dtype=np.uint8)
    _savez_fast(path, store)


def _savez_fast(path: str, store: Dict[str, np.ndarray]) -> None:
    """``np.savez_compressed``-format writer at deflate level 1.

    numpy hard-codes zlib level 6, which dominates artifact-save time;
    level 1 compresses faster for a few percent more bytes. ``np.load``
    reads any deflate level: the on-disk format is unchanged."""
    import io
    import zipfile

    from numpy.lib import format as npformat

    if not path.endswith(".npz"):
        path += ".npz"  # np.savez_compressed appends it too
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as zf:
        for key, val in store.items():
            buf = io.BytesIO()
            npformat.write_array(buf, np.asarray(val), allow_pickle=False)
            zf.writestr(key + ".npy", buf.getvalue())


class Artifact:
    """Loaded dataset artifact."""

    def __init__(self, structure: GraphStructure, F: Dict[str, List],
                 Y: Dict[str, np.ndarray], data: Dict[str, np.ndarray],
                 sample_map: Dict[str, List[str]], class_map: List[str]):
        self.structure = structure
        self.F = F
        self.Y = Y
        self.data = data
        self.sample_map = sample_map
        self.class_map = class_map


def load(path: str) -> Artifact:
    with np.load(path, allow_pickle=False) as npz:
        manifest = json.loads(bytes(npz["manifest"]).decode("utf-8"))
        if manifest["format_version"] > FORMAT_VERSION:
            raise ValueError("artifact written by a newer format version")

        structure = GraphStructure(
            num_nodes=int(manifest["num_nodes"]),
            num_relations=int(manifest["num_relations"]),
            src=npz["A/src"], dst=npz["A/dst"],
            rel=npz["A/rel"], norm=npz["A/norm"])

        F: Dict[str, List] = {}
        for datatype, set_infos in manifest["F"].items():
            sets = []
            for i, info in enumerate(set_infos):
                prefix = f"F/{datatype}/{i}"
                if info["kind"] == "dense":
                    enc = npz[prefix + "/enc"]
                else:
                    enc = _load_ragged(npz, prefix, info["kind"])
                sets.append([enc, npz[prefix + "/node_idx"],
                             npz[prefix + "/seq_lengths"]])
            F[datatype] = sets

        Y = {split: npz[f"Y/{split}"] for split in manifest["Y_splits"]}
        data = {split: npz[f"data/{split}"]
                for split in manifest["data_splits"]}

    return Artifact(structure, F, Y, data,
                    manifest["sample_map"], manifest["class_map"])
