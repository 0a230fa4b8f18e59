"""Import of the reference's ``torch.save`` checkpoints.

Counterpart of :mod:`mrgcn_tpu.tasks.torch_import`. The reference persists
``{epoch, model_state_dict, optimizer_state_dict, loss}`` with
``torch.save`` (reference: mrgcn/run.py:230-236). Its ``model_state_dict``
maps onto the JAX-layout tree of the port's model
(``state_dict_to_params(model.state_dict())``, the layout both packages
share), which :func:`..jax_import.load_jax_params` then loads:

  * R-GCN layers: ``rgcn.layers.layer_i.weight_I`` ((S*n, out), packed
    into the padded ``weight_i`` / ``weight_i_packed`` layout),
    ``weight_F`` -> ``weight_f``, ``weight_I_comp`` / ``weight_F_comp`` ->
    ``comp_i`` / ``comp_f``, ``b`` -> ``bias``
    (reference: mrgcn/layers/graph.py:17-58);
  * the DistMult relation vectors ``rgcn.relations`` and ``gate_weights``;
  * MLP encoders: ``module_dict.<name>.mlp.<3j>.{weight,bias}`` ->
    ``<name>.Dense_j`` (a torch Linear weight transposes onto the kernel,
    reference: mrgcn/models/perceptron.py:27-36);
  * TCNN encoders: the ``conv.<k>`` Conv1d / BatchNorm1d pairs onto the
    ``_ConvBNRelu_i`` stack (running statistics into the BatchNorm
    buffers) and the ``fc.{0,3}`` head onto ``Dense_0`` / ``Dense_1``
    (reference: mrgcn/models/temporal_cnn.py:26-150);
  * text and image heads: ``pre_fc`` / ``fc`` onto ``Dense_0`` /
    ``Dense_1`` where the shapes agree. Frozen backbone weights
    (``base_model.*``) and anything else without a counterpart are listed
    in ``unmapped``.

The optimizer state is not imported: resuming starts Adam afresh, as in
the JAX package.
"""

from __future__ import annotations

import copy
import importlib
import logging
import re
import zipfile
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from mrgcn_tpu_torch.models.encoders import _TCNN_PLANS
from mrgcn_tpu_torch.ops.rspmm import packing_factor
from mrgcn_tpu_torch.parallel import mesh as pmesh
from mrgcn_tpu_torch.tasks.jax_import import (state_dict_to_batch_stats,
                                              state_dict_to_params)

logger = logging.getLogger(__name__)


def load_torch_checkpoint(path: str) -> Dict:
    """Read a reference checkpoint with ``weights_only=True`` (no pickled
    code runs; the reference's own loader runs it)."""
    # the reference stores ``loss`` as a numpy scalar; its reconstruction
    # globals are data only
    safe = [np.dtype, np.ndarray]
    for mod in ("numpy._core.multiarray", "numpy.core.multiarray"):
        try:
            safe.append(getattr(importlib.import_module(mod), "scalar"))
        except (ImportError, AttributeError):
            pass
    safe.extend(np.dtype(k).__class__ for k in ("f4", "f8", "i4", "i8"))
    with torch.serialization.safe_globals(safe):
        state = torch.load(path, map_location="cpu", weights_only=True)
    return {
        "format": "torch",
        "epoch": int(state.get("epoch", 0)),
        "loss": float(state.get("loss", 0.0)),
        "model_state_dict": {k: v.numpy() if hasattr(v, "numpy") else v
                             for k, v in state["model_state_dict"].items()},
        "optimizer_state_dict": state.get("optimizer_state_dict"),
    }


def is_torch_checkpoint(path: str) -> bool:
    """``torch.save`` archives are zip files with a ``data.pkl`` member;
    an ``.npz`` checkpoint has none."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
    return any(n.endswith("data.pkl") for n in names) \
        and not any(n.endswith("manifest.npy") for n in names)


def _pack_identity(W: np.ndarray, target_shape, num_nodes: int,
                   out_dim: int) -> np.ndarray:
    """Logical ``(S, n, out)`` identity weight -> the padded, packed
    ``(S, rows, lanes)`` layout (``rspmm.packed_identity_shape``): row r
    holds nodes ``r*k + lane//sub`` at lanes ``lane % sub < out``."""
    S, rows, lanes = target_shape
    k = packing_factor(out_dim)
    sub = lanes // k
    out = np.zeros(target_shape, dtype=np.float32)
    lane = np.arange(lanes)
    node = np.arange(rows)[:, None] * k + lane // sub     # (rows, lanes)
    col = np.broadcast_to(lane % sub, node.shape)
    valid = (node < num_nodes) & (col < out_dim)
    out[:, valid] = W[:, node[valid], col[valid]]
    return out


def _set(tree: Dict, path: List[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        if p not in node:
            raise KeyError("/".join(path))
        node = node[p]
    leaf = path[-1]
    if leaf not in node:
        raise KeyError("/".join(path))
    cur = np.asarray(node[leaf])
    value = np.asarray(value, dtype=cur.dtype)
    if cur.shape != value.shape:
        raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                         f"checkpoint {value.shape} vs model {cur.shape}")
    node[leaf] = value


def map_state_dict(state_dict: Dict[str, np.ndarray], model: nn.Module
                   ) -> Tuple[Dict, Dict, List[str]]:
    """Map a reference ``model_state_dict`` onto the JAX-layout trees of
    ``model``'s parameters and running statistics. Returns ``(params,
    batch_stats, unmapped)``: the trees, the model's own values where the
    checkpoint has none, and the checkpoint keys without a counterpart.
    A key that maps with the wrong shape raises. A model on a mesh maps
    onto its whole weights (:func:`..parallel.mesh.full_state_dict`)."""
    sd = pmesh.full_state_dict(model)
    params = copy.deepcopy(state_dict_to_params(sd))
    batch_stats = copy.deepcopy(state_dict_to_batch_stats(sd))
    unmapped: List[str] = []

    # the TCNN registers its layers twice (module_dict.conv / fc mirror
    # conv / fc, reference temporal_cnn.py): the duplicates are dropped
    keys = [k for k in state_dict
            if ".module_dict." not in k and k != "im_norm"]

    num_nodes = model.num_nodes
    hidden_dims = tuple(model.hidden_dims)

    for key in keys:
        val = np.asarray(state_dict[key])
        try:
            if key == "gate_weights":
                _set(params, ["gate_weights"], val)
            elif key == "rgcn.relations":
                _set(params, ["rgcn", "relations"], val)
            elif key.startswith("rgcn.layers."):
                m = re.match(r"rgcn\.layers\.(layer_\d+)\.(\w+)$", key)
                layer, pname = m.group(1), m.group(2)
                out_dim = hidden_dims[int(layer.split("_")[1])]
                tree = params["rgcn"][layer]
                if pname == "weight_I":
                    target = "weight_i_packed" \
                        if "weight_i_packed" in tree else "weight_i"
                    S = tree[target].shape[0]
                    logical = val.reshape(S, num_nodes, out_dim)
                    packed = _pack_identity(logical, tree[target].shape,
                                            num_nodes, out_dim)
                    _set(params, ["rgcn", layer, target], packed)
                elif pname == "weight_F":
                    _set(params, ["rgcn", layer, "weight_f"], val)
                elif pname == "weight_I_comp":
                    _set(params, ["rgcn", layer, "comp_i"], val)
                elif pname == "weight_F_comp":
                    # shared bases alias F_comp to I_comp in both
                    # implementations; set only where it is its own
                    if "comp_f" in tree:
                        _set(params, ["rgcn", layer, "comp_f"], val)
                elif pname == "b":
                    _set(params, ["rgcn", layer, "bias"], val)
                else:
                    unmapped.append(key)
            elif key.startswith("module_dict."):
                name, sub = key[len("module_dict."):].split(".", 1)
                if name not in params or not _map_encoder_param(
                        params, batch_stats, name, sub, val):
                    unmapped.append(key)
            else:
                unmapped.append(key)
        except KeyError:
            unmapped.append(key)

    if unmapped:
        logger.warning(
            "torch checkpoint import: %d key(s) had no counterpart and "
            "keep their initialisation (frozen pretrained backbones and "
            "from-scratch encoder deltas are expected here): %s%s",
            len(unmapped), ", ".join(unmapped[:8]),
            " ..." if len(unmapped) > 8 else "")
    return params, batch_stats, unmapped


def _map_encoder_param(params: Dict, batch_stats: Dict, name: str,
                       sub: str, val: np.ndarray) -> bool:
    """Map one ``module_dict.<name>.<sub>`` entry; True when mapped."""
    enc = params[name]

    # MLP: mlp.<3j>.{weight,bias} -> Dense_j (Linear, Dropout, ReLU)
    m = re.match(r"mlp\.(\d+)\.(weight|bias)$", sub)
    if m:
        idx, kind = int(m.group(1)), m.group(2)
        dense = f"Dense_{idx // 3}"
        if idx % 3 or dense not in enc:
            return False
        if kind == "weight":
            _set(params, [name, dense, "kernel"], val.T)
        else:
            _set(params, [name, dense, "bias"], val)
        return True

    # text / image head: pre_fc / fc -> Dense_0 / Dense_1 where the shapes
    # agree (the from-scratch text encoder's head differs: unmapped)
    m = re.match(r"(pre_fc|fc)\.(weight|bias)$", sub)
    if m:
        dense = "Dense_0" if m.group(1) == "pre_fc" else "Dense_1"
        if dense not in enc:
            return False
        leaf = "kernel" if m.group(2) == "weight" else "bias"
        src = val.T if leaf == "kernel" else val
        if np.asarray(enc[dense][leaf]).shape != src.shape:
            return False
        _set(params, [name, dense, leaf], src)
        return True

    # TCNN: conv.<k> Conv1d / BatchNorm1d onto _ConvBNRelu_i
    m = re.match(r"conv\.(\d+)\.(\w+)$", sub)
    if m:
        idx, pname = int(m.group(1)), m.group(2)
        conv_blocks = sorted((k for k in enc if k.startswith("_ConvBNRelu_")),
                             key=lambda s: int(s.split("_")[-1]))
        seq = _tcnn_sequential_map(len(conv_blocks))
        if idx not in seq:
            return False
        block_i, kind = seq[idx]
        block = conv_blocks[block_i]
        if kind == "conv":
            if pname == "weight":   # (out, in, k) -> (k, in, out)
                _set(params, [name, block, "Conv_0", "kernel"],
                     np.transpose(val, (2, 1, 0)))
            elif pname == "bias":
                _set(params, [name, block, "Conv_0", "bias"], val)
            else:
                return False
        else:
            if pname == "weight":
                _set(params, [name, block, "BatchNorm_0", "scale"], val)
            elif pname == "bias":
                _set(params, [name, block, "BatchNorm_0", "bias"], val)
            elif pname == "running_mean":
                _set(batch_stats, [name, block, "BatchNorm_0", "mean"], val)
            elif pname == "running_var":
                _set(batch_stats, [name, block, "BatchNorm_0", "var"], val)
            elif pname != "num_batches_tracked":   # no counterpart
                return False
        return True

    m = re.match(r"fc\.(\d+)\.(weight|bias)$", sub)
    if m:
        idx, kind = int(m.group(1)), m.group(2)
        dense = {0: "Dense_0", 3: "Dense_1"}.get(idx)
        if dense is None or dense not in enc:
            return False
        _set(params, [name, dense, "kernel" if kind == "weight" else "bias"],
             val.T if kind == "weight" else val)
        return True

    return False


def _tcnn_sequential_map(num_blocks: int) -> Dict[int, Tuple[int, str]]:
    """torch Sequential indices -> (conv-block ordinal, 'conv' | 'bn').

    Every reference TCNN stage is Conv1d, BatchNorm1d, ReLU triples with a
    pool module after each stage but the last
    (reference: temporal_cnn.py:26-139); where the pools sit depends on
    the size, so the walk follows the size's stage plan
    (``models/encoders._TCNN_PLANS``)."""
    for size in ("S", "M", "L"):
        stages, _ = _TCNN_PLANS[size]
        if sum(len(convs) for convs, _ in stages) == num_blocks:
            break
    out: Dict[int, Tuple[int, str]] = {}
    idx = block = 0
    for convs, pool in stages:
        for _ in convs:
            out[idx] = (block, "conv")
            out[idx + 1] = (block, "bn")
            idx += 3            # Conv, BN, ReLU
            block += 1
        if pool is not None:
            idx += 1
    return out
