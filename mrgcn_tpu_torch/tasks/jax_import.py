"""Weight bridge between the JAX package and the port.

The JAX package's parameters are a nested dict (``params["rgcn"]
["layer_0"]["comp_i"]``, ``params["xsd_string_0"]["_TextBlock_0"]["qkv"]
["kernel"]``, ``params["gate_weights"]``); the port keeps the same names
and layouts as module paths (``rgcn.layer_0.comp_i``,
``xsd_string_0._TextBlock_0.qkv.kernel``, ``gate_weights``). The bridge
maps one onto the other by path, so both packages can run the same
weights: the R-GCN (with the DistMult ``rgcn.relations`` of a link
predictor, the unpacked ``weight_i`` of a wide input layer and the basis
coefficients ``comp_i``/``comp_f``), every encoder and the gates. The
BatchNorm running statistics of the convolutional encoders, flax's
``batch_stats`` collection (``batch_stats[...]["BatchNorm_0"]["mean"]``,
``["var"]``), are buffers at the same path (``..._ConvBNRelu_0.
BatchNorm_0.mean``); the bridge carries them both ways beside the
parameters. Arrays travel as numpy; nothing here imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mrgcn_tpu_torch.parallel import mesh as pmesh


def params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays -> flat ``{"a.b.c": tensor}`` state dict."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            path = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, path)
            else:
                flat[path] = torch.from_numpy(np.array(val))

    walk(params, "")
    return flat


def is_batch_stat(path: str) -> bool:
    """Whether a state-dict entry is a BatchNorm running statistic (a
    ``batch_stats`` leaf in the JAX package), not a parameter."""
    *parents, leaf = path.split(".")
    return leaf in ("mean", "var") and bool(parents) \
        and parents[-1].startswith("BatchNorm_")


def _nest(entries) -> Dict:
    root: Dict = {}
    for path, tensor in entries:
        *parents, leaf = path.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = tensor.detach().cpu().numpy()
    return root


def state_dict_to_params(state_dict: Mapping) -> Dict:
    """Flat state dict -> nested dict of numpy arrays (the JAX layout) of
    the parameters; the BatchNorm running statistics are left to
    :func:`state_dict_to_batch_stats`."""
    return _nest((path, t) for path, t in state_dict.items()
                 if not is_batch_stat(path))


def state_dict_to_batch_stats(state_dict: Mapping) -> Dict:
    """The BatchNorm running statistics of a flat state dict as the JAX
    package's ``batch_stats`` tree (empty for a model without BatchNorm)."""
    return _nest((path, t) for path, t in state_dict.items()
                 if is_batch_stat(path))


def load_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> None:
    """Copy JAX params, and the ``batch_stats`` of a model with BatchNorm,
    into ``model`` in place; names and shapes must match exactly
    (``load_state_dict(strict=True)``). A model on a device mesh takes the
    whole tree and keeps, for each basis slice, its rank's slice
    (:func:`..parallel.mesh.share_of`)."""
    sd = {**params_to_state_dict(params),
          **params_to_state_dict(batch_stats or {})}
    for name, p in model.named_parameters():
        if name in sd and tuple(sd[name].shape) == pmesh.full_shape(p):
            sd[name] = pmesh.share_of(p, sd[name])
    model.load_state_dict(sd, strict=True)
