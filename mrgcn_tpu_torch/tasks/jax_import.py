"""Weight bridge between the JAX package and the port.

The JAX package's parameters are a nested dict (``params["rgcn"]
["layer_0"]["comp_i"]``, ``params["xsd_string_0"]["_TextBlock_0"]["qkv"]
["kernel"]``, ``params["gate_weights"]``); the port keeps the same names
and layouts as module paths (``rgcn.layer_0.comp_i``,
``xsd_string_0._TextBlock_0.qkv.kernel``, ``gate_weights``). The bridge
maps one onto the other by path, so both packages can run the same
weights: the R-GCN, every encoder and the gates. Arrays travel as numpy;
nothing here imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn


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


def state_dict_to_params(state_dict: Mapping) -> Dict:
    """Flat state dict -> nested dict of numpy arrays (the JAX layout)."""
    root: Dict = {}
    for path, tensor in state_dict.items():
        *parents, leaf = path.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = tensor.detach().cpu().numpy()
    return root


def load_jax_params(model: nn.Module, params: Mapping) -> None:
    """Copy JAX params into ``model`` in place; names and shapes must match
    exactly (``load_state_dict(strict=True)``)."""
    model.load_state_dict(params_to_state_dict(params), strict=True)
