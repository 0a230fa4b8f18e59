"""Shared run-time assembly: artifact -> model inputs on a device.

Counterpart of :mod:`mrgcn_tpu.tasks.common` for the featureless path. The
artifact format, the feature setup and the graph structure are the JAX
package's own host modules, imported as they are (none of them imports
JAX).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mrgcn_tpu.data.artifact import Artifact
from mrgcn_tpu.encodings.features import setup_features
from mrgcn_tpu.encodings.structure import group_by_relation
from mrgcn_tpu_torch.models.rgcn import TODO_ENCODERS, EdgeBlock
from mrgcn_tpu_torch.ops import relational as rl

logger = logging.getLogger(__name__)


@dataclass
class RunInputs:
    edges: EdgeBlock
    optimizer_config: Dict
    num_nodes: int
    num_relations: int
    structure: object                     # GraphStructure
    hidden_dims: Tuple[int, ...]
    device: torch.device
    identity_basis: bool = False          # featureless plan kind decision


def _edge_block(src, dst, rel, norm, num_out: int, num_in: Optional[int],
                device, plans=None, group_size: int = 128) -> EdgeBlock:
    grouping = group_by_relation(src, dst, rel, norm, num_out,
                                 group_size=group_size)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return EdgeBlock(src=t(src), dst=t(dst), rel=t(rel), norm=t(norm),
                     num_out=num_out, num_in=num_in, plans=plans,
                     grp_src=t(grouping.src), grp_dst=t(grouping.dst),
                     grp_norm=t(grouping.norm),
                     group_rel=t(grouping.group_rel),
                     group_size=grouping.group_size)


def prepare_inputs(artifact: Artifact, config: Dict, featureless: bool,
                   device: torch.device) -> RunInputs:
    """Featureless model inputs: the full-graph edge block with its
    relation-grouped layout and sorted-stream plans, on ``device``."""
    structure = artifact.structure
    n = structure.num_nodes

    _, X_width, modules_config, optimizer_config = setup_features(
        artifact.F, n, featureless, config)
    if X_width > 0 or modules_config:
        raise NotImplementedError(f"node features: {TODO_ENCODERS}")

    task = config.get("task", {}).get("type", "")
    out_final = len(artifact.class_map) \
        if task == "node classification" and artifact.class_map else None
    dims = tuple(hidden_dims_from_config(config, out_final))
    basis = rl.basis_stream_wanted(structure.num_relations, n, dims[0],
                                   int(config["model"]["num_bases"]))
    shapes = [(None, dims[0])]                        # identity gather
    shapes.extend((dims[i - 1], dims[i]) for i in range(1, len(dims)))
    plans = rl.plans_for_layers(structure.src, structure.dst,
                                structure.rel, structure.norm, n, shapes,
                                identity_basis=basis, device=device)
    edges = _edge_block(structure.src, structure.dst, structure.rel,
                        structure.norm, n, None, device, plans=plans)
    return RunInputs(edges=edges, optimizer_config=optimizer_config,
                     num_nodes=n, num_relations=structure.num_relations,
                     structure=structure, hidden_dims=dims, device=device,
                     identity_basis=basis)


def _filter_remap(src, dst, rel, norm, out_nodes):
    """Keep edges whose output node is in ``out_nodes`` (sorted unique);
    remap src to positions in ``out_nodes``. dst stays as given."""
    keep_pos = np.searchsorted(out_nodes, src)
    keep_pos = np.minimum(keep_pos, len(out_nodes) - 1)
    keep = out_nodes[keep_pos] == src
    return (keep_pos[keep].astype(np.int32), dst[keep].astype(np.int32),
            rel[keep].astype(np.int32), norm[keep].astype(np.float32))


def restricted_layer_edges(structure, out_nodes: np.ndarray,
                           num_layers: int, full_edges: EdgeBlock,
                           first_dim: Optional[int] = None,
                           identity_basis: bool = False,
                           group_size: int = 64, min_shrink: float = 0.9,
                           device=None) -> Tuple:
    """Per-layer EdgeBlocks for a full-batch pass whose loss reads only
    ``out_nodes`` (sorted unique global node ids).

    Walks frontiers backwards from the labels: each layer aggregates only
    at the rows the layer above reads (dropped rows would receive zero
    cotangent anyway; per-edge norms are untouched). The input layer keeps
    the global input space and carries rectangular sorted-stream plans;
    the other restricted layers run the relation-grouped path. When a
    frontier stops shrinking (>= ``min_shrink * num_nodes``) the layers
    below reuse ``full_edges``.
    """
    src = np.asarray(structure.src)
    dst = np.asarray(structure.dst)
    rel = np.asarray(structure.rel)
    norm = np.asarray(structure.norm)
    n = structure.num_nodes
    device = full_edges.src.device if device is None else device

    blocks = [full_edges] * num_layers
    F_next = np.asarray(out_nodes)
    for layer in range(num_layers - 1, -1, -1):
        src_l, dst_l, rel_l, norm_l = _filter_remap(src, dst, rel, norm,
                                                    F_next)
        num_out = int(len(F_next))
        if layer == 0:
            # input layer: dst indexes the global identity table
            plans = None
            if first_dim is not None:
                plans = rl.plans_for_layers(
                    src_l, dst_l, rel_l, norm_l, n, [(None, first_dim)],
                    identity_basis=identity_basis, num_out_nodes=num_out,
                    device=device)
            blocks[0] = _edge_block(src_l, dst_l, rel_l, norm_l, num_out,
                                    None, device, plans=plans,
                                    group_size=group_size)
            break

        F_cur = np.unique(dst_l)
        if len(F_cur) >= min_shrink * n:
            # the frontier covers ~everything: keep global dst and the
            # full layers below
            blocks[layer] = _edge_block(src_l, dst_l, rel_l, norm_l,
                                        num_out, None, device,
                                        group_size=group_size)
            break

        dst_local = np.searchsorted(F_cur, dst_l).astype(np.int32)
        blocks[layer] = _edge_block(src_l, dst_local, rel_l, norm_l,
                                    num_out, int(len(F_cur)), device,
                                    group_size=group_size)
        F_next = F_cur
    return tuple(blocks)


def hidden_dims_from_config(config: Dict, output_dim: Optional[int]
                            ) -> Tuple[int, ...]:
    """Layer widths from ``[[model.layers]]``; the output width is the
    class count for NC and the last configured hidden size for LP."""
    layers = config["model"]["layers"]
    dims = [layer["hidden_nodes"] for layer in layers[:-1]]
    if output_dim is not None:  # node classification
        dims.append(output_dim)
    elif not dims:
        dims = [layers[0]["hidden_nodes"]]
    return tuple(dims)
