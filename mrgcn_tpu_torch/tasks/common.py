"""Shared run-time assembly: artifact -> model inputs on a device.

Counterpart of :mod:`mrgcn_tpu.tasks.common`. The artifact format, the
feature pipeline (``setup_features``, ``densify``, the tokenizer's pad id)
and the graph structure are the port's own copies of the JAX package's
host modules, under the same relative names. Under a device mesh
(:mod:`..parallel.mesh`) the inputs are this rank's share: the edges and
their plans split over ``data``, the feature rows where they divide.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mrgcn_tpu_torch.data.artifact import Artifact
from mrgcn_tpu_torch.encodings.features import (densify, getDatatypeConfig,
                                                isDatatypeIncluded,
                                                setup_features)
from mrgcn_tpu_torch.encodings.structure import group_by_relation
from mrgcn_tpu_torch.encodings.xsd.string import (ByteTokenizer,
                                                  pad_symbol_for)
from mrgcn_tpu_torch.models.encoders import TCNN_MINIMAL_LENGTH
from mrgcn_tpu_torch.models.mrgcn import module_names
from mrgcn_tpu_torch.models.rgcn import EdgeBlock
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops.placement import build_rows
from mrgcn_tpu_torch.parallel.mesh import (shard_inputs,
                                           shard_restricted_block)

logger = logging.getLogger(__name__)

_TEXT = ("xsd.string", "xsd.anyURI")

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
    # encoder name -> (data, node_idx, rows) on the device
    features: Dict[str, Tuple] = field(default_factory=dict)
    # the same (data, node_idx) as numpy arrays on the host: what
    # mini-batches cut their feature subsets from
    features_host: Dict[str, Tuple] = field(default_factory=dict)
    modules_config: Tuple = ()            # sorted by datatype
    X_width: int = 0
    featureless: bool = True
    text_vocab_size: int = ByteTokenizer.VOCAB_SIZE
    text_pad_id: int = ByteTokenizer.PAD


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


def _layer_shapes(dims, X_width: int, featureless: bool):
    """(in_width, out_width) per planned layer shape; ``None`` marks the
    identity gather."""
    shapes = [(None, dims[0])]
    if not featureless and X_width > 0:
        shapes.append((X_width, dims[0]))
    shapes.extend((dims[i - 1], dims[i]) for i in range(1, len(dims)))
    return shapes


def _feature_tensors(X, modules_config, num_nodes: int, device,
                     text_vocab: int):
    """Encoder name -> (data, node_idx, rows) tensors for every non-empty
    encoding set, the same (data, node_idx) as host arrays, and the text
    vocabulary size they need."""
    flat_sets: List = []
    for datatype, sets in sorted(X[1:], key=lambda e: e[0]):
        flat_sets.extend((datatype, s) for s in sets)
    names = module_names(tuple(modules_config))
    if len(flat_sets) != len(names):
        raise ValueError(f"{len(flat_sets)} encoding sets vs {len(names)} "
                         "modules")
    features: Dict[str, Tuple] = {}
    host: Dict[str, Tuple] = {}
    for name, (datatype, (enc, node_idx, _)) in zip(names, flat_sets):
        if len(enc) == 0:
            continue
        if datatype in _TEXT:
            text_vocab = max(text_vocab, int(np.max(enc)) + 1)
        idx = np.asarray(node_idx)
        host[name] = (np.asarray(enc), idx.astype(np.int32))
        features[name] = tuple(
            torch.as_tensor(a, device=device)
            for a in (*host[name], build_rows(idx, num_nodes)))
    return features, host, text_vocab


def prepare_inputs(artifact: Artifact, config: Dict, featureless: bool,
                   device: torch.device, mesh=None) -> RunInputs:
    """Model inputs on ``device``: the encoders' feature arrays (padded
    once, with their placement maps), and the full-graph edge block with
    its relation-grouped layout and sorted-stream plans. Under ``mesh``
    the plans are built for this rank's share of the edges, and the edges
    and feature rows are split over ``data``
    (:func:`..parallel.mesh.shard_inputs`)."""
    structure = artifact.structure
    n = structure.num_nodes

    X, X_width, modules_config, optimizer_config = setup_features(
        artifact.F, n, featureless, config)
    if X_width <= 0:
        featureless = True
    # stable datatype order, so encoder instance ids match across runs
    modules_config = tuple(sorted(modules_config, key=lambda t: t[0]))

    # pad symbols for token sequences (reference:
    # node_classification.py:61-70)
    pad_symbols: Dict[str, int] = {}
    text_pad_id = ByteTokenizer.PAD
    for datatype in _TEXT:
        if isDatatypeIncluded(config, datatype):
            pad_symbols[datatype] = pad_symbol_for(
                getDatatypeConfig(config, datatype) or {})
            text_pad_id = pad_symbols[datatype]
    # geometries padded to at least the largest TCNN's minimal length, so
    # every convolution stack fits its input
    min_lengths = {"ogc.wktLiteral": max(
        [1] + [TCNN_MINIMAL_LENGTH[args[2]] for datatype, args
               in modules_config if datatype == "ogc.wktLiteral"])}
    X = densify(X, pad_symbols=pad_symbols, min_lengths=min_lengths)
    features, features_host, text_vocab = _feature_tensors(
        X, modules_config, n, device, ByteTokenizer.VOCAB_SIZE)

    task = config.get("task", {}).get("type", "")
    out_final = len(artifact.class_map) \
        if task == "node classification" and artifact.class_map else None
    dims = tuple(hidden_dims_from_config(config, out_final))
    basis = rl.basis_stream_wanted(structure.num_relations, n, dims[0],
                                   int(config["model"]["num_bases"]))
    plans = rl.plans_for_layers(structure.src, structure.dst,
                                structure.rel, structure.norm, n,
                                _layer_shapes(dims, X_width, featureless),
                                identity_basis=basis, device=device,
                                **_shards(mesh))
    edges = _edge_block(structure.src, structure.dst, structure.rel,
                        structure.norm, n, None, device, plans=plans)
    inputs = RunInputs(edges=edges, optimizer_config=optimizer_config,
                     num_nodes=n, num_relations=structure.num_relations,
                     structure=structure, hidden_dims=dims, device=device,
                     identity_basis=basis, features=features,
                     features_host=features_host,
                     modules_config=modules_config, X_width=X_width,
                     featureless=featureless, text_vocab_size=text_vocab,
                     text_pad_id=text_pad_id)
    if mesh is None:
        return inputs
    return shard_inputs(mesh, inputs)


def _shards(mesh) -> Dict:
    """The planner's shard arguments: this rank's share of ``data``."""
    return {} if mesh is None else {"num_shards": mesh.data,
                                    "shard": mesh.data_rank}


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
                           X_width: int = 0, featureless: bool = True,
                           identity_basis: bool = False,
                           group_size: int = 64, min_shrink: float = 0.9,
                           device=None, mesh=None) -> Tuple:
    """Per-layer EdgeBlocks for a full-batch pass whose loss reads only
    ``out_nodes`` (sorted unique global node ids).

    Walks frontiers backwards from the labels: each layer aggregates only
    at the rows the layer above reads (dropped rows would receive zero
    cotangent anyway; per-edge norms are untouched). The input layer keeps
    the global input space and carries rectangular sorted-stream plans
    (identity and, over ``X_width`` features, dense);
    the other restricted layers run the relation-grouped path. When a
    frontier stops shrinking (>= ``min_shrink * num_nodes``) the layers
    below reuse ``full_edges``.

    ``mesh``: the input layer's plans are built for this rank's share of
    the edges, and every restricted block is padded and split over
    ``data`` (:func:`..parallel.mesh.shard_restricted_block`); the reused
    ``full_edges`` are already the rank's share.
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
                    src_l, dst_l, rel_l, norm_l, n,
                    _layer_shapes((first_dim,), X_width, featureless),
                    identity_basis=identity_basis, num_out_nodes=num_out,
                    device=device, **_shards(mesh))
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
    if mesh is not None:
        blocks = [b if b is full_edges else shard_restricted_block(mesh, b)
                  for b in blocks]
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
