"""MR-GCN model: gated modality encoders fused with the R-GCN.

Counterpart of :mod:`mrgcn_tpu.models.mrgcn`. Each encoding set gets an
encoder named as the reference names it (``xsd_numeric_0``,
``xsd_gYear_0``, ``xsd_string_0``, ...), held as a direct attribute so
its parameters live under that name, beside the ``gate_weights`` vector
(one gate per encoder, initialised to 0.1) and the ``rgcn``. The gated
encoder outputs are placed into a dense ``(num_rows, X_width)`` feature
matrix, which the R-GCN's input layer takes beside its identity weight.

Encoders: the MLPs of numeric, boolean and temporal literals, the
temporal CNN of WKT geometries (``TCNN``, size S / M / L as the features'
lengths pick it), and for strings and images either a frozen pretrained
backbone with a trainable head (:mod:`.pretrained`: DistilBERT, where the
string feature names a model whose ``config.json`` and
``flax_model.msgpack`` are on disk; MobileNetV2, where the image feature
names a model and a torchvision checkpoint is found through
``MRGCN_VISION_WEIGHTS`` or the torch.hub cache) or, as in the JAX
package where there is none, the from-scratch ``TextEncoder`` /
``ImageCNN``. The BatchNorm running statistics of the trained encoders are
buffers of the model, so ``state_dict()`` carries them; a frozen backbone
is in neither ``state_dict()`` nor ``parameters()``.

Under a device mesh (``mesh``, set by :func:`..parallel.mesh.shard_params`)
an encoder whose feature rows are split over ``data`` runs on this rank's
block of them (:func:`..models.encoders.row_shard`) and its output is
all-gathered before placement, so every rank holds the same node matrix.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mrgcn_tpu_torch.models import mobilenet, pretrained
from mrgcn_tpu_torch.models.encoders import (MLP, TCNN, ImageCNN, RowShard,
                                             TextEncoder, row_shard)
from mrgcn_tpu_torch.models.rgcn import RGCN
from mrgcn_tpu_torch.ops.placement import place_rows, place_rows_pre
from mrgcn_tpu_torch.parallel import collectives as coll
from mrgcn_tpu_torch.parallel import mesh as pmesh

# datatypes handled per encoder family (reference: mrgcn.py:63-124)
_MLP1 = ("xsd.boolean", "xsd.numeric")
_MLP2 = ("xsd.date", "xsd.dateTime", "xsd.gYear")
_TEXT = ("xsd.string", "xsd.anyURI")


def module_names(modules_config) -> Tuple[str, ...]:
    """Stable encoder instance names, one per encoding set, with
    per-family counters (reference: mrgcn.py:56-134)."""
    counters = {"num": 0, "temp": 0, "llm": 0, "img": 0, "geo": 0}
    names = []
    for datatype, _ in modules_config:
        if datatype in _MLP1:
            key = "num"
        elif datatype in _MLP2:
            key = "temp"
        elif datatype in _TEXT:
            key = "llm"
        elif datatype == "blob.image":
            key = "img"
        elif datatype == "ogc.wktLiteral":
            key = "geo"
        else:
            raise ValueError(f"Datatype not supported: {datatype}")
        names.append(f"{datatype.replace('.', '_')}_{counters[key]}")
        counters[key] += 1
    return tuple(names)


def modality_output_dim(modules_config) -> int:
    """Width of the placed feature matrix: the sum of the encoders'
    embedding widths."""
    dims = []
    for datatype, args in modules_config:
        if datatype in _MLP1 + _MLP2 + _TEXT or datatype == "ogc.wktLiteral":
            dims.append(args[1])
        elif datatype == "blob.image":
            dims.append(args[2])
    return sum(dims)


class MRGCN(nn.Module):
    """Gated multimodal encoders + R-GCN.

    ``modules_config``: ``(datatype, args)`` pairs in the JAX package's
    contract (numeric/temporal ``(feature_size, embedding_dim, dropout)``,
    string ``(model_config, embedding_dim, dropout)``, WKT
    ``(feature_size, embedding_dim, size, dropout)``, image
    ``(model_config, transform_config, embedding_dim, dropout)``).
    ``forward`` takes
    ``features``: encoder name -> ``(data, node_idx, rows)`` tensors, as
    :func:`..tasks.common.prepare_inputs` builds them. ``text_attn_impl``
    picks the from-scratch text encoder's attention path (a checkpoint's
    restore passes the reconciled one); None reads ``MRGCN_TEXT_ATTN``
    (default ``auto``).
    """

    def __init__(self, hidden_dims: Sequence[int], modules_config,
                 num_relations: int, num_nodes: int,
                 generator: torch.Generator, num_bases: int = 0,
                 p_dropout: float = 0.0, featureless: bool = True,
                 use_bias: bool = False, text_vocab_size: int = 259,
                 text_pad_id: int = 256,
                 skip_encoders: Tuple[str, ...] = (),
                 link_prediction: bool = False,
                 text_attn_impl: Optional[str] = None):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.modules_config = tuple(modules_config)
        self.num_nodes = num_nodes
        self.featureless = featureless
        self.skip_encoders = tuple(skip_encoders)
        self.mesh = None
        self.names = module_names(self.modules_config)
        self.encoder_dims: Dict[str, int] = {}
        for name, (datatype, args) in zip(self.names, self.modules_config):
            if datatype in _MLP1 + _MLP2:
                feature_size, dim_out, dropout = args
                encoder = MLP(feature_size, dim_out, generator,
                              num_layers=1 if datatype in _MLP1 else 2,
                              p_dropout=dropout)
            elif datatype in _TEXT:
                model_cfg, dim_out, dropout = args
                backbone = pretrained.load_text_backbone(model_cfg) \
                    if model_cfg else None
                if backbone is not None:
                    encoder = pretrained.PretrainedTextEncoder(
                        backbone, dim_out, generator, p_dropout=dropout,
                        pad_id=text_pad_id)
                else:
                    encoder = TextEncoder(
                        dim_out, generator, vocab_size=text_vocab_size,
                        pad_id=text_pad_id, p_dropout=dropout,
                        attn_impl=text_attn_impl
                        or os.environ.get("MRGCN_TEXT_ATTN", "auto"))
            elif datatype == "ogc.wktLiteral":
                feature_size, dim_out, size, dropout = args
                encoder = TCNN(feature_size, dim_out, generator, size=size,
                               p_dropout=dropout)
            elif datatype == "blob.image":
                model_cfg, transform, dim_out, dropout = args
                checkpoint = mobilenet.find_local_checkpoint() \
                    if model_cfg else None
                if checkpoint is not None:
                    encoder = pretrained.PretrainedImageEncoder(
                        mobilenet.load_image_backbone(checkpoint), dim_out,
                        generator, p_dropout=dropout)
                else:
                    # one channel a letter of the image mode, as the image
                    # vectorizer counts them ("RGB": 3, "L": 1)
                    encoder = ImageCNN(
                        dim_out, generator, p_dropout=dropout,
                        in_channels=len(transform.get("mode", "RGB")))
            else:
                raise ValueError(f"Datatype not supported: {datatype}")
            setattr(self, name, encoder)
            self.encoder_dims[name] = dim_out
        self.modality_dim = modality_output_dim(self.modules_config)

        # one gate per encoder, starting at 0.1, heavily damping every
        # encoder's signal (reference: mrgcn.py:150-156)
        self.gate_weights = nn.Parameter(
            torch.full((len(self.modules_config),), 0.1)) \
            if self.modules_config else None

        self.rgcn = RGCN(hidden_dims=hidden_dims,
                         num_relations=num_relations, num_nodes=num_nodes,
                         generator=generator, num_bases=num_bases,
                         p_dropout=p_dropout, featureless=featureless,
                         use_bias=use_bias,
                         in_dim=None if featureless else self.modality_dim,
                         link_prediction=link_prediction)

    @staticmethod
    def _prepare(datatype: str, args, data: torch.Tensor) -> torch.Tensor:
        """Per-modality casting (reference: mrgcn.py:286-292). Images stay
        ``(N, C, H, W)`` and are normalized by the transform's ``mean`` and
        ``std`` (scaled to 0-255) only when the config gives both, as the
        reference builds its normalizer (reference: mrgcn.py:107-111); WKT
        geometries stay ``(N, C, L)``."""
        if datatype in _TEXT:
            return data.long()
        x = data.float()
        if datatype == "blob.image":
            transform = args[1]
            if "mean" in transform and "std" in transform:
                mean, std = (torch.tensor(transform[key], dtype=torch.float32,
                                          device=x.device) * 255.0
                             for key in ("mean", "std"))
                x = (x - mean[None, :, None, None]) / std[None, :, None, None]
        return x

    def compute_modality_embeddings(self, features: Dict, num_rows: int,
                                    train: bool = False) -> torch.Tensor:
        """Encode every modality, scale it by its gate and place it into
        the dense ``(num_rows, modality_dim)`` matrix (reference:
        mrgcn.py:250-305). An absent modality, or one in
        ``skip_encoders``, contributes zeros and runs nothing."""
        cols = []
        device = next(self.parameters()).device
        for i, (name, (datatype, args)) in enumerate(
                zip(self.names, self.modules_config)):
            entry = features.get(name)
            if entry is None or entry[0].shape[0] == 0 \
                    or name in self.skip_encoders:
                cols.append(torch.zeros(num_rows, self.encoder_dims[name],
                                        device=device))
                continue
            data, node_idx, *pre = entry
            out = self._encode(name, self._prepare(datatype, args, data),
                               node_idx.shape[0], train)
            out = (out * self.gate_weights[i]).float()
            if pre:
                cols.append(place_rows_pre(out, node_idx, pre[0]))
            else:
                cols.append(place_rows(out, node_idx, num_rows))
        if not cols:
            return torch.zeros(num_rows, self.modality_dim, device=device)
        return torch.cat(cols, dim=1)

    def _encode(self, name: str, x: torch.Tensor, num_rows: int,
                train: bool) -> torch.Tensor:
        """Encoder ``name`` over its rows ``x``; where ``x`` holds this
        rank's block of the ``num_rows`` rows
        (:func:`..parallel.mesh.shard_features`), over the block, gathered
        to every row."""
        encoder = getattr(self, name)
        if self.mesh is None or not pmesh.rows_split(self.mesh, num_rows):
            return encoder(x, train=train)
        group = self.mesh.data_group
        start = self.mesh.data_rank * x.shape[0]
        with row_shard(RowShard(group, start, num_rows)):
            out = encoder(x, train=train)
        return coll.all_gather_rows(out, group)

    def forward(self, edges, features: Optional[Dict] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        X = None
        if not self.featureless:
            first = edges[0] if isinstance(edges, (tuple, list)) else edges
            num_rows = first.num_in if first.num_in is not None \
                else self.num_nodes
            X = self.compute_modality_embeddings(features or {}, num_rows,
                                                 train)
        return self.rgcn(X, edges, train=train, generator=generator)
