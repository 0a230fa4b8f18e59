"""MR-GCN model: gated modality encoders fused with the R-GCN.

Counterpart of :mod:`mrgcn_tpu.models.mrgcn`. Each encoding set gets an
encoder named as the reference names it (``xsd_numeric_0``,
``xsd_gYear_0``, ``xsd_string_0``, ...), held as a direct attribute so
its parameters live under that name, beside the ``gate_weights`` vector
(one gate per encoder, initialised to 0.1) and the ``rgcn``. The gated
encoder outputs are placed into a dense ``(num_rows, X_width)`` feature
matrix, which the R-GCN's input layer takes beside its identity weight.

Ported encoders: the MLPs of numeric, boolean and temporal literals and
the from-scratch text encoder. Image and WKT encoders and pretrained
backbones raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mrgcn_tpu_torch.models.encoders import MLP, TextEncoder
from mrgcn_tpu_torch.models.rgcn import RGCN
from mrgcn_tpu_torch.ops.placement import place_rows, place_rows_pre

TODO_ENCODERS = "ROADMAP Queue 1, item 3 (image and WKT encoders, " \
    "pretrained backbones)"

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


def _hub_model_name(hub_spec) -> Optional[str]:
    """The model name of a torch.hub-style spec: its last positional
    entry (``mrgcn_tpu.models.pretrained.hub_model_name``)."""
    if not hub_spec:
        return None
    return next((s for s in reversed(hub_spec)
                 if isinstance(s, str) and "=" not in s), None)


def _backbone_cached(hub_spec) -> bool:
    """Whether a pretrained language model for ``hub_spec`` is in the
    local HuggingFace cache: where it is, the JAX package runs it frozen;
    where it is not, both packages train the from-scratch text encoder."""
    name = _hub_model_name(hub_spec)
    if name is None:
        return False
    from mrgcn_tpu.utils.hf import force_hf_offline
    force_hf_offline()
    try:
        from transformers import AutoConfig
        AutoConfig.from_pretrained(name, local_files_only=True)
    except Exception:    # not installed, or not cached
        return False
    return True


class MRGCN(nn.Module):
    """Gated multimodal encoders + R-GCN.

    ``modules_config``: ``(datatype, args)`` pairs in the JAX package's
    contract (numeric/temporal ``(feature_size, embedding_dim, dropout)``,
    string ``(model_config, embedding_dim, dropout)``). ``forward`` takes
    ``features``: encoder name -> ``(data, node_idx, rows)`` tensors, as
    :func:`..tasks.common.prepare_inputs` builds them.
    """

    def __init__(self, hidden_dims: Sequence[int], modules_config,
                 num_relations: int, num_nodes: int,
                 generator: torch.Generator, num_bases: int = 0,
                 p_dropout: float = 0.0, featureless: bool = True,
                 use_bias: bool = False, text_vocab_size: int = 259,
                 text_pad_id: int = 256,
                 skip_encoders: Tuple[str, ...] = ()):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.modules_config = tuple(modules_config)
        self.num_nodes = num_nodes
        self.featureless = featureless
        self.skip_encoders = tuple(skip_encoders)
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
                if model_cfg and _backbone_cached(model_cfg):
                    raise NotImplementedError(
                        f"pretrained text backbone {model_cfg}: "
                        f"{TODO_ENCODERS}")
                # the JAX package's attention override; only its default
                # path is ported, the others raise
                encoder = TextEncoder(
                    dim_out, generator, vocab_size=text_vocab_size,
                    pad_id=text_pad_id, p_dropout=dropout,
                    attn_impl=os.environ.get("MRGCN_TEXT_ATTN", "auto"))
            else:
                raise NotImplementedError(
                    f"{datatype} encoder: {TODO_ENCODERS}")
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
                         in_dim=None if featureless else self.modality_dim)

    @staticmethod
    def _prepare(datatype: str, data: torch.Tensor) -> torch.Tensor:
        """Per-modality casting (reference: mrgcn.py:286-292)."""
        if datatype in _TEXT:
            return data.long()
        return data.float()

    def compute_modality_embeddings(self, features: Dict, num_rows: int,
                                    train: bool = False) -> torch.Tensor:
        """Encode every modality, scale it by its gate and place it into
        the dense ``(num_rows, modality_dim)`` matrix (reference:
        mrgcn.py:250-305). An absent modality, or one in
        ``skip_encoders``, contributes zeros and runs nothing."""
        cols = []
        device = next(self.parameters()).device
        for i, (name, (datatype, _)) in enumerate(
                zip(self.names, self.modules_config)):
            entry = features.get(name)
            if entry is None or entry[0].shape[0] == 0 \
                    or name in self.skip_encoders:
                cols.append(torch.zeros(num_rows, self.encoder_dims[name],
                                        device=device))
                continue
            data, node_idx, *pre = entry
            out = getattr(self, name)(self._prepare(datatype, data),
                                      train=train)
            out = (out * self.gate_weights[i]).float()
            if pre:
                cols.append(place_rows_pre(out, node_idx, pre[0]))
            else:
                cols.append(place_rows(out, node_idx, num_rows))
        if not cols:
            return torch.zeros(num_rows, self.modality_dim, device=device)
        return torch.cat(cols, dim=1)

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
