"""BERT, RoBERTa, XLM-R and RoBERTa-PreLayerNorm text backbones in
float32 PyTorch.

Counterpart of what the JAX package's ``load_text_backbone`` returns for
a ``config.json`` whose ``model_type`` is ``bert``, ``roberta``,
``xlm-roberta`` or ``roberta-prelayernorm``: transformers'
``FlaxBertModel``, ``FlaxRobertaModel``, ``FlaxXLMRobertaModel`` and
``FlaxRobertaPreLayerNormModel`` (no Pallas kernel there: plain XLA in
float32), read from the same ``config.json`` and ``flax_model.msgpack``
(:mod:`..utils.flax_msgpack`) and frozen. The four share one
architecture:

* embeddings: word, plus position, plus ``token_type_embeddings[0]``
  (flax's default token types are zeros), then LayerNorm with the
  config's ``layer_norm_eps``; BERT numbers positions ``0 .. L-1``,
  RoBERTa, XLM-R and RoBERTa-PreLayerNorm ``cumsum(ids != pad) *
  (ids != pad) + pad``
  (transformers' ``create_position_ids_from_input_ids``), so a pad keeps
  position ``pad`` and 514 positions hold 512 tokens;
* per layer, post-LN: ``attention/self/{query,key,value}`` over
  ``num_attention_heads`` heads with the attention mask applied to the
  keys (:func:`.distilbert.masked_attention`), ``attention/output/dense``
  and ``attention/output/LayerNorm`` of that plus the input;
  ``intermediate/dense`` -> ``hidden_act`` (any of flax's ``ACT2FN``,
  :data:`.distilbert.ACT2FN`) -> ``output/dense``, ``output/LayerNorm``
  of that plus its input;
* with ``is_decoder`` the attention is causal, as flax's is: the causal
  mask and the padding mask combined (a key is seen where both let it
  be), so the first position's output is a function of the first token
  alone; with ``add_cross_attention`` each layer's ``crossattention``
  subtree is in the file and is not run, as flax runs it only when it is
  given encoder states, which the encoder never passes;
* RoBERTa-PreLayerNorm instead normalises before each sublayer and not
  after it: ``attention/LayerNorm`` of the input feeds the attention,
  whose ``attention/output/dense`` is added to the input;
  ``intermediate/LayerNorm`` feeds ``intermediate/dense``, whose
  ``output/dense`` is added to its input; the top ``LayerNorm`` follows
  the last layer;
* the output is the last layer's hidden state ``(N, L, hidden_size)``;
  ``pooler`` is read where the file has it and never run (the encoder
  pools the first position).

Relative position embeddings (``position_embedding_type`` other than
``absolute``) raise ``NotImplementedError`` naming the field: flax's BERT
family reads no such field and runs absolute positions, without the
distance embeddings (a reference fault, ROADMAP Queue 3); so does an
activation flax's ``ACT2FN`` lacks. The model runs in chunks of
sequences within :data:`.distilbert.BUDGET_BYTES`, as DistilBERT does.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from mrgcn_tpu_torch.models import distilbert
from mrgcn_tpu_torch.models.distilbert import (FrozenBackbone, _Dense,
                                               _frozen, _layer_norm,
                                               activation, backbone_type,
                                               check_vocab, masked_attention)

# the model types this module reads, and those that number positions
# from the pad id
BERT_TYPES = ("bert", "roberta", "xlm-roberta", "roberta-prelayernorm")
PAD_POSITIONED = ("roberta", "xlm-roberta", "roberta-prelayernorm")
# the model types whose layers normalise before each sublayer
PRE_LAYER_NORM = ("roberta-prelayernorm",)


def check_positions(config: Dict) -> None:
    """Raise ``NotImplementedError`` where ``config`` asks for relative
    position embeddings."""
    kind = config.get("position_embedding_type", "absolute")
    if kind != "absolute":
        raise NotImplementedError(
            f"position_embedding_type {kind!r}; the port runs 'absolute'")


class _Layer(nn.Module):

    def __init__(self, tree: Dict, n_heads: int, activation, eps: float):
        super().__init__()
        att = tree["attention"]
        for name in ("query", "key", "value"):
            setattr(self, name, _Dense(att["self"][name]))
        self.attention_dense = _Dense(att["output"]["dense"])
        self.attention_norm = _layer_norm(att["output"]["LayerNorm"], eps)
        self.intermediate = _Dense(tree["intermediate"]["dense"])
        self.output_dense = _Dense(tree["output"]["dense"])
        self.output_norm = _layer_norm(tree["output"]["LayerNorm"], eps)
        self.n_heads = n_heads
        self.activation = activation

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        context = masked_attention(self.query(x), self.key(x),
                                   self.value(x), mask, self.n_heads)
        x = self.attention_norm(self.attention_dense(context) + x)
        y = self.output_dense(self.activation(self.intermediate(x)))
        return self.output_norm(y + x)


class _PreLNLayer(nn.Module):

    def __init__(self, tree: Dict, n_heads: int, activation, eps: float):
        super().__init__()
        att = tree["attention"]
        self.attention_norm = _layer_norm(att["LayerNorm"], eps)
        for name in ("query", "key", "value"):
            setattr(self, name, _Dense(att["self"][name]))
        self.attention_dense = _Dense(att["output"]["dense"])
        self.intermediate_norm = _layer_norm(
            tree["intermediate"]["LayerNorm"], eps)
        self.intermediate = _Dense(tree["intermediate"]["dense"])
        self.output_dense = _Dense(tree["output"]["dense"])
        self.n_heads = n_heads
        self.activation = activation

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.attention_norm(x)
        context = masked_attention(self.query(h), self.key(h),
                                   self.value(h), mask, self.n_heads)
        x = self.attention_dense(context) + x
        h = self.activation(self.intermediate(self.intermediate_norm(x)))
        return self.output_dense(h) + x


class Bert(FrozenBackbone):
    """``FlaxBertModel`` / ``FlaxRobertaModel`` / ``FlaxXLMRobertaModel`` /
    ``FlaxRobertaPreLayerNormModel``'s last hidden state in float32,
    frozen. ``config``: the model's ``config.json``; ``params``: its flax
    parameter tree as numpy arrays (``embeddings/word_embeddings/embedding``,
    ``encoder/layer/<i>/attention/self/query/kernel``, ...), or a head
    model's with that tree under ``bert`` / ``roberta`` /
    ``roberta_prelayernorm``."""

    def __init__(self, config: Dict, params: Dict):
        super().__init__()
        self.model_type = backbone_type(config, BERT_TYPES)
        check_positions(config)
        act = activation(config, "hidden_act", "gelu")
        self.causal = bool(config.get("is_decoder", False))
        if "embeddings" not in params:        # saved from a head model
            params = next(params[k] for k in (
                "bert", "roberta", "xlm-roberta", "roberta_prelayernorm")
                if k in params)
        self.dim = int(config["hidden_size"])
        self.n_heads = int(config["num_attention_heads"])
        self.hidden_dim = int(config["intermediate_size"])
        self.pad_id = int(config.get("pad_token_id") or 0)
        if self.model_type in PAD_POSITIONED:
            self.first_position = self.pad_id + 1
        eps = float(config.get("layer_norm_eps", 1e-12))
        emb = params["embeddings"]
        self.word_embeddings = _frozen(emb["word_embeddings"]["embedding"])
        self.position_embeddings = _frozen(
            emb["position_embeddings"]["embedding"])
        self.token_type_embedding = _frozen(
            emb["token_type_embeddings"]["embedding"][0])
        self.LayerNorm = _layer_norm(emb["LayerNorm"], eps)
        # each layer's crossattention subtree (add_cross_attention) is
        # read with the file and left unused
        layers = params["encoder"]["layer"]
        layer = _Layer
        if self.model_type in PRE_LAYER_NORM:
            layer = _PreLNLayer
            self.final_norm = _layer_norm(params["LayerNorm"], eps)
        self.layers = nn.ModuleList(
            layer(layers[str(i)], self.n_heads, act, eps)
            for i in range(int(config["num_hidden_layers"])))
        pooler = params.get("pooler", {}).get("dense")
        if pooler is not None:
            self.pooler = _Dense(pooler)
        check_vocab(self.word_embeddings, config, self.dim)

    def chunk_rows(self, L: int) -> int:
        """As :meth:`FrozenBackbone.chunk_rows`; a causal model's scores
        take the ``(L, L)`` mask beside them."""
        if not self.causal:
            return super().chunk_rows(L)
        per_row = 4 * L * max(self.hidden_dim, (self.n_heads + 1) * L,
                              self.dim)
        return max(1, distilbert.BUDGET_BYTES // per_row)

    def position_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """``(n, L)`` positions: ``0 .. L-1`` (BERT), or
        ``cumsum(ids != pad) * (ids != pad) + pad`` (``PAD_POSITIONED``)."""
        if self.model_type not in PAD_POSITIONED:
            return torch.arange(ids.shape[1], device=ids.device)[None]
        real = (ids != self.pad_id).long()
        return torch.cumsum(real, dim=1) * real + self.pad_id

    def _encode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = F.embedding(ids, self.word_embeddings) \
            + self.token_type_embedding \
            + F.embedding(self.position_ids(ids), self.position_embeddings)
        x = self.LayerNorm(x)
        if self.causal:
            L = ids.shape[1]
            mask = mask[:, None, :] * torch.ones(
                L, L, dtype=mask.dtype, device=mask.device).tril()
        for layer in self.layers:
            x = layer(x, mask)
        if self.model_type in PRE_LAYER_NORM:
            x = self.final_norm(x)
        return x
