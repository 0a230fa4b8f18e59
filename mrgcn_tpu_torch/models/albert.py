"""ALBERT text backbone in float32 PyTorch.

Counterpart of what the JAX package's ``load_text_backbone`` returns for
a ``config.json`` whose ``model_type`` is ``albert``: transformers'
``FlaxAlbertModel`` (plain XLA in float32), read from the same
``config.json`` and ``flax_model.msgpack`` (:mod:`..utils.flax_msgpack`)
by flax's names, and frozen:

* embeddings at ``embedding_size``: word, plus position ``0 .. L-1``,
  plus ``token_type_embeddings[0]``, then LayerNorm with the config's
  ``layer_norm_eps``; then ``encoder/embedding_hidden_mapping_in`` to
  ``hidden_size``;
* ``num_hidden_layers`` layers that share parameters by group: layer
  ``i`` runs group ``int(i / (num_hidden_layers / num_hidden_groups))``
  (flax's own float division), and a group runs its ``inner_group_num``
  layers ``albert_layer_groups/<g>/albert_layers/<j>`` in order;
* a layer is post-LN: ``attention/{query,key,value}`` over
  ``num_attention_heads`` heads, the keys masked
  (:func:`.distilbert.masked_attention`), ``attention/dense`` and
  ``attention/LayerNorm`` of that plus the input; ``ffn`` ->
  ``hidden_act`` (``gelu_new`` by default) -> ``ffn_output``, and
  ``full_layer_layer_norm`` of that plus the attention's output;
* the output is the last layer's hidden state ``(N, L, hidden_size)``;
  ``pooler`` is read where the file has it and never run.

The model runs in chunks of sequences within
:data:`.distilbert.BUDGET_BYTES`, sized by the larger of the scores and
the ``(chunk, L, intermediate_size)`` feed-forward activations (16,384
wide at xxlarge).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from mrgcn_tpu_torch.models.bert import HIDDEN_ACTS, check_encoder_config
from mrgcn_tpu_torch.models.distilbert import (FrozenBackbone, _Dense,
                                               _frozen, _layer_norm,
                                               backbone_type, check_vocab,
                                               masked_attention)


class _Layer(nn.Module):

    def __init__(self, tree: Dict, n_heads: int, activation, eps: float):
        super().__init__()
        att = tree["attention"]
        for name in ("query", "key", "value", "dense"):
            setattr(self, name, _Dense(att[name]))
        self.attention_norm = _layer_norm(att["LayerNorm"], eps)
        self.ffn = _Dense(tree["ffn"])
        self.ffn_output = _Dense(tree["ffn_output"])
        self.full_layer_layer_norm = _layer_norm(
            tree["full_layer_layer_norm"], eps)
        self.n_heads = n_heads
        self.activation = activation

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        context = masked_attention(self.query(x), self.key(x),
                                   self.value(x), mask, self.n_heads)
        x = self.attention_norm(self.dense(context) + x)
        y = self.ffn_output(self.activation(self.ffn(x)))
        return self.full_layer_layer_norm(y + x)


class Albert(FrozenBackbone):
    """``FlaxAlbertModel``'s last hidden state in float32, frozen.
    ``config``: the model's ``config.json``; ``params``: its flax
    parameter tree as numpy arrays (``embeddings/...``,
    ``encoder/embedding_hidden_mapping_in``,
    ``encoder/albert_layer_groups/<g>/albert_layers/<j>/...``), or a head
    model's with that tree under ``albert``."""

    def __init__(self, config: Dict, params: Dict):
        super().__init__()
        self.model_type = backbone_type(config, ("albert",))
        check_encoder_config(config)
        if "embeddings" not in params:        # saved from a head model
            params = params["albert"]
        self.dim = int(config["hidden_size"])
        self.n_heads = int(config["num_attention_heads"])
        self.hidden_dim = int(config["intermediate_size"])
        self.pad_id = int(config.get("pad_token_id") or 0)
        eps = float(config.get("layer_norm_eps", 1e-12))
        emb = params["embeddings"]
        self.word_embeddings = _frozen(emb["word_embeddings"]["embedding"])
        self.position_embeddings = _frozen(
            emb["position_embeddings"]["embedding"])
        self.token_type_embedding = _frozen(
            emb["token_type_embeddings"]["embedding"][0])
        self.LayerNorm = _layer_norm(emb["LayerNorm"], eps)
        encoder = params["encoder"]
        self.embedding_hidden_mapping_in = _Dense(
            encoder["embedding_hidden_mapping_in"])
        act = HIDDEN_ACTS[config.get("hidden_act", "gelu_new")]
        n_layers = int(config["num_hidden_layers"])
        n_groups = int(config.get("num_hidden_groups", 1))
        inner = int(config.get("inner_group_num", 1))
        groups = encoder["albert_layer_groups"]
        self.groups = nn.ModuleList(
            nn.ModuleList(_Layer(groups[str(g)]["albert_layers"][str(j)],
                                 self.n_heads, act, eps)
                          for j in range(inner))
            for g in range(n_groups))
        self.group_of_layer = [int(i / (n_layers / n_groups))
                               for i in range(n_layers)]
        pooler = params.get("pooler")
        if pooler is not None:
            self.pooler = _Dense(pooler)
        check_vocab(self.word_embeddings, config,
                    int(config.get("embedding_size", 128)))

    def _encode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        x = F.embedding(ids, self.word_embeddings) \
            + self.token_type_embedding + self.position_embeddings[:L][None]
        x = self.embedding_hidden_mapping_in(self.LayerNorm(x))
        for g in self.group_of_layer:
            for layer in self.groups[g]:
                x = layer(x, mask)
        return x
