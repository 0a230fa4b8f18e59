"""BLOOM text backbone in float32 PyTorch.

Counterpart of what the JAX package's ``load_text_backbone`` returns for
a ``config.json`` whose ``model_type`` is ``bloom``: transformers'
``FlaxBloomModel`` (plain XLA in float32), read from the same
``config.json`` and ``flax_model.msgpack`` (:mod:`..utils.flax_msgpack`)
by flax's names, and frozen:

* the config as transformers' ``BloomConfig`` reads it: the width is
  ``n_embed`` where it is given (bloom-560m's legacy name), else
  ``hidden_size``; ``num_hidden_layers`` / ``num_attention_heads`` take
  the place of ``n_layer`` / ``n_head``; missing fields take
  ``BloomConfig``'s defaults (``BLOOM_DEFAULTS``);
* ``word_embeddings`` then ``word_embeddings_layernorm``: no position
  embeddings;
* ALiBi as flax builds it (``build_alibi_tensor``): per head a slope
  (:func:`alibi_slopes`) times each key's position ``(cumsum(mask) - 1) *
  mask``, added to a bias that is ``finfo(f32).min`` where the causal
  mask or the padding mask hides the key and 0 elsewhere; the scores are
  the query scaled by ``1 / sqrt(head_dim)`` times the keys, plus that
  bias, under an f32 softmax;
* per layer ``h/<i>``: ``input_layernorm``; ``self_attention/
  query_key_value`` (``hidden -> 3 hidden``), whose output is split per
  head into ``(n_head, 3 head_dim)`` and then into q, k and v (q, k and v
  interleaved by head, not three blocks); ``self_attention/dense`` plus
  the residual; ``post_attention_layernorm``; ``mlp/dense_h_to_4h`` ->
  ``BloomGELU`` -> ``mlp/dense_4h_to_h`` plus the residual. The residual
  is the sublayer's input, or with ``apply_residual_connection_post_layernorm``
  the LayerNorm's output. The inner width is always 4 hidden (flax
  ignores ``n_inner``);
* ``ln_f`` after the last layer, at ``layer_norm_epsilon``; the output is
  its last hidden state ``(N, L, hidden)``.

``BloomGELU`` is ``x / 2 (1 + tanh(0.79788456 x (1 + 0.044715 x^2)))``:
``F.gelu(approximate="tanh")`` in one pass, whose constant
``sqrt(2 / pi)`` is the same float32. Flax's slopes for a head count that
is not a power of two call ``jnp.cat``, which does not exist, so the JAX
package's loader catches the error and trains its from-scratch encoder
(BLOOM-176B's 112 heads among them); the port takes the published
slopes there (transformers' PyTorch ``build_alibi_tensor``). Every field
the flax module reads is reproduced; a width the heads do not divide
raises ``ValueError``, as flax's does.

The causal mask lets the first position attend to itself alone, so the
encoder's pooled output (position 0) is a function of the first token.
The model runs in chunks of sequences within
:data:`.distilbert.BUDGET_BYTES`, sized by the larger of the scores and
their bias (``2 n_head L^2`` floats a sequence) and the 4-hidden-wide
feed-forward activations.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrgcn_tpu_torch.models import distilbert
from mrgcn_tpu_torch.models.distilbert import (FrozenBackbone, _Dense,
                                               _frozen, _layer_norm,
                                               backbone_type, check_vocab)

# transformers' BloomConfig defaults of the fields the model reads
BLOOM_DEFAULTS = {"hidden_size": 64, "n_layer": 2, "n_head": 8,
                  "layer_norm_epsilon": 1e-5, "vocab_size": 250880,
                  "apply_residual_connection_post_layernorm": False}


def bloom_sizes(config: Dict) -> Tuple[int, int, int]:
    """``(hidden, layers, heads)`` of a BLOOM ``config.json`` as
    ``BloomConfig`` reads them: ``n_embed`` over ``hidden_size``, and the
    attribute map's ``num_hidden_layers`` / ``num_attention_heads`` (set
    after the named arguments) over ``n_layer`` / ``n_head``."""
    def first(*keys):
        given = [config[k] for k in keys if config.get(k) is not None]
        return int(given[0] if given else BLOOM_DEFAULTS[keys[-1]])
    return (first("n_embed", "hidden_size"),
            first("num_hidden_layers", "n_layer"),
            first("num_attention_heads", "n_head"))


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """The ALiBi slope of each head, float32: ``base ** (1 .. p)`` for the
    largest power of two ``p <= n_heads``, ``base = 2 ** -(2 ** -(log2 p
    - 3))``, then, where ``p < n_heads``, the odd powers ``1, 3, ...`` of
    the base for ``2 p``, as many as the remaining heads (transformers'
    ``build_alibi_tensor``; flax's for a power of two)."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = torch.tensor(2 ** (-(2 ** -(math.log2(closest) - 3))),
                        dtype=torch.float32)
    slopes = torch.pow(base, torch.arange(1, 1 + closest,
                                          dtype=torch.float32))
    if closest != n_heads:
        extra = torch.tensor(2 ** (-(2 ** -(math.log2(2 * closest) - 3))),
                             dtype=torch.float32)
        remaining = min(closest, n_heads - closest)
        slopes = torch.cat([slopes, torch.pow(extra, torch.arange(
            1, 1 + 2 * remaining, 2, dtype=torch.float32))])
    return slopes


def attention_bias(mask: torch.Tensor, slopes: torch.Tensor
                   ) -> torch.Tensor:
    """``(n, heads, L, L)`` f32: ``finfo.min`` where the causal mask or
    ``mask`` ``(n, L)`` (1 at real tokens) hides the key, else 0, plus
    each head's slope times the key's position ``(cumsum(mask) - 1) *
    mask``."""
    L = mask.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool, device=mask.device).tril()
    seen = causal[None] & (mask[:, None, :] > 0)
    hidden = torch.where(seen, 0.0, torch.finfo(torch.float32).min)
    positions = (torch.cumsum(mask, dim=-1) - 1) * mask
    alibi = slopes.to(mask.device)[None, :, None, None] \
        * positions[:, None, None, :]
    return hidden[:, None] + alibi


class _Block(nn.Module):

    def __init__(self, tree: Dict, n_heads: int, eps: float,
                 post_layernorm_residual: bool):
        super().__init__()
        att, mlp = tree["self_attention"], tree["mlp"]
        self.input_layernorm = _layer_norm(tree["input_layernorm"], eps)
        self.query_key_value = _Dense(att["query_key_value"])
        self.dense = _Dense(att["dense"])
        self.post_attention_layernorm = _layer_norm(
            tree["post_attention_layernorm"], eps)
        self.dense_h_to_4h = _Dense(mlp["dense_h_to_4h"])
        self.dense_4h_to_h = _Dense(mlp["dense_4h_to_h"])
        self.n_heads = n_heads
        self.post_layernorm_residual = post_layernorm_residual

    def attention(self, x: torch.Tensor, bias: torch.Tensor
                  ) -> torch.Tensor:
        n, L, dim = x.shape
        dh = dim // self.n_heads
        qkv = self.query_key_value(x).view(n, L, self.n_heads, 3 * dh)
        q, k, v = (t.transpose(1, 2) for t in qkv.split(dh, dim=-1))
        scores = torch.matmul(q / math.sqrt(dh), k.transpose(-1, -2)) + bias
        p = torch.softmax(scores, dim=-1)
        return self.dense(torch.matmul(p, v).transpose(1, 2)
                          .reshape(n, L, dim))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        h = self.input_layernorm(x)
        x = self.attention(h, bias) + (h if self.post_layernorm_residual
                                       else x)
        h = self.post_attention_layernorm(x)
        y = self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(h),
                                      approximate="tanh"))
        return y + (h if self.post_layernorm_residual else x)


class Bloom(FrozenBackbone):
    """``FlaxBloomModel``'s last hidden state in float32, frozen.
    ``config``: the model's ``config.json``; ``params``: its flax parameter
    tree as numpy arrays (``word_embeddings/embedding``,
    ``word_embeddings_layernorm``, ``h/<i>/self_attention/query_key_value/
    kernel``, ..., ``ln_f``), or a head model's with that tree under
    ``transformer``."""

    model_type = "bloom"

    def __init__(self, config: Dict, params: Dict):
        super().__init__()
        backbone_type(config, ("bloom",))
        if "word_embeddings" not in params:   # saved from a head model
            params = params["transformer"]
        self.dim, n_layers, self.n_heads = bloom_sizes(config)
        if self.dim % self.n_heads:
            raise ValueError(f"hidden size {self.dim} is not a multiple of "
                             f"the {self.n_heads} heads")
        self.hidden_dim = 4 * self.dim
        self.pad_id = int(config.get("pad_token_id") or 0)
        cfg = {**BLOOM_DEFAULTS, **config}
        eps = float(cfg["layer_norm_epsilon"])
        self.word_embeddings = _frozen(params["word_embeddings"]["embedding"])
        self.word_embeddings_layernorm = _layer_norm(
            params["word_embeddings_layernorm"], eps)
        post = bool(cfg["apply_residual_connection_post_layernorm"])
        self.h = nn.ModuleList(
            _Block(params["h"][str(i)], self.n_heads, eps, post)
            for i in range(n_layers))
        self.ln_f = _layer_norm(params["ln_f"], eps)
        self.register_buffer("slopes", alibi_slopes(self.n_heads),
                             persistent=False)
        check_vocab(self.word_embeddings, cfg, self.dim)
        for i, block in enumerate(self.h):
            got = tuple(block.dense_h_to_4h.kernel.shape)
            if got != (self.dim, self.hidden_dim):
                raise ValueError(f"h/{i}/mlp/dense_h_to_4h of shape {got}; "
                                 f"the model's is "
                                 f"{(self.dim, self.hidden_dim)}")

    def chunk_rows(self, L: int) -> int:
        """Sequences a chunk takes: its scores and their bias (``2 n_head
        L`` floats a token) and its feed-forward activations each within
        the budget."""
        per_row = 4 * L * max(self.hidden_dim, 2 * self.n_heads * L)
        return max(1, distilbert.BUDGET_BYTES // per_row)

    def _encode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.word_embeddings_layernorm(
            F.embedding(ids, self.word_embeddings))
        bias = attention_bias(mask, self.slopes)
        for block in self.h:
            x = block(x, bias)
        return self.ln_f(x)
