"""DistilBERT, the v3.0 text backbone, in float32 PyTorch.

Counterpart of what the JAX package's ``load_text_backbone`` returns,
transformers' ``FlaxDistilBertModel`` (no Pallas kernel there: plain XLA
in float32), built from a model directory's ``config.json`` and its
``flax_model.msgpack`` (:mod:`..utils.flax_msgpack`), so both packages
read the same files:

* word and learned position embeddings, summed, then LayerNorm
  (epsilon 1e-12);
* per layer: ``q_lin`` / ``k_lin`` / ``v_lin`` / ``out_lin`` over
  ``n_heads`` heads, the query scaled by ``1 / sqrt(dim / n_heads)``,
  ``1e30`` taken off the scores of keys where the attention mask is 0,
  an f32 softmax; ``sa_layer_norm`` of the attention output plus its
  input, ``ffn.lin1`` -> exact (erf) GELU -> ``ffn.lin2``,
  ``output_layer_norm`` of that plus its input;
* the output is the last layer's hidden state ``(N, L, dim)``.

Kernels are flax's ``(in, out)``; they stay in that layout. The model is
frozen: :meth:`DistilBert.forward` runs under ``torch.no_grad`` in
chunks of sequences, so that the ``(chunk, heads, L, L)`` scores and the
``(chunk, L, hidden_dim)`` feed-forward activations stay under
``BUDGET_BYTES`` (at 8,000 sequences of 512 tokens the scores of all of
them would take 100 GB).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mrgcn_tpu_torch.models.encoders import LayerNorm
from mrgcn_tpu_torch.utils import flax_msgpack

# what one chunk of sequences may hold of scores or feed-forward
# activations
BUDGET_BYTES = 1 << 30


def _frozen(array) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.asarray(array, np.float32)),
                        requires_grad=False)


class _Dense(nn.Module):
    """A flax Dense of the backbone: ``kernel (in, out)``, ``bias``."""

    def __init__(self, tree: Dict):
        super().__init__()
        self.kernel = _frozen(tree["kernel"])
        self.bias = _frozen(tree["bias"])

    def forward(self, x):
        return torch.matmul(x, self.kernel) + self.bias


def _layer_norm(tree: Dict) -> LayerNorm:
    ln = LayerNorm(len(tree["scale"]), torch.float32, epsilon=1e-12)
    ln.scale = _frozen(tree["scale"])
    ln.bias = _frozen(tree["bias"])
    return ln


class _Block(nn.Module):

    def __init__(self, tree: Dict, n_heads: int):
        super().__init__()
        att = tree["attention"]
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            setattr(self, name, _Dense(att[name]))
        self.sa_layer_norm = _layer_norm(tree["sa_layer_norm"])
        self.lin1 = _Dense(tree["ffn"]["lin1"])
        self.lin2 = _Dense(tree["ffn"]["lin2"])
        self.output_layer_norm = _layer_norm(tree["output_layer_norm"])
        self.n_heads = n_heads

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        n, L, dim = x.shape
        h = self.n_heads
        dh = dim // h

        def heads(t):
            return t.view(n, L, h, dh).transpose(1, 2)

        q = heads(self.q_lin(x)) / math.sqrt(dh)
        k, v = heads(self.k_lin(x)), heads(self.v_lin(x))
        scores = torch.matmul(q, k.transpose(-1, -2))
        scores = scores - 1e30 * (1.0 - mask[:, None, None, :])
        p = torch.softmax(scores, dim=-1)
        context = torch.matmul(p, v).transpose(1, 2).reshape(n, L, dim)
        x = self.sa_layer_norm(self.out_lin(context) + x)
        y = self.lin2(F.gelu(self.lin1(x)))
        return self.output_layer_norm(y + x)


class DistilBert(nn.Module):
    """``FlaxDistilBertModel``'s forward in float32, frozen. ``config``:
    the model's ``config.json``; ``params``: its flax parameter tree
    (``embeddings/word_embeddings/embedding``,
    ``transformer/layer/<i>/attention/q_lin/kernel``, ...)."""

    def __init__(self, config: Dict, params: Dict):
        super().__init__()
        if config.get("model_type", "distilbert") != "distilbert":
            raise NotImplementedError(
                f"text backbone of type {config.get('model_type')!r}: the "
                "port runs DistilBERT only")
        if config.get("sinusoidal_pos_embds", False):
            raise NotImplementedError(
                "DistilBERT with sinusoidal position embeddings")
        if config.get("activation", "gelu") != "gelu":
            raise NotImplementedError(
                f"DistilBERT activation {config.get('activation')!r}; the "
                "port runs gelu")
        if "embeddings" not in params and "distilbert" in params:
            params = params["distilbert"]     # saved from a head model
        self.dim = int(config["dim"])
        self.n_heads = int(config["n_heads"])
        self.hidden_dim = int(config["hidden_dim"])
        emb = params["embeddings"]
        self.word_embeddings = _frozen(emb["word_embeddings"]["embedding"])
        self.position_embeddings = _frozen(
            emb["position_embeddings"]["embedding"])
        self.LayerNorm = _layer_norm(emb["LayerNorm"])
        layers = params["transformer"]["layer"]
        self.layers = nn.ModuleList(
            _Block(layers[str(i)], self.n_heads)
            for i in range(int(config["n_layers"])))
        want = (int(config["vocab_size"]), self.dim)
        if tuple(self.word_embeddings.shape) != want:
            raise ValueError(f"word embeddings of shape "
                             f"{tuple(self.word_embeddings.shape)}, the "
                             f"config says {want}")

    @classmethod
    def from_pretrained(cls, directory) -> "DistilBert":
        """The model of a directory holding ``config.json`` and
        ``flax_model.msgpack``."""
        directory = Path(directory)
        config = json.loads((directory / "config.json").read_text())
        params = flax_msgpack.load(directory / "flax_model.msgpack")
        return cls(config, params)

    def chunk_rows(self, L: int) -> int:
        """Sequences a chunk takes: its scores and its feed-forward
        activations each within the budget."""
        per_row = 4 * L * max(self.hidden_dim, self.n_heads * L, self.dim)
        return max(1, BUDGET_BYTES // per_row)

    def _encode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        x = F.embedding(ids, self.word_embeddings) \
            + self.position_embeddings[:L][None]
        x = self.LayerNorm(x)
        for layer in self.layers:
            x = layer(x, mask)
        return x

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Last hidden state ``(N, L, dim)`` f32 of ``input_ids`` ``(N,
        L)``; ``attention_mask`` (1 at real tokens) defaults to all
        ones."""
        ids = input_ids.long()
        mask = torch.ones_like(ids, dtype=torch.float32) \
            if attention_mask is None else attention_mask.float()
        N, L = ids.shape
        if L > self.position_embeddings.shape[0]:
            raise ValueError(f"{L} tokens; the model has "
                             f"{self.position_embeddings.shape[0]} "
                             "positions")
        out = torch.empty((N, L, self.dim), dtype=torch.float32,
                          device=ids.device)
        step = self.chunk_rows(L)
        for i in range(0, N, step):
            out[i:i + step] = self._encode(ids[i:i + step],
                                           mask[i:i + step])
        return out
