"""DistilBERT, the v3.0 text backbone, in float32 PyTorch.

Counterpart of what the JAX package's ``load_text_backbone`` returns,
transformers' ``FlaxDistilBertModel`` (no Pallas kernel there: plain XLA
in float32), built from a model directory's ``config.json`` and its
``flax_model.msgpack`` (:mod:`..utils.flax_msgpack`), so both packages
read the same files:

* word and position embeddings, summed, then LayerNorm (epsilon
  1e-12); the position embeddings are learned, or with
  ``sinusoidal_pos_embds`` fixed: ``sin`` on the even and ``cos`` on the
  odd columns of ``pos / 10000^(2j / dim)`` (column ``2j`` and ``2j + 1``
  share ``j``), as transformers' ``positional_encoding`` has them;
* per layer: ``q_lin`` / ``k_lin`` / ``v_lin`` / ``out_lin`` over
  ``n_heads`` heads, the query scaled by ``1 / sqrt(dim / n_heads)``,
  ``1e30`` taken off the scores of keys where the attention mask is 0,
  an f32 softmax; ``sa_layer_norm`` of the attention output plus its
  input, ``ffn.lin1`` -> the config's ``activation`` (exact (erf) GELU,
  the default, or ReLU) -> ``ffn.lin2``, ``output_layer_norm`` of that
  plus its input;
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


# the feed-forward activations the config's ``activation`` may name
ACTIVATIONS = {"gelu": F.gelu, "relu": F.relu}
# the text backbones' ``model_type``s the port runs: DistilBERT here, the
# others in :mod:`.bert`, :mod:`.albert` and :mod:`.bloom`
TEXT_BACKBONE_TYPES = ("distilbert", "bert", "roberta", "xlm-roberta",
                       "roberta-prelayernorm", "albert", "bloom")
# the other families of transformers' ``FlaxAutoModel``: what the JAX
# package's encoder meets at its first step, which calls the module with
# ``input_ids`` and ``attention_mask`` alone
JAX_FIRST_STEP_FAILS = {
    ("electra", "roformer", "big_bird", "gpt2", "gpt-sw3", "gpt_neo",
     "gptj", "opt", "xglm"):
        "a TypeError: its module's token types or positions are required "
        "positional arguments",
    ("t5", "mt5", "longt5"):
        "an AttributeError: it is given no decoder inputs",
    ("llama", "mistral", "gemma"):
        "a broadcast error in its rotary tables",
    ("bart", "mbart", "marian", "pegasus", "blenderbot",
     "blenderbot-small"):
        "a TypeError: its decoder inputs are required",
    ("beit", "clip", "dinov2", "regnet", "resnet", "vision-text-dual-encoder",
     "vit", "wav2vec2", "whisper"):
        "an error: it is no text encoder",
}


def unported_reason(model_type: str) -> str:
    """Why the port does not run a text backbone of ``model_type``, and
    what the JAX package does with it."""
    for families, error in JAX_FIRST_STEP_FAILS.items():
        if model_type in families:
            return ("the JAX package's FlaxAutoModel loads it and its "
                    f"encoder fails at the first step with {error}")
    return ("transformers' FlaxAutoModel does not map it: the JAX package "
            "trains its from-scratch text encoder instead")


def backbone_type(config: Dict, accepted) -> str:
    """``config``'s ``model_type`` (the first of ``accepted`` where it has
    none); raises ``NotImplementedError`` naming it where it is not in
    ``accepted``."""
    model_type = config.get("model_type", accepted[0])
    if model_type in accepted:
        return model_type
    if model_type in TEXT_BACKBONE_TYPES:
        why = (f"this module reads {', '.join(accepted)}; "
               "models.pretrained.load_text_backbone picks the module of "
               "each type")
    else:
        why = (f"the port runs {', '.join(TEXT_BACKBONE_TYPES)}; "
               + unported_reason(model_type))
    raise NotImplementedError(
        f"text backbone of model_type {model_type!r}: {why}")


def sinusoidal_positions(positions: int, dim: int) -> np.ndarray:
    """``(positions, dim)`` f32: ``sin`` on the even and ``cos`` on the odd
    columns of ``pos / 10000^(2 (j // 2) / dim)``, computed in float64."""
    pos = np.arange(positions)[:, None]
    j = np.arange(dim)[None, :]
    angles = pos * (1 / np.power(10000, (2 * (j // 2)) / np.float32(dim)))
    angles[:, 0::2] = np.sin(angles[:, 0::2])
    angles[:, 1::2] = np.cos(angles[:, 1::2])
    return angles.astype(np.float32)


def _layer_norm(tree: Dict, epsilon: float = 1e-12) -> LayerNorm:
    """A flax LayerNorm of the backbone (``scale``, ``bias``), frozen."""
    ln = LayerNorm(len(tree["scale"]), torch.float32, epsilon=epsilon)
    ln.scale = _frozen(tree["scale"])
    ln.bias = _frozen(tree["bias"])
    return ln


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Softmax attention of the projections ``q``, ``k``, ``v`` ``(n, L,
    dim)`` over ``n_heads`` heads: the query scaled by ``1 / sqrt(dim /
    n_heads)``, ``1e30`` taken off the scores of keys where ``mask`` ``(n,
    L)`` is 0, an f32 softmax; the context ``(n, L, dim)``."""
    n, L, dim = q.shape
    dh = dim // n_heads

    def heads(t):
        return t.view(n, L, n_heads, dh).transpose(1, 2)

    scores = torch.matmul(heads(q) / math.sqrt(dh),
                          heads(k).transpose(-1, -2))
    scores = scores - 1e30 * (1.0 - mask[:, None, None, :])
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(p, heads(v)).transpose(1, 2).reshape(n, L, dim)


class _Block(nn.Module):

    def __init__(self, tree: Dict, n_heads: int, activation):
        super().__init__()
        att = tree["attention"]
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            setattr(self, name, _Dense(att[name]))
        self.sa_layer_norm = _layer_norm(tree["sa_layer_norm"])
        self.lin1 = _Dense(tree["ffn"]["lin1"])
        self.lin2 = _Dense(tree["ffn"]["lin2"])
        self.output_layer_norm = _layer_norm(tree["output_layer_norm"])
        self.n_heads = n_heads
        self.activation = activation

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        context = masked_attention(self.q_lin(x), self.k_lin(x),
                                   self.v_lin(x), mask, self.n_heads)
        x = self.sa_layer_norm(self.out_lin(context) + x)
        y = self.lin2(self.activation(self.lin1(x)))
        return self.output_layer_norm(y + x)


class FrozenBackbone(nn.Module):
    """What the frozen text backbones share: :meth:`from_pretrained`, and
    :meth:`forward` over chunks of sequences (``chunk_rows``). A subclass
    is built from ``(config, params)`` and sets ``dim``, ``n_heads``,
    ``hidden_dim`` (the feed-forward width) and ``position_embeddings``,
    and defines ``_encode(ids, mask)``; ``first_position`` is the
    position embedding of the first token past which ``L`` tokens must
    fit (a model without position embeddings, BLOOM, takes any ``L``)."""

    first_position = 0

    @classmethod
    def from_pretrained(cls, directory):
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
        table = getattr(self, "position_embeddings", None)
        positions = L if table is None else table.shape[0]
        if self.first_position + L > positions:
            raise ValueError(f"{L} tokens; the model has {positions} "
                             "positions" + (
                                 f" from {self.first_position}"
                                 if self.first_position else ""))
        out = torch.empty((N, L, self.dim), dtype=torch.float32,
                          device=ids.device)
        step = self.chunk_rows(L)
        for i in range(0, N, step):
            out[i:i + step] = self._encode(ids[i:i + step],
                                           mask[i:i + step])
        return out


class DistilBert(FrozenBackbone):
    """``FlaxDistilBertModel``'s forward in float32, frozen. ``config``:
    the model's ``config.json``; ``params``: its flax parameter tree
    (``embeddings/word_embeddings/embedding``,
    ``transformer/layer/<i>/attention/q_lin/kernel``, ...)."""

    def __init__(self, config: Dict, params: Dict):
        super().__init__()
        backbone_type(config, ("distilbert",))
        activation = config.get("activation", "gelu")
        if activation not in ACTIVATIONS:
            raise NotImplementedError(
                f"DistilBERT activation {activation!r}; the port runs "
                f"{' and '.join(ACTIVATIONS)}")
        if "embeddings" not in params and "distilbert" in params:
            params = params["distilbert"]     # saved from a head model
        self.dim = int(config["dim"])
        self.n_heads = int(config["n_heads"])
        self.hidden_dim = int(config["hidden_dim"])
        emb = params["embeddings"]
        self.word_embeddings = _frozen(emb["word_embeddings"]["embedding"])
        # fixed sinusoids carry no parameters in the flax tree
        self.position_embeddings = _frozen(
            sinusoidal_positions(int(config["max_position_embeddings"]),
                                 self.dim)
            if config.get("sinusoidal_pos_embds", False)
            else emb["position_embeddings"]["embedding"])
        self.LayerNorm = _layer_norm(emb["LayerNorm"])
        layers = params["transformer"]["layer"]
        self.layers = nn.ModuleList(
            _Block(layers[str(i)], self.n_heads, ACTIVATIONS[activation])
            for i in range(int(config["n_layers"])))
        check_vocab(self.word_embeddings, config, self.dim)

    def _encode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        x = F.embedding(ids, self.word_embeddings) \
            + self.position_embeddings[:L][None]
        x = self.LayerNorm(x)
        for layer in self.layers:
            x = layer(x, mask)
        return x


def check_vocab(word_embeddings: torch.Tensor, config: Dict,
                dim: int) -> None:
    want = (int(config["vocab_size"]), dim)
    if tuple(word_embeddings.shape) != want:
        raise ValueError(f"word embeddings of shape "
                         f"{tuple(word_embeddings.shape)}, the config says "
                         f"{want}")
