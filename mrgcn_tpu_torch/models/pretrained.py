"""Frozen pretrained backbones with trainable heads (the v3.0 encoders).

Counterpart of :mod:`mrgcn_tpu.models.pretrained`. Each encoder holds a
frozen backbone and trains a head: ``Dense_0`` (as wide as the pooled
backbone output) -> ReLU -> dropout -> ``Dense_1`` (torch-linear kernels,
zero biases: flax's initializers there), the reference's ``pre_fc`` /
``fc`` (reference: mrgcn/models/{transformer,imagecnn}.py).

* :class:`PretrainedTextEncoder`: DistilBERT (:mod:`.distilbert`) over
  token ids with ``attention_mask = tokens > 0``, pooled at the first
  position (CLS).
* :class:`PretrainedImageEncoder`: MobileNetV2 features (:mod:`.mobilenet`)
  over normalized ``(N, 3, H, W)`` images, averaged over H and W.

As in the JAX package, where the backbone is a module attribute outside
``params``, the backbone is not a submodule: it is in none of
``parameters()``, ``state_dict()``, the optimizer or a checkpoint, and a
restored model rebuilds it from disk. It still moves with ``.to()``
(``_apply`` carries it), and its forward runs under ``torch.no_grad``.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrgcn_tpu_torch.models import init as tinit
from mrgcn_tpu_torch.models.encoders import Dense
from mrgcn_tpu_torch.utils.hf import resolve_snapshot

logger = logging.getLogger(__name__)


def hub_model_name(hub_spec) -> Optional[str]:
    """The model name of a torch.hub-style spec: its last positional
    entry (reference: models/utils.py:32-44)."""
    if not hub_spec:
        return None
    return next((s for s in reversed(hub_spec)
                 if isinstance(s, str) and "=" not in s), None)


def load_text_backbone(hub_spec):
    """The frozen DistilBERT of a locally available model, else None (the
    from-scratch text encoder is used): available where the model's
    directory or hub-cache snapshot holds ``config.json`` and
    ``flax_model.msgpack`` (:func:`..utils.hf.resolve_snapshot`), which is
    where the JAX package's loader succeeds. Files that are there but do
    not load raise: the JAX package logs it and trains the from-scratch
    encoder instead."""
    from mrgcn_tpu_torch.models.distilbert import DistilBert
    name = hub_model_name(hub_spec)
    snapshot = resolve_snapshot(name) if name else None
    if snapshot is None:
        logger.info("Pretrained LM %s unavailable locally; using the "
                    "from-scratch text encoder", name)
        return None
    logger.info("Using pretrained language model %s (frozen)", name)
    return DistilBert.from_pretrained(snapshot)


class _Head(nn.Module):
    """A frozen backbone (kept off the module tree) and the trainable
    ``Dense_0`` -> ReLU -> dropout -> ``Dense_1`` head."""

    def __init__(self, backbone: nn.Module, width: int, output_dim: int,
                 generator: torch.Generator, p_dropout: float):
        super().__init__()
        backbone.requires_grad_(False)
        self.__dict__["backbone"] = backbone
        self.p_dropout = p_dropout
        self.Dense_0 = Dense(width, width, generator,
                             kernel_init=tinit.torch_linear_kernel)
        self.Dense_1 = Dense(width, output_dim, generator,
                             kernel_init=tinit.torch_linear_kernel)

    def _apply(self, fn, *args, **kwargs):
        super()._apply(fn, *args, **kwargs)
        self.backbone._apply(fn, *args, **kwargs)
        return self

    def head(self, pooled: torch.Tensor, train: bool) -> torch.Tensor:
        x = torch.relu(self.Dense_0(pooled))
        x = F.dropout(x, self.p_dropout, training=train)
        return self.Dense_1(x)


class PretrainedTextEncoder(_Head):
    """Frozen language model + trainable head over token ids ``(N, L)``
    (0 pads); returns ``(N, output_dim)`` f32."""

    def __init__(self, backbone: nn.Module, output_dim: int,
                 generator: torch.Generator, p_dropout: float = 0.2):
        super().__init__(backbone, backbone.dim, output_dim, generator,
                         p_dropout)

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        """The backbone's pooled output (CLS), ``(N, dim)``."""
        with torch.no_grad():
            hidden = self.backbone(tokens, attention_mask=tokens > 0)
            return hidden[:, 0].contiguous()

    def forward(self, tokens: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        return self.head(self.features(tokens), train)


class PretrainedImageEncoder(_Head):
    """Frozen vision backbone + trainable head over normalized images
    ``(N, 3, H, W)``; returns ``(N, output_dim)`` f32. The backbone runs
    over ``chunk`` images at a time: nothing of it is kept for a backward,
    so this bounds its activations (2,000 images of 224 x 224 at once would
    hold 9.6 GB in one expansion layer's output); each image's features
    are its own whatever the chunk."""

    chunk = 256

    def __init__(self, backbone: nn.Module, output_dim: int,
                 generator: torch.Generator, p_dropout: float = 0.2):
        from mrgcn_tpu_torch.models.mobilenet import HEAD_CHANNELS
        super().__init__(backbone, HEAD_CHANNELS, output_dim, generator,
                         p_dropout)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """The backbone's output averaged over H and W, ``(N, 1280)``."""
        with torch.no_grad():
            return torch.cat([
                self.backbone(images[i:i + self.chunk].float())
                .mean(dim=(2, 3))
                for i in range(0, images.shape[0], self.chunk)])

    def forward(self, images: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        return self.head(self.features(images), train)
