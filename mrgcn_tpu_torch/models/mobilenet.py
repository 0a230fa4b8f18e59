"""MobileNetV2 features, the v3.0 image backbone, in PyTorch.

Counterpart of :mod:`mrgcn_tpu.models.mobilenet` (``MobileNetV2Features``
and its torch checkpoint converter). The JAX package re-implements the
architecture in flax and converts a torchvision checkpoint into it; the
port builds the same network with torchvision's module names
(``features.<i>...``), so a torchvision-format ``mobilenet_v2-*.pth``
loads with ``load_state_dict(strict=True)``: that strict load is the
converter's check. The classifier is not built and its entries are
dropped, as the reference strips it.

The network, over ``(N, 3, H, W)`` float32 in NCHW: a stem convolution of
32 channels at stride 2, the 17 inverted residual blocks of
``INVERTED_RESIDUAL_PLAN`` (1x1 expansion, 3x3 depthwise, 1x1 projection,
a residual where the shape allows), a 1x1 head of 1280 channels; ReLU6
after every convolution but the projections; BatchNorm always in
inference mode (epsilon 1e-5, the running statistics); symmetric
``k // 2`` padding, as the JAX module pads. It runs on cuDNN in float32
with TF32 off (``utils/device.select_device``).
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)

# (expansion t, output channels c, repeats n, first stride s)
INVERTED_RESIDUAL_PLAN = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
STEM_CHANNELS = 32
HEAD_CHANNELS = 1280


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """``BatchNorm2d`` (torchvision's names and buffers) that always
    normalizes by its running statistics, whatever mode the module is
    in."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def conv_bn(inp: int, out: int, kernel: int, stride: int = 1,
            groups: int = 1, act: bool = True) -> nn.Sequential:
    """Conv2d (no bias, ``k // 2`` padding) -> BatchNorm -> ReLU6, as
    torchvision's ``Conv2dNormActivation``."""
    layers = [nn.Conv2d(inp, out, kernel, stride, kernel // 2,
                        groups=groups, bias=False),
              FrozenBatchNorm2d(out)]
    if act:
        layers.append(nn.ReLU6())
    return nn.Sequential(*layers)


class InvertedResidual(nn.Module):

    def __init__(self, inp: int, out: int, stride: int, expand: int):
        super().__init__()
        hidden = inp * expand
        self.use_res = stride == 1 and inp == out
        layers = []
        if expand != 1:
            layers.append(conv_bn(inp, hidden, 1))
        layers.append(conv_bn(hidden, hidden, 3, stride, groups=hidden))
        layers.append(nn.Conv2d(hidden, out, 1, 1, 0, bias=False))
        layers.append(FrozenBatchNorm2d(out))
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


class MobileNetV2Features(nn.Module):
    """``(N, 3, H, W)`` -> ``(N, 1280, H / 32, W / 32)``, frozen."""

    def __init__(self):
        super().__init__()
        feats = [conv_bn(3, STEM_CHANNELS, 3, 2)]
        inp = STEM_CHANNELS
        for t, c, n, s in INVERTED_RESIDUAL_PLAN:
            for i in range(n):
                feats.append(InvertedResidual(inp, c, s if i == 0 else 1, t))
                inp = c
        feats.append(conv_bn(inp, HEAD_CHANNELS, 1))
        self.features = nn.Sequential(*feats)
        self.requires_grad_(False)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


def load_state_dict(model: MobileNetV2Features,
                    state_dict: Dict[str, torch.Tensor]) -> None:
    """A torchvision MobileNetV2 state dict into ``model``, strictly: every
    feature entry must be there with its shape; the classifier's entries
    are dropped."""
    features = {k: v for k, v in state_dict.items()
                if not k.startswith("classifier")}
    model.load_state_dict(features, strict=True)


def find_local_checkpoint() -> Optional[str]:
    """A MobileNetV2 torch checkpoint found without network access:
    ``MRGCN_VISION_WEIGHTS``, then the torch.hub cache under
    ``$TORCH_HOME`` (``~/.cache/torch`` by default)."""
    explicit = os.environ.get("MRGCN_VISION_WEIGHTS")
    if explicit and os.path.exists(explicit):
        return explicit
    hub = os.environ.get("TORCH_HOME", os.path.expanduser("~/.cache/torch"))
    hits = sorted(glob.glob(os.path.join(hub, "hub", "checkpoints",
                                         "*mobilenet_v2*.pth")))
    return hits[0] if hits else None


def load_image_backbone(path: str) -> MobileNetV2Features:
    """The frozen backbone of the checkpoint at ``path`` (a state dict, or
    a dict holding one under ``state_dict``). A file that does not load
    raises: the JAX package logs it and trains its from-scratch CNN
    instead."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = MobileNetV2Features()
    load_state_dict(model, sd)
    logger.info("Using pretrained image backbone %s (frozen)", path)
    return model
