"""Device selection for the port.

``MRGCN_PLATFORM`` (the JAX CLIs' override) picks the device: ``cpu``
selects the CPU, anything else (or unset) the current CUDA device. Asking
for CUDA without a card raises; the port never falls back to the CPU on
its own.

Every float32 contraction runs in full float32, as the JAX package pins
``Precision.HIGHEST`` on its contractions: TF32 is switched off for
matmuls and convolutions. cuDNN picks each convolution's algorithm by
timing the candidates on its first call at a shape (``cudnn.benchmark``):
its heuristic choice for TCNN S's f32 backward at 10,000 geometries
takes a workspace of tens of GB and several times as long
(``chip_smoke.py --only conv_algorithms`` prints both on the card).
"""

from __future__ import annotations

import logging
import os

import torch

logger = logging.getLogger(__name__)


def pin_float32_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def measure_conv_algorithms() -> None:
    torch.backends.cudnn.benchmark = True


def select_device() -> torch.device:
    """The device ``MRGCN_PLATFORM`` asks for, with f32 precision pinned
    and cuDNN's convolution algorithms measured."""
    pin_float32_precision()
    measure_conv_algorithms()
    platform = os.environ.get("MRGCN_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (MRGCN_PLATFORM="
            f"{platform or 'unset'}) but torch.cuda.is_available() is "
            "false; set MRGCN_PLATFORM=cpu to run on the CPU")
    device = torch.device("cuda", torch.cuda.current_device())
    logger.info("Device: %s (%s)", device, torch.cuda.get_device_name(device))
    return device
