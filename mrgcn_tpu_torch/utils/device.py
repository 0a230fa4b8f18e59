"""Device selection for the port.

``MRGCN_PLATFORM`` (the JAX CLIs' override) picks the device: ``cpu``
selects the CPU, anything else (or unset) the current CUDA device. Asking
for CUDA without a card raises; the port never falls back to the CPU on
its own.

Every float32 contraction runs in full float32, as the JAX package pins
``Precision.HIGHEST`` on its contractions: TF32 is switched off for
matmuls and convolutions.
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


def select_device() -> torch.device:
    """The device ``MRGCN_PLATFORM`` asks for, with f32 precision pinned."""
    pin_float32_precision()
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
