"""HuggingFace hub environment control (no heavy imports)."""

from __future__ import annotations

import os


def force_hf_offline():
    """The framework's pretrained loaders are cache-only by design
    (``local_files_only=True``), but newer transformers still probes the
    hub for PEFT adapter configs — 5 network retries per probe, minutes of
    wall-clock in an egress-less environment. Pin hub offline before the
    first transformers import; ``MRGCN_HF_ONLINE=1`` restores network
    lookups."""
    if os.environ.get("MRGCN_HF_ONLINE") != "1":
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
