"""HuggingFace hub files found offline, without transformers.

:func:`resolve_snapshot` finds the directory of a model's files as
transformers' offline lookup does (``local_files_only=True``): a directory
path as given, or a snapshot of the hub cache. The cache is
``HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
``~/.cache/huggingface/hub``; a model ``org/name`` lives under
``models--org--name``, whose ``refs/main`` names the revision under
``snapshots/``. Nothing here reaches the network.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

# a hub model id: "name" or "org/name" (huggingface_hub's validate_repo_id)
_REPO_ID = re.compile(r"^[\w.\-]{1,96}(/[\w.\-]{1,96})?$")


def hub_cache() -> Path:
    """The hub cache directory, as huggingface_hub resolves it."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"]).expanduser()
    home = os.environ.get("HF_HOME")
    if home:
        return Path(home).expanduser() / "hub"
    return Path("~/.cache/huggingface/hub").expanduser()


def snapshot_dir(name: str) -> Optional[Path]:
    """The directory that holds ``name``'s files: ``name`` itself where it
    is a directory, else the cached snapshot of the hub model ``name`` at
    ``refs/main`` (or None)."""
    if os.path.isdir(name):
        return Path(name)
    if not _REPO_ID.match(name) or "--" in name or ".." in name \
            or name.endswith(".git"):
        return None
    repo = hub_cache() / ("models--" + name.replace("/", "--"))
    revision = "main"
    ref = repo / "refs" / "main"
    if ref.is_file():
        revision = ref.read_text().strip()
    snapshot = repo / "snapshots" / revision
    return snapshot if snapshot.is_dir() else None


# the files the JAX package's backbone loader needs
# (``FlaxAutoModel.from_pretrained(name, local_files_only=True)``)
BACKBONE_FILES = ("config.json", "flax_model.msgpack")


def resolve_snapshot(name: str) -> Optional[Path]:
    """The directory of ``name``'s files where ``BACKBONE_FILES`` are all
    there, else None: where they are, the JAX package runs the pretrained
    model."""
    snapshot = snapshot_dir(name)
    if snapshot is None:
        return None
    if all((snapshot / f).is_file() for f in BACKBONE_FILES):
        return snapshot
    return None
