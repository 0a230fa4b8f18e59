"""Tokenizers of the string and anyURI literals.

The port's copy of the run-time part of
:mod:`mrgcn_tpu.encodings.xsd.string`: the byte-level tokenizer
(vocab 259 = 256 bytes + PAD/CLS/SEP) that feeds the from-scratch text
encoder, and the pad symbol. Where the feature's configured HuggingFace
tokenizer is on disk (a directory or the hub cache, with its
``config.json`` or ``tokenizer_config.json`` and its ``vocab.txt`` or
``tokenizer.json``: what transformers' offline ``AutoTokenizer`` needs),
the pad symbol is that tokenizer's id of the pad token, read from its
vocabulary without transformers. The vectorizer (``generate_features``)
belongs to the ETL and is not ported.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

from mrgcn_tpu_torch.utils.hf import snapshot_dir

logger = logging.getLogger(__name__)


class ByteTokenizer:
    """Byte-level tokenizer: UTF-8 bytes shifted by nothing, specials above.

    vocab layout: 0..255 bytes, 256 PAD, 257 CLS, 258 SEP.
    """

    VOCAB_SIZE = 259
    PAD, CLS, SEP = 256, 257, 258
    pad_token = "[PAD]"

    @property
    def pad_token_id(self) -> int:
        return self.PAD

    @property
    def vocab_size(self) -> int:
        return self.VOCAB_SIZE

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            return [self.CLS] + ids + [self.SEP]
        return ids


def _vocabulary(directory: Path) -> Optional[Dict[str, int]]:
    """Token -> id of a tokenizer directory: ``tokenizer.json``'s model
    vocabulary and added tokens, else ``vocab.txt``'s lines."""
    if (directory / "tokenizer.json").is_file():
        spec = json.loads((directory / "tokenizer.json").read_text())
        vocab = dict((spec.get("model") or {}).get("vocab") or {})
        vocab.update({t["content"]: t["id"]
                      for t in spec.get("added_tokens", [])})
        return vocab
    if (directory / "vocab.txt").is_file():
        lines = (directory / "vocab.txt").read_text(
            encoding="utf-8").splitlines()
        return {token: i for i, token in enumerate(lines)}
    return None


def load_vocabulary(feature_config: Dict) -> Optional[Dict[str, int]]:
    """The vocabulary of the feature's configured HuggingFace tokenizer
    where its files are on disk, else None (the byte-level tokenizer is
    used). Nothing is fetched."""
    tok_cfg = feature_config.get("tokenizer")
    if not (tok_cfg and "config" in tok_cfg):
        return None
    # hub spec format: [repo, kind, model_name, ...] — take the model name
    # (reference: mrgcn/models/utils.py:32-44)
    name = next((s for s in reversed(tok_cfg["config"]) if "=" not in s),
                None)
    directory = snapshot_dir(name) if name else None
    if directory is None or not any(
            (directory / f).is_file()
            for f in ("config.json", "tokenizer_config.json")):
        logger.info("Pretrained tokenizer %s unavailable; using byte-level "
                    "tokenizer", name)
        return None
    vocab = _vocabulary(directory)
    if vocab is not None:
        logger.info("Using HuggingFace tokenizer %s", name)
    return vocab


def pad_symbol_for(feature_config: Dict) -> int:
    """The token id used for padding (reference: models/utils.py:61-65):
    the configured tokenizer's id of its ``pad_token`` (a token it lacks
    is added after its vocabulary, as transformers adds it), or the
    byte-level tokenizer's PAD."""
    vocab = load_vocabulary(feature_config)
    if vocab is None:
        return ByteTokenizer.PAD
    pad_token = feature_config["tokenizer"]["pad_token"]
    return vocab.get(pad_token, len(vocab))
