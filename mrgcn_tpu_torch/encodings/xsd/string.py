"""Tokenizers of the string and anyURI literals.

The port's copy of the run-time part of
:mod:`mrgcn_tpu.encodings.xsd.string`: the byte-level tokenizer
(vocab 259 = 256 bytes + PAD/CLS/SEP) that feeds the from-scratch text
encoder, the lookup of a locally cached HuggingFace tokenizer, and the pad
symbol. The vectorizer (``generate_features``) belongs to the ETL and is
not ported.
"""

from __future__ import annotations

import logging
from typing import Dict, List

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


def load_tokenizer(feature_config: Dict):
    """Resolve the tokenizer for a string-family feature config.

    Tries the configured HuggingFace tokenizer from the local cache only
    ; falls back to :class:`ByteTokenizer`.
    """
    tok_cfg = feature_config.get("tokenizer")
    if tok_cfg and "config" in tok_cfg:
        spec = tok_cfg["config"]
        # hub spec format: [repo, kind, model_name, ...] — take the model name
        # (reference: mrgcn/models/utils.py:32-44)
        name = next((s for s in reversed(spec) if "=" not in s), None)
        if name:
            try:
                from mrgcn_tpu_torch.utils.hf import force_hf_offline
                force_hf_offline()
                from transformers import AutoTokenizer
                tokenizer = AutoTokenizer.from_pretrained(
                    name, local_files_only=True)
                if tokenizer.pad_token is None and "pad_token" in tok_cfg:
                    tokenizer.add_special_tokens(
                        {"pad_token": tok_cfg["pad_token"]})
                logger.info("Using HuggingFace tokenizer %s", name)
                return tokenizer
            except Exception:  # offline / not cached
                logger.info("Pretrained tokenizer %s unavailable; "
                            "using byte-level tokenizer", name)
    return ByteTokenizer()


def pad_symbol_for(feature_config: Dict) -> int:
    """The token id used for padding (reference: models/utils.py:61-65)."""
    tokenizer = load_tokenizer(feature_config)
    if isinstance(tokenizer, ByteTokenizer):
        return tokenizer.pad_token_id
    pad_token = feature_config["tokenizer"]["pad_token"]
    return tokenizer.encode(pad_token, add_special_tokens=False)[0]
