"""String and anyURI literal vectorizers (token sequences) and their
tokenizers.

The port's copy of :mod:`mrgcn_tpu.encodings.xsd.string`. Two tokenizers:
the byte-level one (vocab 259 = 256 bytes + PAD/CLS/SEP) that feeds the
from-scratch text encoder, and, where the feature's configured HuggingFace
tokenizer is on disk (a directory or the hub cache, with its
``config.json`` or ``tokenizer_config.json`` and its ``vocab.txt`` or
``tokenizer.json``: what transformers' offline ``AutoTokenizer`` needs),
BERT's WordPiece (:mod:`.wordpiece`, without transformers), which gives
the ids of the JAX package's ``AutoTokenizer``. Files of another kind of
tokenizer raise, naming it; the JAX package falls back to the byte-level
tokenizer on any exception there, which trains another model from the
same config. Where no files are found, both use the byte-level one.

This module also covers ``xsd.anyURI`` (the reference's anyURI module is
byte-identical to string except for the datatype filter). Sequences are
truncated to 512 tokens (reference: string.py:12, 73).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from mrgcn_tpu_torch.data.rdf import xsd
from mrgcn_tpu_torch.encodings.common import literal_nodes, plain_string_nodes
from mrgcn_tpu_torch.encodings.xsd import wordpiece
from mrgcn_tpu_torch.utils.hf import snapshot_dir

logger = logging.getLogger(__name__)

MAX_CHARS = 512


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
    """The tokenizer of a string-family feature config: the configured
    HuggingFace tokenizer's WordPiece where its files are on disk (a
    directory or the hub cache, with ``config.json`` or
    ``tokenizer_config.json`` and a vocabulary), else
    :class:`ByteTokenizer`. Nothing is fetched. Raises ``ValueError`` where
    the files are there but describe a tokenizer the port does not
    implement."""
    tok_cfg = feature_config.get("tokenizer")
    if not (tok_cfg and "config" in tok_cfg):
        return ByteTokenizer()
    # hub spec format: [repo, kind, model_name, ...] — take the model name
    # (reference: mrgcn/models/utils.py:32-44)
    name = next((s for s in reversed(tok_cfg["config"]) if "=" not in s),
                None)
    directory = snapshot_dir(name) if name else None
    tokenizer = None
    if directory is not None and any(
            (directory / f).is_file()
            for f in ("config.json", "tokenizer_config.json")):
        tokenizer = wordpiece.load(directory)
    if tokenizer is None:
        logger.info("Pretrained tokenizer %s unavailable; using byte-level "
                    "tokenizer", name)
        return ByteTokenizer()
    logger.info("Using HuggingFace tokenizer %s", name)
    return tokenizer


def pad_symbol_for(feature_config: Dict) -> int:
    """The token id used for padding (reference: models/utils.py:61-65):
    the configured tokenizer's first id of its ``pad_token``, or the
    byte-level tokenizer's PAD."""
    tokenizer = load_tokenizer(feature_config)
    if isinstance(tokenizer, ByteTokenizer):
        return tokenizer.pad_token_id
    pad_token = feature_config["tokenizer"]["pad_token"]
    return tokenizer.encode(pad_token, add_special_tokens=False)[0]


def generate_features(nodes_map: Dict, node_predicate_map: Dict,
                      config: Dict) -> Optional[List]:
    datatype = config["datatype"]
    if datatype == "xsd.anyURI":
        nodes = literal_nodes(nodes_map, xsd("anyURI"))
    else:
        nodes = plain_string_nodes(nodes_map, xsd("string"))

    tokenizer = load_tokenizer(config)

    sequences: Dict[object, List[np.ndarray]] = {}
    node_idx: Dict[object, List[int]] = {}
    seq_lengths: Dict[object, List[int]] = {}

    failed = 0
    for node, i in nodes:
        try:
            seq = tokenizer.encode(str(node), add_special_tokens=True)
        except Exception:
            failed += 1
            continue
        if len(seq) <= 0:
            failed += 1
            continue

        a = np.asarray(seq, dtype=np.int32)[:MAX_CHARS]
        for p in node_predicate_map.get(node, ()):
            sequences.setdefault(p, []).append(a)
            node_idx.setdefault(p, []).append(i)
            seq_lengths.setdefault(p, []).append(len(a))

    total = sum(len(v) for v in sequences.values())
    logger.debug("Generated %d unique %s features (%d failed)",
                 total, datatype, failed)
    if total <= 0:
        return None

    out = []
    for p in sequences:
        ragged = np.empty(len(sequences[p]), dtype=object)
        for j, a in enumerate(sequences[p]):
            ragged[j] = a
        out.append([ragged,
                    np.asarray(node_idx[p], dtype=np.int32),
                    np.asarray(seq_lengths[p], dtype=np.int32)])
    return out
