"""BERT's WordPiece tokenizer in plain Python, without transformers.

The string vectorizer's tokenizer where the feature's configured
HuggingFace tokenizer is a BERT-family snapshot on disk (``vocab.txt`` or
a WordPiece ``tokenizer.json``, with ``tokenizer_config.json`` or
``config.json``). :meth:`WordPieceTokenizer.encode` gives the ids of the
JAX package's ``AutoTokenizer.from_pretrained(name).encode(text,
add_special_tokens=True)``, which is the fast BERT tokenizer of the Rust
``tokenizers`` library:

1. special tokens (``[UNK]``, ``[SEP]``, ``[PAD]``, ``[CLS]``, ``[MASK]``
   and any added token) are cut out of the raw text, leftmost and longest
   first;
2. each piece between them is normalised (``BertNormalizer``): control and
   format characters, NUL and U+FFFD dropped, whitespace mapped to a
   space; spaces put around CJK ideographs; accents stripped (NFD, then
   nonspacing marks dropped) and the text lowercased where the
   configuration says so;
3. split on whitespace and around each punctuation character
   (``BertPreTokenizer``);
4. each word is matched greedily, longest prefix first, its continuations
   prefixed with ``##``; a word with an unmatched rest, or of more than
   100 characters, becomes ``[UNK]``;
5. the ids are wrapped in ``[CLS] ... [SEP]``.

The character classes are :mod:`unicodedata`'s, corrected where the Rust
library's tables differ: its categories follow an older Unicode version
(the ``_FORMAT_KEPT``, ``_PUNCT_*``, ``_MARK_*`` and ``_NFD_KEPT`` code
points), its lowercasing a newer one (``_LOWER_EXTRA``), its CJK ranges
hold U+2B920 where BERT's paper code holds U+2B820, and it lowercases
character by character (no final-sigma rule). The exception tables are
the differences against ``unicodedata`` of Unicode ``UNIDATA_VERSION``;
:func:`load` raises under a Python with another Unicode database, whose
ids could differ. ``tests/test_torch_etl_wordpiece.py`` sweeps every code
point against the installed ``tokenizers``; rerun that sweep to take the
tables anew.

Files whose tokenizer is not this one (another ``model.type``, normaliser
or pre-tokenizer in ``tokenizer.json``) raise ``ValueError`` naming it.
"""

from __future__ import annotations

import functools
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional

from mrgcn_tpu_torch.utils.hf import read_json, token_content


# the Unicode database (``unicodedata.unidata_version``) that the exception
# tables below correct
UNIDATA_VERSION = "15.0.0"


def _ranges(*pairs) -> frozenset:
    return frozenset(c for lo, hi in pairs for c in range(lo, hi + 1))


# format characters (Cf) the Rust tables do not know: kept, not dropped
_FORMAT_KEPT = _ranges(
    (0x890, 0x891), (0x8E2, 0x8E2), (0x110CD, 0x110CD), (0x13430, 0x1343F))
# punctuation by the Rust tables and not by unicodedata, and the reverse
_PUNCT_EXTRA = _ranges((0x166D, 0x166D), (0x111C9, 0x111C9))
_PUNCT_NOT = _ranges(
    (0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77),
    (0xC84, 0xC84), (0x1B7D, 0x1B7E), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D),
    (0x10EAD, 0x10EAD), (0x10F55, 0x10F59), (0x10F86, 0x10F89),
    (0x1144B, 0x1144F), (0x1145A, 0x1145B), (0x1145D, 0x1145D),
    (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B),
    (0x11944, 0x11946), (0x119E2, 0x119E2), (0x11A3F, 0x11A46),
    (0x11A9A, 0x11A9C), (0x11A9E, 0x11AA2), (0x11B00, 0x11B09),
    (0x11C41, 0x11C45), (0x11C70, 0x11C71), (0x11EF7, 0x11EF8),
    (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2),
    (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F))
# nonspacing marks (Mn) the Rust tables do not know: kept by the accent
# strip; and one spacing mark they take for nonspacing
_MARK_KEPT = _ranges(
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8E1), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C),
    (0xD00, 0xD00), (0xD3B, 0xD3C), (0xD81, 0xD81), (0xEBA, 0xEBA),
    (0xECE, 0xECE), (0x180F, 0x180F), (0x1885, 0x1886), (0x1ABF, 0x1ACE),
    (0x1DF6, 0x1DFB), (0xA82C, 0xA82C), (0xA8C5, 0xA8C5), (0xA8FF, 0xA8FF),
    (0xA9BD, 0xA9BD), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC),
    (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85),
    (0x11070, 0x11070), (0x11073, 0x11074), (0x110C2, 0x110C2),
    (0x111C9, 0x111C9), (0x111CF, 0x111CF), (0x1123E, 0x1123E),
    (0x11241, 0x11241), (0x1133B, 0x1133B), (0x11438, 0x1143F),
    (0x11442, 0x11444), (0x11446, 0x11446), (0x1145E, 0x1145E),
    (0x1182F, 0x11837), (0x11839, 0x1183A), (0x1193B, 0x1193C),
    (0x1193E, 0x1193E), (0x11943, 0x11943), (0x119D4, 0x119D7),
    (0x119DA, 0x119DB), (0x119E0, 0x119E0), (0x11A01, 0x11A0A),
    (0x11A33, 0x11A38), (0x11A3B, 0x11A3E), (0x11A47, 0x11A47),
    (0x11A51, 0x11A56), (0x11A59, 0x11A5B), (0x11A8A, 0x11A96),
    (0x11A98, 0x11A99), (0x11C30, 0x11C36), (0x11C38, 0x11C3D),
    (0x11C3F, 0x11C3F), (0x11C92, 0x11CA7), (0x11CAA, 0x11CB0),
    (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6), (0x11D31, 0x11D36),
    (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45),
    (0x11D47, 0x11D47), (0x11D90, 0x11D91), (0x11D95, 0x11D95),
    (0x11D97, 0x11D97), (0x11EF3, 0x11EF4), (0x11F00, 0x11F01),
    (0x11F36, 0x11F3A), (0x11F40, 0x11F40), (0x11F42, 0x11F42),
    (0x13440, 0x13440), (0x13447, 0x13455), (0x16F4F, 0x16F4F),
    (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46),
    (0x1E000, 0x1E006), (0x1E008, 0x1E018), (0x1E01B, 0x1E021),
    (0x1E023, 0x1E024), (0x1E026, 0x1E02A), (0x1E08F, 0x1E08F),
    (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF),
    (0x1E4EC, 0x1E4EF), (0x1E944, 0x1E94A))
_MARK_STRIPPED = _ranges((0x1734, 0x1734))
# a character the Rust normaliser does not decompose
_NFD_KEPT = "\U00011938"
# lowercase mappings of characters newer than unicodedata's version
_LOWER_EXTRA = {
    **{chr(c): chr(c + 0x20) for c in range(0x10D50, 0x10D66)},
    **{chr(c): chr(c + 0x1B) for c in range(0x16EA0, 0x16EB9)},
    **{chr(a): chr(b) for a, b in (
        (0x1C89, 0x1C8A), (0xA7CB, 0x264), (0xA7CC, 0xA7CD),
        (0xA7CE, 0xA7CF), (0xA7D2, 0xA7D3), (0xA7D4, 0xA7D5),
        (0xA7DA, 0xA7DB), (0xA7DC, 0x19B))}}
# Rust's char::is_whitespace (the White_Space property)
WHITE_SPACE = frozenset(map(chr, (*range(0x09, 0x0E), 0x20, 0x85, 0xA0,
                                  0x1680, *range(0x2000, 0x200B), 0x2028,
                                  0x2029, 0x202F, 0x205F, 0x3000)))
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")

SPECIAL_TOKENS = ("unk_token", "sep_token", "pad_token", "cls_token",
                  "mask_token")
DEFAULT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]",
                    "pad_token": "[PAD]", "cls_token": "[CLS]",
                    "mask_token": "[MASK]"}
# tokenizer classes (``tokenizer_config.json``) and model types
# (``config.json``) whose AutoTokenizer is the fast BERT tokenizer
WORDPIECE_CLASSES = ("BertTokenizer", "DistilBertTokenizer")
WORDPIECE_MODEL_TYPES = ("bert", "distilbert")


@functools.lru_cache(maxsize=None)
def _char_class(c: str) -> str:
    """``drop`` (cleaned away), ``space`` (whitespace), ``cjk``, ``punct``
    or ``word``: the class of ``c`` for the normaliser and the
    pre-tokenizer."""
    cp = ord(c)
    if c in "\t\n\r":
        return "space"
    category = unicodedata.category(c)
    if cp in (0, 0xFFFD) or (category in ("Cc", "Cf", "Co", "Cs")
                             and cp not in _FORMAT_KEPT):
        return "drop"
    if c in WHITE_SPACE:
        return "space"
    if any(lo <= cp <= hi for lo, hi in _CJK):
        return "cjk"
    if cp in _PUNCT_EXTRA or (cp not in _PUNCT_NOT and (
            c in _ASCII_PUNCT or category.startswith("P"))):
        return "punct"
    return "word"


def _is_stripped_mark(c: str) -> bool:
    cp = ord(c)
    if cp in _MARK_STRIPPED:
        return True
    return unicodedata.category(c) == "Mn" and cp not in _MARK_KEPT


def _strip_accents(text: str) -> str:
    parts = re.split(f"([{_NFD_KEPT}])", text)
    text = "".join(p if p == _NFD_KEPT else unicodedata.normalize("NFD", p)
                   for p in parts)
    return "".join(c for c in text if not _is_stripped_mark(c))


def read_vocab_txt(path: Path) -> Dict[str, int]:
    """``vocab.txt`` as transformers reads it: one token a line (universal
    newlines), the last of equal lines keeping its id."""
    lines = path.read_text(encoding="utf-8").split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return {token: i for i, token in enumerate(lines)}


class WordPieceTokenizer:
    """The fast BERT tokenizer's ``encode`` (see the module docstring).

    ``vocab`` maps the word pieces to ids; ``specials`` the special and
    added tokens (``cls_token`` and ``sep_token`` among them) to theirs;
    ``lowercase``, ``strip_accents`` (None: as ``lowercase``),
    ``handle_chinese_chars`` and ``clean_text`` are ``BertNormalizer``'s
    settings."""

    def __init__(self, vocab: Dict[str, int], specials: Dict[str, int],
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", lowercase: bool = False,
                 strip_accents: Optional[bool] = None,
                 handle_chinese_chars: bool = True, clean_text: bool = True,
                 max_input_chars_per_word: int = 100,
                 continuing_subword_prefix: str = "##"):
        if unk_token not in vocab:
            raise ValueError(f"WordPiece vocabulary lacks its unknown "
                             f"token {unk_token!r}")
        self.vocab = vocab
        self.specials = specials
        self.unk_id = vocab[unk_token]
        self.cls_id = specials[cls_token]
        self.sep_id = specials[sep_token]
        self.lowercase = lowercase
        self.strip_accents = lowercase if strip_accents is None \
            else strip_accents
        self.handle_chinese_chars = handle_chinese_chars
        self.clean_text = clean_text
        self.max_chars = max_input_chars_per_word
        self.prefix = continuing_subword_prefix
        # leftmost-longest: at each position the longest token first
        tokens = sorted(specials, key=len, reverse=True)
        self._special_re = re.compile("|".join(map(re.escape, tokens)))

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        text.encode("utf-8")  # a lone surrogate raises, as in Rust
        ids: List[int] = []
        pos = 0
        for m in self._special_re.finditer(text):
            ids += self._encode_piece(text[pos:m.start()])
            ids.append(self.specials[m.group()])
            pos = m.end()
        ids += self._encode_piece(text[pos:])
        if add_special_tokens:
            return [self.cls_id] + ids + [self.sep_id]
        return ids

    def normalize(self, text: str) -> str:
        if self.clean_text:
            text = "".join(" " if _char_class(c) == "space" else c
                           for c in text if _char_class(c) != "drop")
        if self.handle_chinese_chars:
            text = "".join(f" {c} " if _char_class(c) == "cjk" else c
                           for c in text)
        if self.strip_accents:
            text = _strip_accents(text)
        if self.lowercase:
            text = "".join(_LOWER_EXTRA.get(c) or c.lower() for c in text)
        return text

    def pre_tokenize(self, text: str) -> List[str]:
        words: List[str] = []
        word: List[str] = []
        for c in text:
            if c in WHITE_SPACE or _char_class(c) == "punct":
                if word:
                    words.append("".join(word))
                    word = []
                if c not in WHITE_SPACE:
                    words.append(c)
            else:
                word.append(c)
        if word:
            words.append("".join(word))
        return words

    def _encode_piece(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self.pre_tokenize(self.normalize(text)):
            ids += self._word_ids(word)
        return ids

    def _word_ids(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        out: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 \
                    else self.prefix + word[start:end]
                if piece in self.vocab:
                    out.append(self.vocab[piece])
                    break
                end -= 1
            else:
                return [self.unk_id]
            start = end
        return out


def _check_added(token: Dict) -> None:
    flags = [k for k in ("lstrip", "rstrip", "single_word", "normalized")
             if token.get(k)]
    if flags:
        raise ValueError(f"added token {token.get('content')!r} with "
                         f"{', '.join(flags)} is not implemented by the "
                         f"port's WordPiece tokenizer")


def load(directory: Path) -> Optional[WordPieceTokenizer]:
    """The tokenizer of the snapshot ``directory`` (a BERT-family one:
    ``string.tokenizer_module`` picks this module) as ``AutoTokenizer``
    builds it, or None where it holds no vocabulary (``tokenizer.json`` or
    ``vocab.txt``). Raises ``ValueError`` naming the kind where
    ``tokenizer.json`` describes a tokenizer other than BERT's WordPiece,
    and ``RuntimeError`` where this Python's Unicode database is not
    ``UNIDATA_VERSION``."""
    tok_cfg = read_json(directory / "tokenizer_config.json")
    has_json = (directory / "tokenizer.json").is_file()
    if not has_json and not (directory / "vocab.txt").is_file():
        return None

    names = {k: token_content(tok_cfg.get(k, v))
             for k, v in DEFAULT_SPECIALS.items()}
    added: Dict[str, int] = {}
    for token_id, token in tok_cfg.get("added_tokens_decoder", {}).items():
        _check_added(token)
        added[token["content"]] = int(token_id)
    clean_text = True
    prefix, max_chars = "##", 100
    if has_json:
        spec = read_json(directory / "tokenizer.json")
        model = spec.get("model") or {}
        if model.get("type") != "WordPiece":
            raise ValueError(f"tokenizer.json of model type "
                             f"{model.get('type')!r} in {directory}: only "
                             f"BERT's WordPiece tokenizer is ported")
        for part, kind in (("normalizer", "BertNormalizer"),
                           ("pre_tokenizer", "BertPreTokenizer")):
            got = (spec.get(part) or {}).get("type")
            if got != kind:
                raise ValueError(f"tokenizer.json {part} {got!r} in "
                                 f"{directory}: only {kind} is ported")
        post = (spec.get("post_processor") or {}).get("type")
        if post not in ("TemplateProcessing", "BertProcessing"):
            raise ValueError(f"tokenizer.json post_processor {post!r} in "
                             f"{directory}: only BERT's [CLS] ... [SEP] "
                             f"is ported")
        clean_text = spec["normalizer"].get("clean_text", True)
        vocab = dict(model["vocab"])
        prefix = model.get("continuing_subword_prefix", prefix)
        max_chars = model.get("max_input_chars_per_word", max_chars)
        for token in spec.get("added_tokens", []):
            _check_added(token)
            added[token["content"]] = token["id"]
    else:
        vocab = read_vocab_txt(directory / "vocab.txt")
    if unicodedata.unidata_version != UNIDATA_VERSION:
        raise RuntimeError(
            f"the WordPiece character tables correct Unicode "
            f"{UNIDATA_VERSION}, and this Python's unicodedata is "
            f"{unicodedata.unidata_version}: the ids could differ from "
            f"AutoTokenizer's; take the tables anew")
    # the special tokens are matched in the raw text; one missing from the
    # vocabulary takes the next free id, in transformers' order
    next_id = len(vocab) + len(added)
    for key in SPECIAL_TOKENS:
        token = names[key]
        if token not in added:
            if token in vocab:
                added[token] = vocab[token]
            else:
                added[token] = next_id
                next_id += 1
    return WordPieceTokenizer(
        vocab, added, unk_token=names["unk_token"],
        cls_token=names["cls_token"], sep_token=names["sep_token"],
        lowercase=tok_cfg.get("do_lower_case", True),
        strip_accents=tok_cfg.get("strip_accents"),
        handle_chinese_chars=tok_cfg.get("tokenize_chinese_chars", True),
        clean_text=clean_text, max_input_chars_per_word=max_chars,
        continuing_subword_prefix=prefix)
