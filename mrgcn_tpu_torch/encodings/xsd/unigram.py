"""SentencePiece's Unigram tokenizer (XLM-R's, ALBERT's) in plain Python,
without transformers or ``tokenizers``.

The string vectorizer's tokenizer where the feature's configured
HuggingFace tokenizer is an XLM-R or ALBERT snapshot on disk with its
``tokenizer.json``. :meth:`UnigramTokenizer.encode` gives the ids of the
JAX package's ``AutoTokenizer.from_pretrained(name).encode(text,
add_special_tokens=True)``, which is the fast tokenizer of the Rust
``tokenizers`` library built from that file:

1. added tokens that are not normalized (the special ones) are cut out of
   the raw text, leftmost and longest first, ``lstrip`` / ``rstrip``
   taking the whitespace beside them (the mask token has ``lstrip``, as
   in :mod:`.bpe`, unless ``tokenizer_config.json`` gives it as a dict:
   then ``tokenizer.json``'s flags hold);
2. each piece between them goes through the normalizer (``Sequence`` of
   ``Precompiled`` (:mod:`.charsmap`), ``Replace`` of a string or a
   regular expression, ``NFKD``, ``NFKC``, ``StripAccents``,
   ``Lowercase``, ``Strip``), then normalized added
   tokens are cut out of it; empty pieces are dropped;
3. ``Metaspace``: spaces become ``▁``, a ``▁`` is put first
   (``prepend_scheme`` ``always``; ``first``: only on the piece that
   starts the text; ``never``), and the piece is split before each ``▁``
   where ``split`` is set;
4. each word is cut by the Unigram model's Viterbi path over the pieces
   of the vocabulary (scores added in float64, a tie kept by the path
   found first: the one whose last piece starts earliest); a character
   that no one-character piece covers is unknown, scored the vocabulary's
   least score less 10, and unknowns in a row are fused into one token
   (the id of that text where the vocabulary has it, else the unknown
   piece's);
5. the ids are wrapped by the post-processor (``TemplateProcessing``'s
   single template or ``RobertaProcessing``).

The character tables (Unicode normalization, accents, lowercasing,
grapheme clusters) are :mod:`unicodedata`'s, corrected where the Rust
library's differ: its NFKD and NFKC leave the compatibility characters
of ``_COMPAT_KEPT`` (newer than its tables) as they are, its NFKD
U+11938 too;
its accent strip keeps the marks of ``_MARKS_KEPT`` and strips the
letters of ``_MARKS_EXTRA``; lowercasing is
:mod:`.wordpiece`'s (character by character, no final sigma).
:func:`load` raises under a Python with another Unicode database.
``tests/test_torch_etl_unigram.py`` sweeps every code point through each
normalizer against the installed ``tokenizers``; rerun that sweep to take
the tables anew.

Files this does not read raise ``ValueError`` naming what: another model
or pre-tokenizer, a normalizer or post-processor not listed above,
``byte_fallback``, a ``single_word`` added token; a Unigram snapshot
with ``spiece.model`` and no ``tokenizer.json``.
"""

from __future__ import annotations

import base64
import re
import unicodedata
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mrgcn_tpu_torch.encodings.xsd import graphemes
from mrgcn_tpu_torch.encodings.xsd.bpe import (AddedToken, _flags,
                                               added_pattern,
                                               resolve_specials, split_added)
from mrgcn_tpu_torch.encodings.xsd.charsmap import Charsmap
from mrgcn_tpu_torch.encodings.xsd.wordpiece import _LOWER_EXTRA, WHITE_SPACE
from mrgcn_tpu_torch.utils.hf import read_json

# the Unicode database (``unicodedata.unidata_version``) that the tables
# below correct
UNIDATA_VERSION = "15.0.0"


def _ranges(*pairs) -> frozenset:
    return frozenset(c for lo, hi in pairs for c in range(lo, hi + 1))


# compatibility characters the Rust library's NFKD and NFKC keep
_COMPAT_KEPT = _ranges(
    (0x32FF, 0x32FF), (0xA7F2, 0xA7F4), (0xAB69, 0xAB69),
    (0x10781, 0x10785), (0x10787, 0x107B0), (0x107B2, 0x107BA),
    (0x1E030, 0x1E06D), (0x1F16C, 0x1F16C), (0x1FBF0, 0x1FBF9))
# and the character its NFKD does not decompose
_DECOMPOSED_KEPT = _ranges((0x11938, 0x11938))
# marks (Mn, Mc, Me) the Rust library's accent strip keeps
_MARKS_KEPT = _ranges(
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C),
    (0xCF3, 0xCF3), (0xD00, 0xD00), (0xD3B, 0xD3C), (0xD81, 0xD81),
    (0xEBA, 0xEBA), (0xECE, 0xECE), (0x1715, 0x1715), (0x180F, 0x180F),
    (0x1ABF, 0x1ACE), (0x1CF7, 0x1CF7), (0x1DF6, 0x1DFA),
    (0xA82C, 0xA82C), (0xA8FF, 0xA8FF), (0x10D24, 0x10D27),
    (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF), (0x10F46, 0x10F50),
    (0x10F82, 0x10F85), (0x11070, 0x11070), (0x11073, 0x11074),
    (0x110C2, 0x110C2), (0x11145, 0x11146), (0x111C9, 0x111C9),
    (0x111CE, 0x111CF), (0x11241, 0x11241), (0x1133B, 0x1133B),
    (0x1145E, 0x1145E), (0x1182C, 0x1183A), (0x11930, 0x11935),
    (0x11937, 0x11938), (0x1193B, 0x1193E), (0x11940, 0x11940),
    (0x11942, 0x11943), (0x119D1, 0x119D7), (0x119DA, 0x119E0),
    (0x119E4, 0x119E4), (0x11A01, 0x11A0A), (0x11A33, 0x11A39),
    (0x11A3B, 0x11A3E), (0x11A47, 0x11A47), (0x11A51, 0x11A5B),
    (0x11A8A, 0x11A99), (0x11D31, 0x11D36), (0x11D3A, 0x11D3A),
    (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45), (0x11D47, 0x11D47),
    (0x11D8A, 0x11D8E), (0x11D90, 0x11D91), (0x11D93, 0x11D97),
    (0x11EF3, 0x11EF6), (0x11F00, 0x11F01), (0x11F03, 0x11F03),
    (0x11F34, 0x11F3A), (0x11F3E, 0x11F42), (0x13440, 0x13440),
    (0x13447, 0x13455), (0x16F4F, 0x16F4F), (0x16F7F, 0x16F87),
    (0x16FE4, 0x16FE4), (0x16FF0, 0x16FF1), (0x1CF00, 0x1CF2D),
    (0x1CF30, 0x1CF46), (0x1E08F, 0x1E08F), (0x1E130, 0x1E136),
    (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF))
# and letters (Lo) it takes for marks and strips
_MARKS_EXTRA = _ranges((0x1CF2, 0x1CF3))
# what the Viterbi path pays for an unknown character, below the least
# score of the vocabulary
UNK_PENALTY = 10.0

# tokenizer classes (``tokenizer_config.json``) and model types
# (``config.json``) whose AutoTokenizer is a fast Unigram tokenizer, and
# their special tokens (the classes' defaults)
CLASS_TYPES = {"XLMRobertaTokenizer": "xlm-roberta",
               "AlbertTokenizer": "albert"}
UNIGRAM_CLASSES = tuple(CLASS_TYPES)
UNIGRAM_MODEL_TYPES = tuple(CLASS_TYPES.values())
DEFAULT_SPECIALS = {
    "xlm-roberta": {"bos_token": "<s>", "eos_token": "</s>",
                    "sep_token": "</s>", "cls_token": "<s>",
                    "unk_token": "<unk>", "pad_token": "<pad>",
                    "mask_token": "<mask>"},
    "albert": {"bos_token": "[CLS]", "eos_token": "[SEP]",
               "sep_token": "[SEP]", "cls_token": "[CLS]",
               "unk_token": "<unk>", "pad_token": "<pad>",
               "mask_token": "[MASK]"}}
# the files a snapshot may hold for its tokenizer: the one read here, and
# those that name a tokenizer without it
TOKENIZER_FILES = ("tokenizer.json", "spiece.model",
                   "sentencepiece.bpe.model", "vocab.txt", "vocab.json")


def _kept_apart(form: str, kept: frozenset) -> Callable[[str], str]:
    """Unicode normalization ``form`` that leaves the code points of
    ``kept`` as they are (they start and end no composition)."""
    cut = re.compile("([" + "".join(f"\\U{c:08x}" for c in sorted(kept))
                     + "])")

    def normalize(text: str) -> str:
        parts = cut.split(text)
        return "".join(p if i % 2 else unicodedata.normalize(form, p)
                       for i, p in enumerate(parts))
    return normalize


def _strip_accents(text: str) -> str:
    return "".join(c for c in text if ord(c) in _MARKS_KEPT or (
        unicodedata.category(c) not in ("Mn", "Mc", "Me")
        and ord(c) not in _MARKS_EXTRA))


def _lowercase(text: str) -> str:
    return "".join(_LOWER_EXTRA.get(c) or c.lower() for c in text)


def _strip(left: bool, right: bool) -> Callable[[str], str]:
    spaces = "".join(sorted(WHITE_SPACE))

    def strip(text: str) -> str:
        if left:
            text = text.lstrip(spaces)
        if right:
            text = text.rstrip(spaces)
        return text
    return strip


def _replace(spec: Dict, where: Path) -> Callable[[str], str]:
    pattern, content = spec["pattern"], spec["content"]
    if "String" in pattern:
        old = pattern["String"]
        return lambda text: text.replace(old, content) if old else text
    if "Regex" in pattern:
        regex = re.compile(pattern["Regex"])
        return lambda text: regex.sub(lambda _: content, text)
    raise ValueError(f"tokenizer.json Replace pattern {pattern!r} in "
                     f"{where}: the port reads String and Regex")


def normalizer(spec: Optional[Dict], where: Path) -> Callable[[str], str]:
    """The function of a ``tokenizer.json`` normalizer (see the module
    docstring); raises ``ValueError`` naming another kind."""
    if spec is None:
        return lambda text: text
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [normalizer(s, where) for s in spec["normalizers"]]

        def sequence(text: str) -> str:
            for step in steps:
                text = step(text)
            return text
        return sequence
    if kind == "Precompiled":
        raw = spec.get("precompiled_charsmap")
        if not raw:
            raise ValueError(f"tokenizer.json Precompiled normalizer in "
                             f"{where} without a charsmap")
        return Charsmap(base64.b64decode(raw)).normalize
    if kind == "Replace":
        return _replace(spec, where)
    if kind == "NFKD":
        return _kept_apart(kind, _DECOMPOSED_KEPT | _COMPAT_KEPT)
    if kind == "NFKC":
        return _kept_apart(kind, _COMPAT_KEPT)
    if kind == "StripAccents":
        return _strip_accents
    if kind == "Lowercase":
        return _lowercase
    if kind == "Strip":
        return _strip(bool(spec.get("strip_left", True)),
                      bool(spec.get("strip_right", True)))
    raise ValueError(f"tokenizer.json normalizer {kind!r} in {where} is "
                     f"not ported (the port's Unigram reads Sequence, "
                     f"Precompiled, Replace, NFKD, NFKC, StripAccents, "
                     f"Lowercase, Strip)")


class UnigramTokenizer:
    """The fast Unigram tokenizer's ``encode`` (see the module docstring).

    ``vocab``: ``(piece, score)`` pairs in id order; ``unk_id`` the
    unknown piece's id; ``added`` the added tokens; ``normalize`` the
    normalizer's function; ``replacement``, ``prepend_scheme`` and
    ``split`` the ``Metaspace`` pre-tokenizer's; ``template`` the ids
    around a sequence ``(before, after)`` (None: nothing)."""

    def __init__(self, vocab: Sequence[Tuple[str, float]], unk_id: int,
                 added: Sequence[AddedToken],
                 normalize: Callable[[str], str] = lambda text: text,
                 replacement: str = "▁", prepend_scheme: str = "always",
                 split: bool = True,
                 template: Optional[Tuple[List[int], List[int]]] = None):
        if not vocab:
            raise ValueError("Unigram vocabulary is empty")
        if not 0 <= unk_id < len(vocab):
            raise ValueError(f"Unigram unk_id {unk_id} outside the "
                             f"vocabulary of {len(vocab)}")
        # a piece listed twice keeps its last id and that id's score
        self.ids = {piece: i for i, (piece, _) in enumerate(vocab)}
        self.scores = [float(score) for _, score in vocab]
        self.unk_id = unk_id
        self.unk_score = min(self.scores) - UNK_PENALTY
        self.prefixes = {piece[:k] for piece in self.ids
                         for k in range(1, len(piece) + 1)}
        self.added = list(added)
        self.normalize = normalize
        self.raw_pass = added_pattern(
            [t for t in self.added if not t.normalized])
        normalized = [AddedToken(normalize(t.content), t.id, t.lstrip,
                                 t.rstrip, True)
                      for t in self.added if t.normalized]
        self.normalized_pass = added_pattern(normalized)
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme
        self.split = split
        self.template = template
        self._words: Dict[str, List[int]] = {}

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        text.encode("utf-8")  # a lone surrogate raises, as in Rust
        ids: List[int] = []
        start = 0
        raw = split_added(text, *self.raw_pass) if self.raw_pass \
            else [(text, None)]
        for piece, token_id in raw:
            first = start == 0
            start += len(piece)
            if token_id is not None:
                ids.append(token_id)
                continue
            normalized = self.normalize(piece)
            parts = split_added(normalized, *self.normalized_pass) \
                if self.normalized_pass else [(normalized, None)]
            for part, part_id in parts:
                if part_id is not None:
                    ids.append(part_id)
                elif part:
                    ids += self._encode_piece(part, first)
                first = False
        if add_special_tokens and self.template:
            return self.template[0] + ids + self.template[1]
        return ids

    def pre_tokenize(self, text: str, first: bool = True) -> List[str]:
        """``Metaspace``'s words of a normalized piece (``first``: the
        piece starts the text)."""
        text = text.replace(" ", self.replacement)
        if text and not text.startswith(self.replacement) and (
                self.prepend_scheme == "always"
                or self.prepend_scheme == "first" and first):
            text = self.replacement + text
        if not self.split:
            return [text] if text else []
        return [w for w in re.split(f"(?={re.escape(self.replacement)})",
                                    text) if w]

    def _encode_piece(self, text: str, first: bool) -> List[int]:
        ids: List[int] = []
        for word in self.pre_tokenize(text, first):
            cached = self._words.get(word)
            if cached is None:
                cached = self.encode_word(word)
                if len(self._words) < (1 << 16):
                    self._words[word] = cached
            ids += cached
        return ids

    def encode_word(self, word: str) -> List[int]:
        """The ids of the Viterbi path over ``word`` (Rust's
        ``Unigram::encode_optimized``, by characters)."""
        n = len(word)
        ids, scores, prefixes = self.ids, self.scores, self.prefixes
        best = [0.0] * (n + 1)
        origin = [-1] * (n + 1)         # -1: not reached yet
        piece_id = [0] * (n + 1)
        for start in range(n):
            here = best[start]
            single = False
            for end in range(start + 1, n + 1):
                piece = word[start:end]
                if piece not in prefixes:
                    break
                i = ids.get(piece)
                if i is None:
                    continue
                score = scores[i] + here
                if origin[end] < 0 or score > best[end]:
                    best[end], origin[end], piece_id[end] = score, start, i
                if end == start + 1:
                    single = True
            if not single:
                score = self.unk_score + here
                end = start + 1
                if origin[end] < 0 or score > best[end]:
                    best[end], origin[end], piece_id[end] = \
                        score, start, self.unk_id
        pieces: List[str] = []
        unknown: List[str] = []
        end = n
        while end > 0:
            start = origin[end]
            if piece_id[end] == self.unk_id:
                unknown.append(word[start:end])
            else:
                if unknown:
                    pieces.append("".join(reversed(unknown)))
                    unknown = []
                pieces.append(word[start:end])
            end = start
        if unknown:
            pieces.append("".join(reversed(unknown)))
        return [ids.get(p, self.unk_id) for p in reversed(pieces)]


def _template(post: Optional[Dict], where: Path
              ) -> Optional[Tuple[List[int], List[int]]]:
    if post is None:
        return None
    kind = post.get("type")
    if kind == "RobertaProcessing":
        return [post["cls"][1]], [post["sep"][1]]
    if kind == "TemplateProcessing":
        specials = post.get("special_tokens", {})
        out: Tuple[List[int], List[int]] = ([], [])
        seen = False
        for item in post["single"]:
            if "Sequence" in item:
                seen = True
            else:
                name = item["SpecialToken"]["id"]
                out[seen].extend(specials[name]["ids"])
        return out
    raise ValueError(f"tokenizer.json post_processor {kind!r} in {where}: "
                     f"the port's Unigram reads TemplateProcessing and "
                     f"RobertaProcessing")


def _metaspace(spec: Optional[Dict], where: Path) -> Dict:
    kind = (spec or {}).get("type")
    if kind != "Metaspace":
        raise ValueError(f"tokenizer.json Unigram pre_tokenizer {kind!r} "
                         f"in {where}: the port reads Metaspace")
    scheme = spec.get("prepend_scheme", "always")
    if scheme not in ("always", "first", "never"):
        raise ValueError(f"tokenizer.json Metaspace prepend_scheme "
                         f"{scheme!r} in {where}")
    if spec.get("add_prefix_space") is False and scheme != "never":
        raise ValueError(f"tokenizer.json Metaspace in {where}: "
                         f"add_prefix_space does not match prepend_scheme "
                         f"{scheme!r}")
    if "prepend_scheme" not in spec and spec.get("add_prefix_space") \
            is False:
        scheme = "never"
    return {"replacement": spec.get("replacement", "▁"),
            "prepend_scheme": scheme,
            "split": bool(spec.get("split", True))}


def load(directory: Path) -> Optional[UnigramTokenizer]:
    """The tokenizer of the snapshot ``directory`` (an XLM-R or ALBERT one:
    ``string.tokenizer_module`` picks this module) as ``AutoTokenizer``
    builds it from ``tokenizer.json``, or None where it holds no
    tokenizer file. Raises ``ValueError`` naming what the port does not
    read (``spiece.model`` without ``tokenizer.json`` among it), and
    ``RuntimeError`` where this Python's Unicode database is not
    ``UNIDATA_VERSION``."""
    directory = Path(directory)
    tok_cfg = read_json(directory / "tokenizer_config.json")
    cls_name = (tok_cfg.get("tokenizer_class") or "").removesuffix("Fast")
    model_type = CLASS_TYPES.get(cls_name) or read_json(
        directory / "config.json").get("model_type", "xlm-roberta")
    if not (directory / "tokenizer.json").is_file():
        present = [name for name in TOKENIZER_FILES
                   if (directory / name).is_file()]
        if not present:
            return None
        raise ValueError(
            f"{model_type} tokenizer in {directory} with "
            f"{', '.join(present)} and no tokenizer.json: the port reads "
            f"a Unigram tokenizer from tokenizer.json (transformers' "
            f"save_pretrained writes it)")
    spec = read_json(directory / "tokenizer.json")
    model = spec.get("model") or {}
    if model.get("type") != "Unigram":
        raise ValueError(f"tokenizer.json of model type "
                         f"{model.get('type')!r} in {directory}: the "
                         f"port's Unigram reader takes Unigram")
    if model.get("byte_fallback"):
        raise ValueError(f"tokenizer.json Unigram byte_fallback in "
                         f"{directory} is not ported")
    vocab = [(str(piece), float(score)) for piece, score in model["vocab"]]
    unk_id = model.get("unk_id")
    if unk_id is None:
        raise ValueError(f"tokenizer.json Unigram in {directory} has no "
                         f"unk_id")
    added: Dict[str, AddedToken] = {}
    for token in spec.get("added_tokens", []):
        added[token["content"]] = AddedToken(
            token["content"], token["id"],
            **_flags(token, "tokenizer.json", "Unigram"))
    ids = {piece: i for i, (piece, _) in enumerate(vocab)}
    resolve_specials(added, tok_cfg, ids,
                     DEFAULT_SPECIALS.get(model_type,
                                          DEFAULT_SPECIALS["xlm-roberta"]),
                     "Unigram", file_tokens=frozenset(added))
    normalize = normalizer(spec.get("normalizer"), directory)
    metaspace = _metaspace(spec.get("pre_tokenizer"), directory)
    template = _template(spec.get("post_processor"), directory)
    if unicodedata.unidata_version != UNIDATA_VERSION \
            or graphemes.UNIDATA_VERSION != UNIDATA_VERSION:
        raise RuntimeError(
            f"the Unigram tokenizer's character tables correct Unicode "
            f"{UNIDATA_VERSION}, and this Python's unicodedata is "
            f"{unicodedata.unidata_version}: the ids could differ from "
            f"AutoTokenizer's; take the tables anew")
    return UnigramTokenizer(vocab, int(unk_id), added.values(), normalize,
                            template=template, **metaspace)
