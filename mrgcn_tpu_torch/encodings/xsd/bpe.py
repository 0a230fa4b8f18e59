"""RoBERTa's and BLOOM's byte-level BPE tokenizers in plain Python,
without transformers.

The string vectorizer's tokenizer where the feature's configured
HuggingFace tokenizer is a RoBERTa snapshot on disk (``tokenizer.json``,
or ``vocab.json`` and ``merges.txt``) or a BLOOM one (``tokenizer.json``
only: BLOOM has no slow tokenizer). :meth:`ByteLevelBPE.encode` gives
the ids of the JAX package's ``AutoTokenizer.from_pretrained(name)
.encode(text, add_special_tokens=True)``, which is the fast RoBERTa (or
BLOOM) tokenizer of the Rust ``tokenizers`` library:

1. added tokens (``<s>``, ``<pad>``, ``</s>``, ``<unk>``, ``<mask>`` and
   any other) are cut out of the raw text, leftmost and longest first,
   those matched before normalisation in a first pass and the others in a
   second (there is no normaliser, so only the order differs); a token
   with ``lstrip`` takes the whitespace before it, one with ``rstrip``
   the whitespace after it (``<mask>`` has ``lstrip``);
2. each piece between them gets a leading space where ``add_prefix_space``
   is set and it has none, and is split by GPT-2's pattern
   ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|
   \\s+(?!\\S)|\\s+`` (``ByteLevel``), as Oniguruma matches it: alternatives
   in order, ``\\s`` the White_Space property (not ``str.isspace``:
   U+001C-U+001F are not spaces here);
3. each part's UTF-8 bytes are mapped to GPT-2's 256 printable symbols
   (:func:`byte_symbols`) and merged pair by pair, the pair of lowest
   rank first and of equal ranks the leftmost, as the Rust library's
   ``Word::merge_all`` does;
4. the ids are wrapped in ``<s> ... </s>`` (``RobertaProcessing``).

BLOOM's ``tokenizer.json`` differs in its pre-tokenizer and its
post-processor: a ``Sequence`` of a ``Split`` on ``BLOOM_SPLIT`` (in
Oniguruma the class nested in the negated class is a union: a piece is
an optional space and a run of anything but White_Space, ``(``, ``|``,
``)`` and ``.,!?…。，、।۔،``), ``Isolated`` (the stretches between
matches are pieces too), then ``ByteLevel`` without its regex (each
piece whole is one part of step 3); its ``ByteLevel`` post-processor
adds no ids. Its specials are ``<unk> <s> </s> <pad>`` (``BLOOM_SPECIALS``,
``BloomTokenizerFast``'s defaults).

The pattern is Python's ``re`` over explicit character classes taken from
:mod:`unicodedata`, corrected where Oniguruma's tables are newer: the
code points that Unicode ``UNIDATA_VERSION`` leaves unassigned and
Oniguruma takes for letters (``_LETTERS_EXTRA``) or numbers
(``_NUMBERS_EXTRA``). :func:`load` raises under a Python with another
Unicode database, whose ids could differ. ``tests/test_torch_etl_bpe.py``
sweeps every code point through the split against the installed
``tokenizers``; rerun that sweep to take the tables anew.

``add_prefix_space`` is ``tokenizer_config.json``'s (default false): the
fast RoBERTa tokenizer sets it on the pre-tokenizer whatever
``tokenizer.json`` says. ``<mask>`` keeps ``lstrip`` unless
``tokenizer_config.json`` gives its flags. Files whose tokenizer is not
this one (a normaliser, a pre-tokenizer other than the byte-level one,
another post-processor, BPE dropout, byte fallback, word prefixes or
suffixes, single-word added tokens) raise ``ValueError`` naming it.
"""

from __future__ import annotations

import functools
import heapq
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from mrgcn_tpu_torch.encodings.xsd.wordpiece import WHITE_SPACE
from mrgcn_tpu_torch.utils.hf import read_json, token_content

# the Unicode database (``unicodedata.unidata_version``) that the exception
# tables below correct
UNIDATA_VERSION = "15.0.0"


def _ranges(*pairs) -> frozenset:
    return frozenset(c for lo, hi in pairs for c in range(lo, hi + 1))


# code points unassigned in UNIDATA_VERSION that Oniguruma's tables take
# for letters (\p{L}) and for numbers (\p{N})
_LETTERS_EXTRA = _ranges(
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
    (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF),
    (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D))
_NUMBERS_EXTRA = _ranges(
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
    (0x16130, 0x16139), (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9),
    (0x1E5F1, 0x1E5FA))

# tokenizer classes (``tokenizer_config.json``) and model types
# (``config.json``) whose AutoTokenizer is the fast RoBERTa or BLOOM
# tokenizer
BPE_CLASSES = ("RobertaTokenizer", "BloomTokenizer")
BPE_MODEL_TYPES = ("roberta", "roberta-prelayernorm", "bloom")
# RobertaTokenizer's special tokens (its defaults)
DEFAULT_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>",
                    "sep_token": "</s>", "cls_token": "<s>",
                    "unk_token": "<unk>", "pad_token": "<pad>",
                    "mask_token": "<mask>"}
# BloomTokenizerFast's special tokens (its defaults)
BLOOM_SPECIALS = {"unk_token": "<unk>", "bos_token": "<s>",
                  "eos_token": "</s>", "pad_token": "<pad>"}
# the pattern of BLOOM's Split pre-tokenizer, as its tokenizer.json has it
BLOOM_SPLIT = " ?[^(\\s|[.,!?…。，、।۔،])]+"
# what that pattern's class holds besides ``\s``
_BLOOM_STOPS = "(|).,!?…。，、।۔،"


@functools.lru_cache(maxsize=None)
def byte_symbols() -> Tuple[str, ...]:
    """GPT-2's ``bytes_to_unicode``: the symbol of each byte 0..255, the
    printable Latin-1 bytes as themselves and the others as U+0100 on, in
    byte order."""
    kept = [*range(0x21, 0x7F), *range(0xA1, 0xAD), *range(0xAE, 0x100)]
    extra = iter(range(0x100, 0x200))
    return tuple(chr(b) if b in kept else chr(next(extra))
                 for b in range(256))


def _class_of(cp: int) -> str:
    """``s`` (White_Space), ``L``, ``N`` or ``o`` (anything else), as the
    pre-tokenizer's pattern sees ``cp``."""
    c = chr(cp)
    if c in WHITE_SPACE:
        return "s"
    if cp in _LETTERS_EXTRA:
        return "L"
    if cp in _NUMBERS_EXTRA:
        return "N"
    category = unicodedata.category(c)[0]
    return category if category in "LN" else "o"


@functools.lru_cache(maxsize=None)
def char_classes() -> Dict[str, List[Tuple[int, int]]]:
    """The code point ranges of each class of :func:`_class_of`."""
    out: Dict[str, List[Tuple[int, int]]] = {"s": [], "L": [], "N": [],
                                             "o": []}
    start, current = 0, _class_of(0)
    for cp in range(1, 0x110001):
        kind = _class_of(cp) if cp < 0x110000 else None
        if kind != current:
            out[current].append((start, cp - 1))
            start, current = cp, kind
    return out


def _class(kind: str) -> str:
    """The ranges of a class of :func:`char_classes`, for a ``re`` class."""
    return "".join(f"\\U{lo:08x}" if lo == hi
                   else f"\\U{lo:08x}-\\U{hi:08x}"
                   for lo, hi in char_classes()[kind])


@functools.lru_cache(maxsize=None)
def split_pattern() -> "re.Pattern":
    """GPT-2's pattern over the explicit classes of :func:`char_classes`."""
    s, L, N = _class("s"), _class("L"), _class("N")
    return re.compile(f"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+"
                      f"| ?[^{s}{L}{N}]+|[{s}]+(?![^{s}])|[{s}]+")


@functools.lru_cache(maxsize=None)
def bloom_pattern() -> "re.Pattern":
    """``BLOOM_SPLIT`` as Oniguruma reads it, over the explicit
    White_Space class: an optional space, then a run of anything but
    White_Space and ``_BLOOM_STOPS``."""
    return re.compile(f" ?[^{_class('s')}{re.escape(_BLOOM_STOPS)}]+")


def gpt2_parts(text: str, add_prefix_space: bool = False) -> List[str]:
    """``ByteLevel`` with its regex: ``text`` (a space put first where
    ``add_prefix_space`` is set and it has none) split by GPT-2's
    pattern."""
    if add_prefix_space and text and not text.startswith(" "):
        text = " " + text
    return split_pattern().findall(text)


def bloom_parts(text: str, add_prefix_space: bool = False) -> List[str]:
    """BLOOM's ``Split``, ``Isolated`` (each match, and each non-empty
    stretch between matches), then ``ByteLevel`` without its regex, which
    puts a space before each piece that has none where
    ``add_prefix_space`` is set."""
    parts: List[str] = []
    done = 0
    for m in bloom_pattern().finditer(text):
        if m.start() > done:
            parts.append(text[done:m.start()])
        parts.append(m.group())
        done = m.end()
    if done < len(text):
        parts.append(text[done:])
    if add_prefix_space:
        parts = [p if p.startswith(" ") else " " + p for p in parts]
    return parts


@functools.lru_cache(maxsize=None)
def _byte_table() -> Dict[int, str]:
    return dict(enumerate(byte_symbols()))


def pre_tokenize(text: str, parts=gpt2_parts,
                 add_prefix_space: bool = False) -> List[str]:
    """The byte-level pre-tokenizer's parts of ``text`` (``parts``:
    :func:`gpt2_parts` or :func:`bloom_parts`), each as its bytes'
    symbols."""
    table = _byte_table()
    return [part.encode("utf-8").decode("latin-1").translate(table)
            for part in parts(text, add_prefix_space)]


class AddedToken:
    """An added token of the tokenizer: its ``content``, id and flags."""

    def __init__(self, content: str, token_id: int, lstrip: bool = False,
                 rstrip: bool = False, normalized: bool = False):
        self.content = content
        self.id = token_id
        self.lstrip = lstrip
        self.rstrip = rstrip
        self.normalized = normalized

    def flags(self) -> Dict[str, bool]:
        return {"lstrip": self.lstrip, "rstrip": self.rstrip,
                "normalized": self.normalized}


def _leading_space_start(text: str) -> int:
    """Where the whitespace run at the end of ``text`` starts."""
    i = len(text)
    while i > 0 and text[i - 1] in WHITE_SPACE:
        i -= 1
    return i


def _trailing_space_end(text: str, start: int) -> int:
    """Where the whitespace run of ``text`` from ``start`` ends."""
    while start < len(text) and text[start] in WHITE_SPACE:
        start += 1
    return start


def added_pattern(tokens: Sequence[AddedToken]):
    """``(pattern, {content: token})`` that finds ``tokens`` in a text,
    leftmost and longest first, or None where there are none."""
    tokens = sorted((t for t in tokens if t.content),
                    key=lambda t: len(t.content), reverse=True)
    if not tokens:
        return None
    return (re.compile("|".join(re.escape(t.content) for t in tokens)),
            {t.content: t for t in tokens})


def split_added(text: str, pattern, tokens) -> List[Tuple[str,
                                                          Optional[int]]]:
    """``text`` cut around the added tokens that ``pattern`` finds, as the
    Rust library's ``AddedVocabulary::find_matches`` cuts it: ``(piece,
    None)`` between them and ``(text taken, id)`` for each, leftmost
    longest, widened over whitespace by ``lstrip`` (not over what an
    earlier match took) and ``rstrip``."""
    out: List[Tuple[str, Optional[int]]] = []
    done = 0
    for m in pattern.finditer(text):
        token = tokens[m.group()]
        start, stop = m.start(), m.end()
        if token.lstrip:
            start = max(_leading_space_start(text[:start]), done)
        if token.rstrip:
            stop = _trailing_space_end(text, stop)
        if done < start:
            out.append((text[done:start], None))
        out.append((text[start:stop], token.id))
        done = stop
    if done < len(text) or not text:
        out.append((text[done:], None))
    return out


def resolve_specials(added: Dict[str, AddedToken], tok_cfg: Dict,
                     vocab: Dict[str, int], defaults: Dict[str, str],
                     where: str, file_tokens=frozenset()) -> Dict[str, str]:
    """Complete ``added`` (content -> token, from ``tokenizer.json``) as
    transformers' fast tokenizer does: the tokens of
    ``tokenizer_config.json``'s ``added_tokens_decoder``; each special
    token (``defaults``, or ``tokenizer_config.json``'s) missing from them
    at its vocabulary id, or the next free id in transformers' order;
    the mask token, where ``defaults`` has one, with ``lstrip`` unless
    ``tokenizer_config.json`` gives its flags, and then with those of
    ``tokenizer.json`` where it is among that file's ``file_tokens``.
    Returns the special tokens' contents by name."""
    names = {k: token_content(tok_cfg.get(k, v))
             for k, v in defaults.items()}
    for token_id, token in tok_cfg.get("added_tokens_decoder", {}).items():
        added[token["content"]] = AddedToken(
            token["content"], int(token_id),
            **_flags(token, "tokenizer_config.json", where))
    mask = names.get("mask_token")
    if mask is None:
        mask_flags = None
    elif isinstance(tok_cfg.get("mask_token"), dict):
        mask_flags = added[mask].flags() if mask in file_tokens else \
            _flags(tok_cfg["mask_token"], "tokenizer_config.json", where)
    elif mask in {token_content(t) for t in
                  tok_cfg.get("added_tokens_decoder", {}).values()}:
        mask_flags = added[mask].flags()
    else:
        mask_flags = {"lstrip": True}
    next_id = len(vocab) + sum(t not in vocab for t in added)
    for key in ("bos_token", "eos_token", "unk_token", "sep_token",
                "pad_token", "cls_token", "mask_token"):
        token = names.get(key)
        if token is not None and token not in added:
            added[token] = AddedToken(token, vocab.get(token, next_id),
                                      normalized=True)
            next_id += token not in vocab
    if mask is not None:
        added[mask] = AddedToken(mask, added[mask].id, **mask_flags)
    return names


class ByteLevelBPE:
    """The fast RoBERTa tokenizer's ``encode`` (see the module docstring).

    ``vocab`` maps tokens to ids; ``merges`` are ``(left, right)`` pairs
    in rank order; ``added`` the added tokens; ``wrap`` the ``(cls,
    sep)`` ids put around the ids (None: nothing); ``unk_token`` the
    model's unknown token (None: a symbol outside the vocabulary is
    dropped), ``fuse_unk`` whether unknown symbols in a row make one;
    ``parts`` the pre-tokenizer (:func:`gpt2_parts`, RoBERTa's, or
    :func:`bloom_parts`)."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 added: Sequence[AddedToken],
                 wrap: Optional[Tuple[int, int]] = None,
                 add_prefix_space: bool = False,
                 unk_token: Optional[str] = None, fuse_unk: bool = False,
                 ignore_merges: bool = False, parts=gpt2_parts):
        self.vocab = vocab
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (left, right) in enumerate(merges):
            missing = [t for t in (left, right, left + right)
                       if t not in vocab]
            if missing:
                raise ValueError(f"merge {left!r} {right!r}: {missing!r} "
                                 "not in the vocabulary")
            self.merges[vocab[left], vocab[right]] = (rank,
                                                      vocab[left + right])
        self.added = list(added)
        self.wrap = wrap
        self.add_prefix_space = add_prefix_space
        self.unk_id = None if unk_token is None else vocab[unk_token]
        self.fuse_unk = fuse_unk
        self.ignore_merges = ignore_merges
        self.parts = parts
        self._passes = [p for p in (
            added_pattern([t for t in self.added if not t.normalized]),
            added_pattern([t for t in self.added if t.normalized])) if p]

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        text.encode("utf-8")  # a lone surrogate raises, as in Rust
        ids: List[int] = []
        for piece, token_id in self._split_added(text):
            if token_id is not None:
                ids.append(token_id)
            else:
                ids += self._encode_piece(piece)
        if add_special_tokens and self.wrap:
            return [self.wrap[0]] + ids + [self.wrap[1]]
        return ids

    def _split_added(self, text: str) -> List[Tuple[str, Optional[int]]]:
        pieces: List[Tuple[str, Optional[int]]] = [(text, None)]
        for pattern, tokens in self._passes:
            out: List[Tuple[str, Optional[int]]] = []
            for piece, token_id in pieces:
                if token_id is None:
                    out += split_added(piece, pattern, tokens)
                else:
                    out.append((piece, token_id))
            pieces = out
        return pieces

    def _encode_piece(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in pre_tokenize(text, self.parts, self.add_prefix_space):
            ids += self._word_ids(word)
        return ids

    def _word_ids(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        symbols: List[int] = []
        unk_run = False
        for c in word:
            if c in self.vocab:
                symbols.append(self.vocab[c])
                unk_run = False
            elif self.unk_id is not None:
                if not (self.fuse_unk and unk_run):
                    symbols.append(self.unk_id)
                unk_run = True
        return self._merge(symbols)

    def _merge(self, symbols: List[int]) -> List[int]:
        """Rust's ``Word::merge_all``: a heap of (rank, position) over the
        symbol pairs; an entry whose pair has changed since is skipped."""
        n = len(symbols)
        ids = list(symbols)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            merge = self.merges.get((ids[i], ids[i + 1]))
            if merge:
                heap.append((merge[0], i, merge[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            merge = self.merges.get((ids[pos], ids[right]))
            if merge is None or merge[1] != new_id:
                continue
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                merge = self.merges.get((ids[prv[pos]], new_id))
                if merge:
                    heapq.heappush(heap, (merge[0], prv[pos], merge[1]))
            if nxt[pos] < n:
                merge = self.merges.get((new_id, ids[nxt[pos]]))
                if merge:
                    heapq.heappush(heap, (merge[0], pos, merge[1]))
        return [i for i, a in zip(ids, alive) if a]


def _flags(token, where: str, tokenizer: str = "byte-level BPE") -> Dict:
    """``lstrip`` / ``rstrip`` / ``normalized`` of an added token's entry
    (a dict, or a bare string: no flags); raises on ``single_word``."""
    if not isinstance(token, dict):
        return {}
    if token.get("single_word"):
        raise ValueError(f"added token {token.get('content')!r} with "
                         f"single_word in {where} is not implemented by "
                         f"the port's {tokenizer}")
    return {k: bool(token.get(k, False))
            for k in ("lstrip", "rstrip", "normalized")}


def _check_spec(spec: Dict, directory: Path) -> None:
    model = spec.get("model") or {}
    if model.get("type") != "BPE":
        raise ValueError(f"tokenizer.json of model type "
                         f"{model.get('type')!r} in {directory}: the "
                         f"port's BPE reader takes BPE")
    if spec.get("normalizer") is not None:
        raise ValueError(f"tokenizer.json BPE normalizer "
                         f"{spec['normalizer'].get('type')!r} in "
                         f"{directory}: only RoBERTa's and BLOOM's "
                         f"byte-level BPE, which have none, are ported")
    pre = spec.get("pre_tokenizer") or {}
    if pre.get("type") == "Sequence":
        _check_bloom_sequence(pre, directory)
    elif pre.get("type") != "ByteLevel" or not pre.get("use_regex", True):
        raise ValueError(f"tokenizer.json BPE pre_tokenizer "
                         f"{pre.get('type')!r} in {directory}: only "
                         f"RoBERTa's byte-level BPE (ByteLevel, use_regex) "
                         f"and BLOOM's (Sequence of Split and ByteLevel) "
                         f"are ported")
    for key, bad in (("dropout", None), ("byte_fallback", False),
                     ("continuing_subword_prefix", ""),
                     ("end_of_word_suffix", "")):
        if model.get(key) not in (None, bad):
            raise ValueError(f"tokenizer.json BPE {key} "
                             f"{model.get(key)!r} in {directory} is not "
                             f"ported")
    post = (spec.get("post_processor") or {}).get("type")
    if post not in ("RobertaProcessing", "ByteLevel"):
        raise ValueError(f"tokenizer.json BPE post_processor {post!r} in "
                         f"{directory}: only RoBERTa's <s> ... </s> and "
                         f"ByteLevel (no ids) are ported")


def _check_bloom_sequence(pre: Dict, directory: Path) -> None:
    """Raise ``ValueError`` naming the part where the ``Sequence``
    pre-tokenizer ``pre`` is not BLOOM's: ``Split`` on ``BLOOM_SPLIT``,
    ``Isolated``, not inverted, then ``ByteLevel`` without a prefix space
    or its regex."""
    parts = pre.get("pretokenizers") or []
    kinds = [p.get("type") for p in parts]
    if kinds != ["Split", "ByteLevel"]:
        raise ValueError(f"tokenizer.json BPE pre_tokenizer Sequence of "
                         f"{kinds} in {directory}: only BLOOM's "
                         f"['Split', 'ByteLevel'] is ported")
    split, byte_level = parts
    got = (split.get("pattern"), split.get("behavior"),
           bool(split.get("invert", False)))
    want = ({"Regex": BLOOM_SPLIT}, "Isolated", False)
    if got != want:
        raise ValueError(f"tokenizer.json BPE pre_tokenizer Split "
                         f"(pattern, behavior, invert) {got!r} in "
                         f"{directory}: only BLOOM's {want!r} is ported")
    got = (bool(byte_level.get("add_prefix_space", True)),
           bool(byte_level.get("use_regex", True)))
    if got != (False, False):
        raise ValueError(f"tokenizer.json BPE pre_tokenizer ByteLevel "
                         f"after Split with (add_prefix_space, use_regex) "
                         f"{got!r} in {directory}: only BLOOM's "
                         f"(False, False) is ported")


def load(directory: Path) -> Optional[ByteLevelBPE]:
    """The tokenizer of the snapshot ``directory`` as ``AutoTokenizer``
    builds it, or None where it holds neither ``tokenizer.json`` nor
    ``vocab.json`` and ``merges.txt``. A BLOOM snapshot (its tokenizer
    class, or else its model type) is read from ``tokenizer.json`` alone:
    ``BloomTokenizerFast`` has no slow tokenizer to convert. Raises
    ``ValueError`` naming what is not RoBERTa's or BLOOM's byte-level
    BPE, and ``RuntimeError`` where this Python's Unicode database is not
    ``UNIDATA_VERSION``."""
    tok_cfg = read_json(directory / "tokenizer_config.json")
    cls_name = tok_cfg.get("tokenizer_class")
    bloom = cls_name.removesuffix("Fast") == "BloomTokenizer" if cls_name \
        else read_json(directory / "config.json").get("model_type") \
        == "bloom"
    has_json = (directory / "tokenizer.json").is_file()
    if bloom and not has_json:
        present = [f for f in ("vocab.json", "merges.txt")
                   if (directory / f).is_file()]
        if not present:
            return None
        raise ValueError(f"BLOOM tokenizer in {directory} with "
                         f"{', '.join(present)} and no tokenizer.json: "
                         f"BloomTokenizerFast reads tokenizer.json only")
    if not has_json and not all((directory / f).is_file()
                                for f in ("vocab.json", "merges.txt")):
        return None
    added: Dict[str, AddedToken] = {}
    model: Dict = {}
    wrap = None
    parts = gpt2_parts
    if has_json:
        spec = read_json(directory / "tokenizer.json")
        _check_spec(spec, directory)
        model = spec["model"]
        vocab = dict(model["vocab"])
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges", [])]
        # a pair listed twice keeps its last rank (a map insert in Rust)
        rank = {pair: i for i, pair in enumerate(merges)}
        merges = sorted(rank, key=rank.get)
        for token in spec.get("added_tokens", []):
            added[token["content"]] = AddedToken(
                token["content"], token["id"],
                **_flags(token, "tokenizer.json"))
        post = spec["post_processor"]
        if post["type"] == "RobertaProcessing":
            wrap = (post["cls"][1], post["sep"][1])
        if spec["pre_tokenizer"]["type"] == "Sequence":
            parts = bloom_parts
    else:
        vocab = read_json(directory / "vocab.json")
        # RobertaTokenizer drops the first line (the #version header) and
        # the last; a pair listed twice keeps its first place
        lines = (directory / "merges.txt").read_text(
            encoding="utf-8").split("\n")[1:-1]
        merges = list(dict.fromkeys(tuple(line.split()) for line in lines))
    names = resolve_specials(added, tok_cfg, vocab,
                             BLOOM_SPECIALS if bloom else DEFAULT_SPECIALS,
                             "byte-level BPE")
    # transformers sets a ByteLevel pre-tokenizer's add_prefix_space to the
    # config's; inside BLOOM's Sequence only BloomTokenizerFast does
    add_prefix_space = bool(tok_cfg.get("add_prefix_space", False)) and (
        bloom or parts is gpt2_parts)
    if not has_json:   # the converter's RobertaProcessing
        wrap = (added[names["cls_token"]].id, added[names["sep_token"]].id)
    if unicodedata.unidata_version != UNIDATA_VERSION:
        raise RuntimeError(
            f"the byte-level BPE's character tables correct Unicode "
            f"{UNIDATA_VERSION}, and this Python's unicodedata is "
            f"{unicodedata.unidata_version}: the ids could differ from "
            f"AutoTokenizer's; take the tables anew")
    return ByteLevelBPE(
        vocab, merges, added.values(), wrap=wrap,
        add_prefix_space=add_prefix_space,
        unk_token=model.get("unk_token"),
        fuse_unk=bool(model.get("fuse_unk", False)),
        ignore_merges=bool(model.get("ignore_merges", False)), parts=parts)
