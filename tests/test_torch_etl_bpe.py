"""The port's byte-level BPE tokenizer against the JAX package's
``AutoTokenizer`` (transformers' fast RoBERTa tokenizer).

A byte-level BPE is trained here with ``tokenizers``
(``ByteLevelBPETokenizer.train_from_iterator`` on a seeded corpus of
ASCII, accented, CJK, emoji and digit words and contractions: the 256 byte
symbols, about 400 merges, the specials ``<s> <pad> </s> <unk> <mask>``)
and written as a RoBERTa snapshot in four layouts: ``vocab.json`` and
``merges.txt`` (which ``AutoTokenizer`` converts), the same with
``add_prefix_space`` set in ``tokenizer_config.json``, the
``tokenizer.json`` that transformers saves from it, and the library's own
``tokenizer.json`` (a ``ByteLevel`` post-processor: no ``<s> ... </s>``).
Each package resolves the string feature's tokenizer from the config
(``load_tokenizer``) and the ids of ``encode(text,
add_special_tokens=True)`` must be equal on every case: ASCII, accents,
CJK, emoji, tabs, newlines, whitespace runs and U+001C-U+001F,
contractions, added tokens inside the text (``<mask>`` takes the space
before it), the empty string, strings past ``MAX_CHARS`` and seeded
random strings; the string vectorizer's arrays and the pad id too. Every
code point goes through the pre-tokenizer's split against the installed
``tokenizers``. Nothing is downloaded: every tokenizer is named by its
directory.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import json  # noqa: E402
import shutil  # noqa: E402
import unicodedata  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mrgcn_tpu.encodings.xsd import string as jstring  # noqa: E402
from mrgcn_tpu_torch.encodings.xsd import bpe  # noqa: E402
from mrgcn_tpu_torch.encodings.xsd import string as tstring  # noqa: E402

pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
WORDS = ["the", "cat", "sat", "on", "mat", "The", "café", "naïve", "über",
         "straße", "東京", "大学", "😀", "👍🏽", "don't", "we're", "I'll",
         "you've", "it's", "a1b2", "2024", "3.14", "hello", "world",
         "Ελληνικά", "русский", "!!", "...", "--", "$5", "€9"]
CASES = [
    "", " ", "   ", "\t", "\n", "\t\n\r", "Hello world!",
    "The cat sat on the mat.", "café naïve über straße",
    "東京大学 means Tokyo University", "emoji 😀😀 and 😀x 👍🏽",
    "tabs\tand\t\ttabs", "new\nlines\n\n", "runs   of    spaces  ",
    "  leading and trailing  ", "don't we're I'll you've it's 'S 'M 'LL",
    "x's y'd z'm 'tis '", "a <mask> b", "a<mask>b", "a  <mask>", "<mask>",
    "  <mask>  x", "x <s> y </s> z <pad> <unk>", "<s><s></s>", "a\u001cb\u001d",
    "\u001e\u001f x", "nbsp here　there ", "1234567 89",
    "x" * 700, "the cat " * 300, "ab́c‍d﻿e",
]


def feature(directory):
    return {"datatype": "xsd.string", "include": True,
            "tokenizer": {"config": ["huggingface/pytorch-transformers",
                                     "tokenizer", str(directory)],
                          "pad_token": "<pad>"}}


def corpus(n=400, seed=0):
    """``n`` lines of ``WORDS`` and seeded syllable words (accented ones
    among them)."""
    rng = np.random.default_rng(seed)
    syllables = [c + v for c in "bdfgklmnprstvzßč" for v in "aeiouyéü"]
    words = WORDS + ["".join(rng.choice(syllables, rng.integers(1, 4)))
                     for _ in range(300)]
    return [" ".join(rng.choice(words, rng.integers(3, 15)))
            for _ in range(n)]


def random_strings(n=200, seed=1):
    """Strings over an alphabet of every class the pattern tells apart."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ019 '\t\n!?.-") + [
        "é", "ß", "東", "京", "😀", " ", "　", "\u001c", "́",
        "٣", "Ⅻ", "<mask>", "<s>", "'s", "'ll", "  ", "the", "cat"]
    return ["".join(rng.choice(alphabet, rng.integers(0, 40)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """{layout: directory} of one trained byte-level BPE."""
    from tokenizers import ByteLevelBPETokenizer
    from transformers import AutoTokenizer
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(corpus(), vocab_size=256 + len(SPECIALS) + 400,
                            min_frequency=1, special_tokens=SPECIALS,
                            show_progress=False)
    root = tmp_path_factory.mktemp("bpe")
    out = {}
    for layout in ("vocab.json", "prefix_space", "tokenizer.json", "raw"):
        directory = root / layout
        directory.mkdir()
        (directory / "config.json").write_text(json.dumps(
            {"model_type": "roberta"}))
        if layout == "raw":
            tok.save(str(directory / "tokenizer.json"))
        else:
            tok.save_model(str(directory))
        if layout == "prefix_space":
            (directory / "tokenizer_config.json").write_text(json.dumps(
                {"add_prefix_space": True}))
        out[layout] = directory
    saved = out["tokenizer.json"]
    AutoTokenizer.from_pretrained(str(out["vocab.json"]),
                                  local_files_only=True) \
        .save_pretrained(str(saved))
    for name in ("vocab.json", "merges.txt"):
        (saved / name).unlink()
    assert len(json.loads((out["vocab.json"] / "vocab.json").read_text())) \
        > 600
    return out


def both(directory):
    jtok = jstring.load_tokenizer(feature(directory))
    ttok = tstring.load_tokenizer(feature(directory))
    assert not isinstance(jtok, jstring.ByteTokenizer)
    assert type(jtok).__name__ == "RobertaTokenizerFast"
    assert isinstance(ttok, bpe.ByteLevelBPE)
    return jtok, ttok


@pytest.mark.parametrize("layout", ["vocab.json", "prefix_space",
                                    "tokenizer.json", "raw"])
def test_ids_match_autotokenizer(snapshots, layout):
    jtok, ttok = both(snapshots[layout])
    assert ttok.add_prefix_space == (layout == "prefix_space")
    assert (ttok.wrap is None) == (layout == "raw")
    for text in CASES + corpus(50, seed=3) + random_strings():
        want = jtok.encode(text, add_special_tokens=True)
        assert ttok.encode(text, add_special_tokens=True) == want, text[:40]
        assert ttok.encode(text, add_special_tokens=False) \
            == jtok.encode(text, add_special_tokens=False), text[:40]
    # <mask> takes the space before it, in every layout
    assert ttok.encode("a <mask>", add_special_tokens=False)[-1] == 4
    assert len(ttok.encode("a <mask>", add_special_tokens=False)) \
        == len(ttok.encode("a<mask>", add_special_tokens=False))


def test_merges_by_rank_and_position_as_the_rust_library(tmp_path):
    """A ``merges.txt`` whose later pair ranks before the pair that makes
    its left part (``aa a`` before ``a a``): the Rust library merges by
    a heap of (rank, position), not all of a pair at once, and the two
    differ on ``aaaa``; duplicate and unknown pieces beside it."""
    from tokenizers import ByteLevelBPETokenizer
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(["a b"], vocab_size=300, special_tokens=SPECIALS,
                            show_progress=False)
    directory = tmp_path / "ranks"
    directory.mkdir()
    tok.save_model(str(directory))
    vocab = json.loads((directory / "vocab.json").read_text())
    for piece in ("aa", "aaa", "ĠĠ", "bb"):
        vocab.setdefault(piece, len(vocab))
    (directory / "vocab.json").write_text(json.dumps(vocab))
    (directory / "merges.txt").write_text(
        "#version: 0.2\naa a\na a\nĠ Ġ\nb b\na a\n")
    (directory / "config.json").write_text(json.dumps(
        {"model_type": "roberta"}))
    jtok, ttok = both(directory)
    for text in ("aaaa", "aaaaa", "aaa aa", "    bbbb", "abab aa"):
        assert ttok.encode(text) == jtok.encode(text), text
    assert ttok.encode("aaaa", add_special_tokens=False) == [
        vocab["aaa"], vocab["a"]]


def test_pad_symbol_matches_jax(snapshots):
    for directory in snapshots.values():
        cfg = feature(directory)
        assert tstring.pad_symbol_for(cfg) == jstring.pad_symbol_for(cfg) \
            == 1


def test_special_tokens_missing_from_the_vocabulary(snapshots, tmp_path):
    directory = tmp_path / "nomask"
    shutil.copytree(snapshots["vocab.json"], directory)
    vocab = json.loads((directory / "vocab.json").read_text())
    del vocab["<mask>"], vocab["<pad>"]
    (directory / "vocab.json").write_text(json.dumps(vocab))
    jtok, ttok = both(directory)
    for text in ("a <mask> b <pad>", "<pad><mask>"):
        assert ttok.encode(text) == jtok.encode(text, add_special_tokens=True)
    assert len(vocab) in ttok.encode("<pad>")


def test_mask_flags_from_the_tokenizer_config(snapshots, tmp_path):
    directory = tmp_path / "mask"
    shutil.copytree(snapshots["vocab.json"], directory)
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"mask_token": {"content": "<mask>", "lstrip": False,
                        "rstrip": True, "normalized": False,
                        "single_word": False, "special": True,
                        "__type": "AddedToken"}}))
    jtok, ttok = both(directory)
    for text in ("a <mask>  b", "x<mask>\ty"):
        assert ttok.encode(text) == jtok.encode(text, add_special_tokens=True)


def test_string_vectorizer_matches_on_bpe(snapshots):
    from mrgcn_tpu.data import rdf as jrdf
    from mrgcn_tpu_torch.data import rdf as trdf
    from mrgcn_tpu_torch.encodings.common import IndexedNodesMap
    cfg = feature(snapshots["tokenizer.json"])
    out = []
    for rdf, string, index in ((jrdf, jstring, dict),
                               (trdf, tstring, IndexedNodesMap.build)):
        nodes = [rdf.Literal(t, datatype=rdf.xsd("string")) for t in CASES] \
            + [rdf.Literal("tekst op zijn Nederlands", language="nl")]
        nodes_map = index({node: i for i, node in enumerate(nodes)})
        preds = {node: {f"http://x/p{i % 2}"}
                 for i, node in enumerate(nodes)}
        out.append(string.generate_features(nodes_map, preds, cfg))
    want, got = out
    assert len(got) == len(want) == 2
    for (g_seq, g_idx, g_len), (w_seq, w_idx, w_len) in zip(got, want):
        assert g_idx.tolist() == w_idx.tolist()
        assert g_len.tolist() == w_len.tolist()
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(g_seq, w_seq))
    assert max(int(x) for _, _, lengths in got for x in lengths) == \
        tstring.MAX_CHARS


def test_every_code_point_splits_as_the_rust_library():
    """Each code point through the Rust ``ByteLevel`` pre-tokenizer: the
    port's letters, numbers, whitespace and the rest, each class in
    chunks behind a member of it whose class is known (``a``, ``1``, a
    tab, ``!``), must come back as one part, the port's split the same;
    a code point of another class in Rust would cut the chunk. Then the
    classes side by side, every code point between each of the four."""
    from tokenizers import pre_tokenizers
    rust = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    classes = bpe.char_classes()
    seen = 0
    for kind, head in (("L", "a"), ("N", "1"), ("s", "\t"), ("o", "!")):
        cps = [cp for lo, hi in classes[kind] for cp in range(lo, hi + 1)
               if not 0xD800 <= cp <= 0xDFFF]
        seen += len(cps)
        for i in range(0, len(cps), 1 << 16):
            text = head + "".join(map(chr, cps[i:i + (1 << 16)]))
            want = [part for part, _ in rust.pre_tokenize_str(text)]
            assert len(want) == 1, (kind, hex(cps[i]))
            assert bpe.pre_tokenize(text) == want, (kind, hex(cps[i]))
    assert seen == 0x110000 - 0x800
    mixed = "a1\t!".join(chr(lo) + chr(hi) for kind in classes
                         for lo, hi in classes[kind][:200]
                         if not 0xD800 <= lo <= 0xDFFF)
    assert bpe.pre_tokenize(mixed) == [
        part for part, _ in rust.pre_tokenize_str(mixed)]


def test_tables_are_this_pythons_unicode_version():
    assert bpe.UNIDATA_VERSION == unicodedata.unidata_version


def test_another_unicode_version_raises(snapshots, monkeypatch):
    monkeypatch.setattr(bpe, "UNIDATA_VERSION", "1.1.0")
    with pytest.raises(RuntimeError, match="1.1.0") as err:
        tstring.load_tokenizer(feature(snapshots["vocab.json"]))
    assert unicodedata.unidata_version in str(err.value)


@pytest.mark.parametrize("change", ["normalizer", "pre_tokenizer",
                                    "post_processor", "single_word",
                                    "dropout"])
def test_other_bpe_setups_raise_naming_them(snapshots, tmp_path, change):
    """Files of a BPE that is not RoBERTa's byte-level one raise, naming
    what differs; the JAX package may load them, or take the byte-level
    tokenizer (its fault, ROADMAP Queue 3): the port does neither."""
    directory = tmp_path / change
    shutil.copytree(snapshots["tokenizer.json"], directory)
    spec = json.loads((directory / "tokenizer.json").read_text())
    match = {"normalizer": "NFC", "pre_tokenizer": "Whitespace",
             "post_processor": "TemplateProcessing",
             "single_word": "single_word", "dropout": "dropout"}[change]
    if change == "normalizer":
        spec["normalizer"] = {"type": "NFC"}
    elif change == "pre_tokenizer":
        spec["pre_tokenizer"] = {"type": "Whitespace"}
    elif change == "post_processor":
        spec["post_processor"] = {"type": "TemplateProcessing",
                                  "single": [], "pair": [],
                                  "special_tokens": {}}
    elif change == "single_word":
        spec["added_tokens"][0]["single_word"] = True
    else:
        spec["model"]["dropout"] = 0.1
    (directory / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=match):
        tstring.load_tokenizer(feature(directory))
