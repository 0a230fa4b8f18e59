"""The port's WordPiece tokenizer against the JAX package's
``AutoTokenizer`` (transformers' fast BERT tokenizer).

A small vocabulary (the five specials, whole words, ``##`` continuations,
accented and CJK pieces; a few hundred entries) is written as a
DistilBERT snapshot, once as ``vocab.txt`` and once as the
``tokenizer.json`` that transformers saves from it, with
``do_lower_case`` false, true and absent (transformers' default: true).
Each package resolves the string feature's tokenizer from the config
(``load_tokenizer``) and the ids of ``encode(text,
add_special_tokens=True)`` must be equal on ASCII, accents, CJK, emoji,
control characters, punctuation runs, special tokens inside the text, a
word of more than 100 characters, empty and whitespace-only strings and
strings past ``MAX_CHARS``; the string vectorizer's arrays too. Files of
another kind of tokenizer raise in the port; the JAX package silently
takes the byte-level tokenizer there (a reference fault, ROADMAP Queue 3).
The hub stays offline: every tokenizer is named by its directory.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import json  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import unicodedata  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mrgcn_tpu.encodings.xsd import string as jstring  # noqa: E402
from mrgcn_tpu_torch.encodings.xsd import string as tstring  # noqa: E402
from mrgcn_tpu_torch.encodings.xsd import wordpiece  # noqa: E402

pytest.importorskip("transformers")

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
WORDS = ["the", "a", "cat", "sat", "on", "mat", "café", "cafe", "naïve",
         "naive", "über", "uber", "straße", "hello", "world", "un", "##aff",
         "##able", "##s", "##ing", "run", "##ning", "東", "京", "大", "学",
         "!", ".", ",", "?", "-", "'", "$", "€", "¿", "·", "é", "##é", "e",
         "##e", "##a", "##f", "##t", "##c", "σ", "##ς", "##σ", "σας",
         "i", "##i", "x", "##x", "😀", "ab", "##ab", "##b"]
CASES = [
    "", "   ", "\t\n\r", "Hello world!", "The cat sat on the mat.",
    "café naïve über straße", "CAFÉ Naïve ÜBER Straße",
    "東京大学 means Tokyo University", "emoji 😀😀 and 😀x",
    "ctrl\x00\x07char\x0bs\x85here​ and�more",
    "punct!!!...???--- ¿que? a·b $5 €5", "[CLS] hi [SEP] [MASK]x[PAD]y",
    "unaffable runnings", "ΣΑΣ σας Σ", "İstanbul ǅ",
    "a b　c d", "a" * 101, "a" * 100 + " cat",
    "ab" * 300 + " " + "cat " * 600,
]
LOWER = {"cased": False, "uncased": True, "default": None}


def vocabulary():
    rng = random.Random(0)
    letters = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJ"
    words = list(WORDS)
    while len(words) < 300:
        w = "".join(rng.choice(letters) for _ in range(rng.randint(1, 4)))
        words.append(w if rng.random() < 0.5 else "##" + w)
    return SPECIALS + list(dict.fromkeys(words))


def feature(directory):
    return {"datatype": "xsd.string", "include": True,
            "tokenizer": {"config": ["huggingface/pytorch-transformers",
                                     "tokenizer", str(directory)],
                          "pad_token": "[PAD]"}}


def write_snapshot(directory, lower, vocab=None):
    directory.mkdir(parents=True)
    (directory / "vocab.txt").write_text(
        "\n".join(vocab or vocabulary()) + "\n", encoding="utf-8")
    (directory / "config.json").write_text(json.dumps(
        {"model_type": "distilbert"}))
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {} if lower is None else {"do_lower_case": lower}))
    return directory


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """{(casing, 'vocab.txt' | 'tokenizer.json'): directory}."""
    from transformers import AutoTokenizer
    root = tmp_path_factory.mktemp("wordpiece")
    out = {}
    for casing, lower in LOWER.items():
        txt = write_snapshot(root / f"{casing}_txt", lower)
        out[casing, "vocab.txt"] = txt
        saved = root / f"{casing}_json"
        AutoTokenizer.from_pretrained(str(txt), local_files_only=True) \
            .save_pretrained(str(saved))
        (saved / "vocab.txt").unlink(missing_ok=True)
        shutil.copy(txt / "config.json", saved / "config.json")
        out[casing, "tokenizer.json"] = saved
    return out


@pytest.mark.parametrize("files", ["vocab.txt", "tokenizer.json"])
@pytest.mark.parametrize("casing", list(LOWER))
def test_ids_match_autotokenizer(snapshots, casing, files):
    directory = snapshots[casing, files]
    jtok = jstring.load_tokenizer(feature(directory))
    ttok = tstring.load_tokenizer(feature(directory))
    assert not isinstance(jtok, jstring.ByteTokenizer)
    assert isinstance(ttok, wordpiece.WordPieceTokenizer)
    assert ttok.lowercase == (LOWER[casing] is not False)
    for text in CASES:
        want = jtok.encode(text, add_special_tokens=True)
        assert ttok.encode(text, add_special_tokens=True) == want, text[:40]
    assert ttok.encode("a" * 101) == [2, 1, 3]   # [CLS] [UNK] [SEP]


def test_the_config_wins_over_the_normalizer_in_tokenizer_json(snapshots,
                                                               tmp_path):
    """transformers rebuilds the saved normaliser from the tokenizer
    config's ``do_lower_case`` (its default: true)."""
    directory = tmp_path / "flipped"
    shutil.copytree(snapshots["cased", "tokenizer.json"], directory)
    spec = json.loads((directory / "tokenizer.json").read_text())
    spec["normalizer"]["lowercase"] = True
    spec["normalizer"]["strip_accents"] = True
    (directory / "tokenizer.json").write_text(json.dumps(spec))
    jtok = jstring.load_tokenizer(feature(directory))
    ttok = tstring.load_tokenizer(feature(directory))
    for text in CASES[5:9]:
        assert ttok.encode(text) == jtok.encode(text, add_special_tokens=True)
    assert not ttok.lowercase


def test_special_tokens_missing_from_the_vocabulary(tmp_path):
    vocab = [t for t in vocabulary() if t not in ("[MASK]", "[PAD]")]
    directory = write_snapshot(tmp_path / "nomask", False, vocab)
    jtok = jstring.load_tokenizer(feature(directory))
    ttok = tstring.load_tokenizer(feature(directory))
    text = "a [MASK] b [PAD]"
    assert ttok.encode(text) == jtok.encode(text, add_special_tokens=True)
    assert len(vocab) in ttok.encode(text)


def test_string_vectorizer_matches_on_wordpiece(snapshots):
    from mrgcn_tpu.data import rdf as jrdf
    from mrgcn_tpu_torch.data import rdf as trdf
    from mrgcn_tpu_torch.encodings.common import IndexedNodesMap
    cfg = feature(snapshots["cased", "vocab.txt"])
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
    assert max(int(a.max()) for seq, _, _ in got for a in seq) < 300
    assert max(int(x) for _, _, lengths in got for x in lengths) == \
        tstring.MAX_CHARS


@pytest.mark.parametrize("kind", ["BPE", "Unigram"])
def test_another_tokenizer_raises_where_the_reference_takes_bytes(kind,
                                                                  tmp_path):
    """Reference fault: ``mrgcn_tpu.encodings.xsd.string.load_tokenizer``
    catches every exception and tokenizes bytes, which trains another
    model from the same config. The port raises, naming the model type:
    a Unigram ``tokenizer.json`` beside a DistilBERT config, and a RoBERTa
    BPE ``tokenizer.json`` without the byte-level pre-tokenizer (the one
    BPE the port runs, ``tests/test_torch_etl_bpe.py``)."""
    directory = tmp_path / kind
    directory.mkdir()
    (directory / "config.json").write_text(json.dumps(
        {"model_type": "roberta" if kind == "BPE" else "distilbert"}))
    (directory / "tokenizer_config.json").write_text("{}")
    (directory / "tokenizer.json").write_text(json.dumps({
        "version": "1.0", "added_tokens": [], "normalizer": None,
        "pre_tokenizer": None, "post_processor": None, "decoder": None,
        "model": {"type": kind, "vocab": {}}}))
    assert isinstance(jstring.load_tokenizer(feature(directory)),
                      jstring.ByteTokenizer)
    with pytest.raises(ValueError, match=kind):
        tstring.load_tokenizer(feature(directory))


def test_another_model_type_raises(tmp_path):
    directory = write_snapshot(tmp_path / "xlmr", None)
    (directory / "config.json").write_text(json.dumps(
        {"model_type": "xlm-roberta"}))
    assert isinstance(jstring.load_tokenizer(feature(directory)),
                      jstring.ByteTokenizer)
    # an XLM-R snapshot without the Unigram tokenizer.json (vocab.txt
    # only): the port's Unigram reader names the missing file
    with pytest.raises(ValueError,
                       match="xlm-roberta.*vocab.txt and no tokenizer.json"):
        tstring.load_tokenizer(feature(directory))


def test_no_files_takes_bytes_in_both(tmp_path):
    cfg = feature(tmp_path / "absent")
    assert isinstance(jstring.load_tokenizer(cfg), jstring.ByteTokenizer)
    assert isinstance(tstring.load_tokenizer(cfg), tstring.ByteTokenizer)
    (tmp_path / "novocab").mkdir()
    (tmp_path / "novocab" / "config.json").write_text(
        json.dumps({"model_type": "distilbert"}))
    cfg = feature(tmp_path / "novocab")
    assert isinstance(jstring.load_tokenizer(cfg), jstring.ByteTokenizer)
    assert isinstance(tstring.load_tokenizer(cfg), tstring.ByteTokenizer)


def test_tables_are_this_pythons_unicode_version():
    """The exception tables correct one Unicode database; a Python with
    another one fails here, before any ids change."""
    assert wordpiece.UNIDATA_VERSION == unicodedata.unidata_version


def test_another_unicode_version_raises(snapshots, monkeypatch):
    monkeypatch.setattr(wordpiece, "UNIDATA_VERSION", "1.1.0")
    with pytest.raises(RuntimeError, match="1.1.0") as err:
        tstring.load_tokenizer(feature(snapshots["cased", "vocab.txt"]))
    assert unicodedata.unidata_version in str(err.value)


@pytest.mark.slow
def test_character_classes_match_tokenizers_on_every_code_point():
    """A sweep of all 1,112,064 code points through the Rust library's
    normaliser and pre-tokenizer, one at a time between two letters (about
    15 s): the port's cleaning and CJK spacing, its accent strip, its
    lowercase and its split agree on each. Slow: a sweep."""
    from tokenizers import normalizers, pre_tokenizers
    rust = {"clean": normalizers.BertNormalizer(
                clean_text=True, handle_chinese_chars=True,
                strip_accents=False, lowercase=False),
            "accents": normalizers.BertNormalizer(
                clean_text=False, handle_chinese_chars=False,
                strip_accents=True, lowercase=False),
            "lower": normalizers.BertNormalizer(
                clean_text=False, handle_chinese_chars=False,
                strip_accents=False, lowercase=True)}
    split = pre_tokenizers.BertPreTokenizer()
    tok = wordpiece.WordPieceTokenizer({"[UNK]": 0},
                                       {"[CLS]": 1, "[SEP]": 2})
    bad = []
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        c = chr(cp)
        text = f"a{c}b"
        want = (rust["clean"].normalize_str(text),
                rust["accents"].normalize_str(c),
                rust["lower"].normalize_str(c),
                [w for w, _ in split.pre_tokenize_str(text)])
        got = (tok.normalize(text), wordpiece._strip_accents(c),
               wordpiece._LOWER_EXTRA.get(c) or c.lower(),
               tok.pre_tokenize(text))
        if got != want:
            bad.append((hex(cp), unicodedata.name(c, "?")))
    assert not bad, bad[:20]
