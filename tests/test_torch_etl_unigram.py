"""The port's SentencePiece Unigram tokenizer (XLM-R's, ALBERT's) and its
Precompiled normalizer against the installed ``tokenizers`` and the JAX
package's ``AutoTokenizer``.

* The charsmap reader (``encodings/xsd/charsmap.py``) against
  ``tokenizers.normalizers.Precompiled`` on the same bytes: every code
  point through ``tasks/synthetic.nfkc_charsmap`` (Python's NFKC over the
  BMP, controls dropped, CR LF and Latin letter + accent keys), and the
  rules of the Rust normalizer itself (the first, shortest key replaces a
  whole cluster under 6 bytes; a longer cluster goes code point by code
  point).
* The grapheme clusters (``encodings/xsd/graphemes.py``) by probes: a
  charsmap maps every lead byte (``a`` among them) to a marker, so a
  probe such as ``a X`` comes out as ``a``'s marker alone where ``X``
  joined ``a``'s cluster and as two markers where a boundary fell between
  them. One long string of probes, each between two U+0001 (a Control:
  a boundary on both sides), goes through one Rust call. ``a X`` sweeps
  every code point; the other probes (``X a``: Prepend; ``X`` +
  U+0301: Control; emoji ZWJ sequences; the Indic conjunct rule) sweep
  the code points of every class other than ``Other``, those Unicode
  ``graphemes.UNIDATA_VERSION`` leaves unassigned in planes 0 and 1
  (where Unicode 16, the Rust library's, adds marks), and every 61st of
  the rest.
* Every code point through each normalizer of a Unigram ``tokenizer.json``
  (NFKD, NFKC, StripAccents, Lowercase) against the Rust one.
* The ids of ``encode(text, add_special_tokens=True / False)`` against
  ``AutoTokenizer`` on XLM-R- and ALBERT-style snapshots
  (``tasks/synthetic.save_unigram_tokenizer``: seeded pieces and scores,
  ties among them) and variants of their files (the Metaspace settings,
  post-processors, normalizers, added tokens), over seeded strings
  (``synthetic.text_literals``: accents both ways, CR LF, fullwidth
  forms, emoji with modifiers and ZWJ, runs of spaces, the special
  tokens inside the text) and cases of their own; the Viterbi path's ties
  and fused unknowns on a hand-made vocabulary.
* The string vectorizer's arrays and the pad id against the JAX
  package's ``encodings/xsd/string``, array for array.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import base64  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import unicodedata  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mrgcn_tpu.encodings.xsd import string as jstring  # noqa: E402
from mrgcn_tpu_torch.encodings.xsd import graphemes, unigram  # noqa: E402
from mrgcn_tpu_torch.encodings.xsd import string as tstring  # noqa: E402
from mrgcn_tpu_torch.encodings.xsd.charsmap import Charsmap  # noqa: E402
from mrgcn_tpu_torch.tasks import synthetic  # noqa: E402

pytest.importorskip("transformers")
normalizers = pytest.importorskip("tokenizers.normalizers")

CODE_POINTS = [c for c in range(1, 0x110000) if not 0xD800 <= c <= 0xDFFF]
KINDS = ("xlm-roberta", "albert")
CASES = [
    "", " ", "   ", "\t", "\r\n", "a\r\nb", "Hello world!", "café café",
    "x́̂̃y", "ΣΑΣ ǅ İ", "ﬁne Ａｂｃ １２", "👍🏽 👩‍💻",
    "a <mask> b", "a<mask>b", "a  <mask>", "<mask>", "  <mask>  x",
    "x <s> y </s> z <pad> <unk>", "<s><s></s>", "[MASK] x", "x[MASK]y",
    "[CLS][SEP]", "``quoted''", "runs   of    spaces  ", "  lead",
    "tail  ", " nbsp　ideo", "東京大学", "한국어", "ΩΩ qq",
    "\x01\x02ctrl", "x" * 300, "sesu " * 120]


def feature(directory):
    return {"datatype": "xsd.string", "include": True,
            "tokenizer": {"config": ["huggingface/pytorch-transformers",
                                     "tokenizer", str(directory)],
                          "pad_token": "<pad>"}}


@functools.lru_cache(maxsize=None)
def sweep_points():
    """The code points the probes other than ``a X`` sweep (see the module
    docstring)."""
    table = graphemes.letter_table()
    return [c for c in CODE_POINTS
            if table[c] != "o" or c % 61 == 0 or (
                c < 0x20000 and unicodedata.category(chr(c)) == "Cn")]


# --------------------------------------------------------------------------
# the charsmap reader and the grapheme clusters
# --------------------------------------------------------------------------

def test_charsmap_matches_precompiled_on_every_code_point():
    data = synthetic.nfkc_charsmap()
    rust, port = normalizers.Precompiled(data), Charsmap(data)
    for i in range(0, len(CODE_POINTS), 1 << 15):
        text = "\x01".join(map(chr, CODE_POINTS[i:i + (1 << 15)]))
        assert port.normalize(text) == rust.normalize_str(text), \
            hex(CODE_POINTS[i])
    # and text: accents both ways, CR LF, ligatures, fullwidth forms
    for text in CASES + synthetic.text_literals(50, seed=5):
        assert port.normalize(text) == rust.normalize_str(text), text[:40]


def test_first_match_replaces_the_whole_cluster():
    """The Rust rules, not sentencepiece's longest match: ``e`` -> ``E``
    and e + U+0301 -> ``Z`` make ``"e\\u0301x"`` ``"Ex"``; ``\\r`` -> a
    space makes CR LF one space; a cluster of 5 bytes is looked up whole,
    one of 7 code point by code point."""
    data = synthetic.charsmap_bytes({
        b"e": "E", "é".encode(): "Z", b"\r": " ", b"a": "<A>",
        "á̂".encode(): "<A2>"})
    rust, port = normalizers.Precompiled(data), Charsmap(data)
    want = {"éx": "Ex", "\r\n": " ", "á̂": "<A>",
            "á̂̃": "<A>́̂̃",
            "á̂": "<A2>", "á̂̃": "á̂̃",
            "xá": "x<A>", "é": "é"}
    for text, out in want.items():
        assert rust.normalize_str(text) == out
        assert port.normalize(text) == out, text
    with pytest.raises(ValueError, match="NUL"):
        synthetic.charsmap_bytes({b"a\0b": "x"})


@functools.lru_cache(maxsize=None)
def _marker_charsmap():
    keys = {bytes([b]): f"<{b:02x}>"
            for b in [*range(2, 0x80), *range(0xC2, 0xF5)]}
    return synthetic.charsmap_bytes(keys)


PROBES = {
    "a_X": lambda x: "a" + x,
    "X_a": lambda x: x + "a",
    "X_acute": lambda x: x + "́",
    "pict_zwj_X": lambda x: "©‍" + x,
    "pict_X_zwj_pict": lambda x: "©" + x + "‍©́",
    "X_zwj_pict": lambda x: x + "‍©",
    "conjunct_X": lambda x: "क्" + x + "́",
    "linker_X": lambda x: "क" + x + "क́",
    "conjunct_extend_X": lambda x: "क्" + x + "क́"}


@pytest.mark.parametrize("probe", PROBES)
def test_grapheme_clusters_match_the_rust_library(probe):
    data = _marker_charsmap()
    rust, port = normalizers.Precompiled(data), Charsmap(data)
    points = CODE_POINTS if probe == "a_X" else sweep_points()
    parts = [PROBES[probe](chr(c)) for c in points]
    text = "\x01".join(parts)
    if port.normalize(text) == rust.normalize_str(text):
        return
    bad = [hex(c) for c, p in zip(points, parts)
           if port.normalize(p) != rust.normalize_str(p)]
    pytest.fail(f"{probe}: {len(bad)} code points differ: {bad[:20]}")


def test_graphemes_tables_are_this_pythons_unicode_version():
    assert graphemes.UNIDATA_VERSION == unicodedata.unidata_version \
        == unigram.UNIDATA_VERSION


# --------------------------------------------------------------------------
# the normalizers of tokenizer.json
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["NFKD", "NFKC", "StripAccents",
                                  "Lowercase"])
def test_normalizers_match_rust_on_every_code_point(kind):
    rust = getattr(normalizers, kind)()
    port = unigram.normalizer({"type": kind}, "here")
    for i in range(0, len(CODE_POINTS), 1 << 16):
        chunk = CODE_POINTS[i:i + (1 << 16)]
        text = "\x01".join(map(chr, chunk))
        if port(text) != rust.normalize_str(text):
            bad = [hex(c) for c in chunk
                   if port(chr(c)) != rust.normalize_str(chr(c))]
            pytest.fail(f"{kind}: {bad[:20]}")
    for text in CASES:
        assert port(text) == rust.normalize_str(text), text[:40]


@pytest.mark.parametrize("spec", [
    {"type": "Strip", "strip_left": True, "strip_right": False},
    {"type": "Strip", "strip_left": False, "strip_right": True},
    {"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
    {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "\\1 "},
    {"type": "Sequence", "normalizers": [{"type": "NFKD"},
                                         {"type": "StripAccents"},
                                         {"type": "Lowercase"}]}],
    ids=["lstrip", "rstrip", "replace", "regex", "sequence"])
def test_other_normalizers_match_rust(spec):
    from tokenizers import Tokenizer
    raw = {"version": "1.0", "added_tokens": [], "normalizer": spec,
           "pre_tokenizer": None, "post_processor": None, "decoder": None,
           "model": {"type": "Unigram", "unk_id": 0,
                     "vocab": [["<unk>", 0.0]]}}
    rust = Tokenizer.from_str(json.dumps(raw)).normalizer
    port = unigram.normalizer(spec, "here")
    for text in CASES + synthetic.text_literals(40, seed=6):
        assert port(text) == rust.normalize_str(text), text[:40]


# --------------------------------------------------------------------------
# ids against AutoTokenizer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """{kind: directory} of an XLM-R- and an ALBERT-style snapshot."""
    root = tmp_path_factory.mktemp("unigram")
    out = {}
    for kind in KINDS:
        directory = synthetic.save_unigram_tokenizer(root / kind, kind,
                                                     num_pieces=2500, seed=1)
        (directory / "config.json").write_text(json.dumps(
            {"model_type": kind}))
        out[kind] = directory
    return out


def both(directory, cls):
    jtok = jstring.load_tokenizer(feature(directory))
    ttok = tstring.load_tokenizer(feature(directory))
    assert type(jtok).__name__ == cls + "Fast"
    assert isinstance(ttok, unigram.UnigramTokenizer)
    return jtok, ttok


def assert_same_ids(jtok, ttok, texts):
    for text in texts:
        for special in (True, False):
            want = jtok.encode(text, add_special_tokens=special)
            assert ttok.encode(text, add_special_tokens=special) == want, \
                (text[:60], special)


@pytest.mark.parametrize("kind", KINDS)
def test_ids_match_autotokenizer(snapshots, kind):
    cls = synthetic.UNIGRAM_SPECIALS[kind][2]
    jtok, ttok = both(snapshots[kind], cls)
    assert_same_ids(jtok, ttok, CASES + synthetic.text_literals(150, seed=2))
    # the pieces tie, and unknown characters fuse
    scores = [s for _, s in synthetic.unigram_pieces(2000, seed=1)]
    assert len(set(scores)) < len(scores) / 10
    unk = ttok.unk_id
    assert ttok.encode("ΩΩ qq", add_special_tokens=False).count(unk) == 1


VARIANTS = {
    "prepend_first": lambda s: s["pre_tokenizer"].update(
        prepend_scheme="first"),
    "prepend_never": lambda s: s["pre_tokenizer"].update(
        prepend_scheme="never"),
    "no_split": lambda s: s["pre_tokenizer"].update(split=False),
    "legacy_prefix_space": lambda s: s.update(pre_tokenizer={
        "type": "Metaspace", "replacement": "▁", "add_prefix_space": True}),
    "roberta_processing": lambda s: s.update(post_processor={
        "type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0],
        "trim_offsets": True, "add_prefix_space": True}),
    "no_post_processor": lambda s: s.update(post_processor=None),
    "strip_nfkc": lambda s: s["normalizer"].update(normalizers=[
        {"type": "Strip", "strip_left": False, "strip_right": True},
        *s["normalizer"]["normalizers"], {"type": "NFKC"}]),
    "normalized_added": lambda s: s["added_tokens"].append(
        {"id": len(s["model"]["vocab"]), "content": "ﬁ",
         "single_word": False, "lstrip": False, "rstrip": True,
         "normalized": True, "special": False}),
    "mask_lstrip_false": lambda s: [t.update(lstrip=False)
                                    for t in s["added_tokens"]],
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_file_variants_match_autotokenizer(snapshots, tmp_path, variant):
    directory = tmp_path / variant
    shutil.copytree(snapshots["xlm-roberta"], directory)
    spec = json.loads((directory / "tokenizer.json").read_text("utf-8"))
    VARIANTS[variant](spec)
    (directory / "tokenizer.json").write_text(
        json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    jtok, ttok = both(directory, "XLMRobertaTokenizer")
    assert_same_ids(jtok, ttok, CASES + synthetic.text_literals(60, seed=4)
                    + ["ﬁ x  ﬁ", "ﬁﬁ", "<s> x", " <s>", "x <s>"])


def test_mask_flags_from_the_tokenizer_config(snapshots, tmp_path):
    directory = tmp_path / "mask"
    shutil.copytree(snapshots["albert"], directory)
    cfg = json.loads((directory / "tokenizer_config.json").read_text())
    cfg["mask_token"] = {"content": "[MASK]", "lstrip": False,
                         "rstrip": True, "normalized": False,
                         "single_word": False, "special": True,
                         "__type": "AddedToken"}
    (directory / "tokenizer_config.json").write_text(json.dumps(cfg))
    jtok, ttok = both(directory, "AlbertTokenizer")
    assert_same_ids(jtok, ttok, ["a [MASK]  b", "x[MASK]\ty", " [MASK]"])


def test_viterbi_ties_and_unknowns_as_rust(tmp_path):
    """A hand-made vocabulary where paths tie exactly (``ab`` + ``c`` and
    ``a`` + ``bc`` score the same; so do ``▁`` + ``x`` and ``▁x``), where
    two characters unknown alone are a piece together (``qz``), and
    unknown runs fuse around known pieces."""
    vocab = [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0],
             ["a", -2.0], ["b", -2.0], ["c", -2.0], ["ab", -3.0],
             ["bc", -3.0], ["abc", -6.0], ["▁", -1.0], ["x", -1.5],
             ["▁x", -2.5], ["qz", -40.0], ["y", -1.0], ["<mask>", 0.0]]
    directory = synthetic.save_unigram_tokenizer(tmp_path / "t",
                                                 num_pieces=100)
    spec = json.loads((directory / "tokenizer.json").read_text("utf-8"))
    spec["model"]["vocab"] = vocab
    spec["added_tokens"][-1]["id"] = len(vocab) - 1
    spec["post_processor"] = None
    (directory / "tokenizer.json").write_text(
        json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (directory / "config.json").write_text('{"model_type": "xlm-roberta"}')
    jtok, ttok = both(directory, "XLMRobertaTokenizer")
    texts = ["abc", "abcabc", "x", "xx x", "qz", "aqzb", "qqzz", "yqy",
             "ΩΩa", "aΩbΩΩc", "a b c", "cab bca"]
    assert_same_ids(jtok, ttok, texts)
    assert ttok.encode("qz", add_special_tokens=False) == [10, 13]
    assert ttok.encode("ΩΩa", add_special_tokens=False) == [10, 3, 4]


# --------------------------------------------------------------------------
# the string vectorizer and the pad id
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_string_vectorizer_and_pad_match_jax(snapshots, kind):
    from mrgcn_tpu.data import rdf as jrdf
    from mrgcn_tpu_torch.data import rdf as trdf
    from mrgcn_tpu_torch.encodings.common import IndexedNodesMap
    cfg = feature(snapshots[kind])
    assert tstring.pad_symbol_for(cfg) == jstring.pad_symbol_for(cfg) \
        == {"xlm-roberta": 1, "albert": 0}[kind]
    texts = CASES[1:] + synthetic.text_literals(80, seed=7) + ["x " * 600]
    out = []
    for rdf, string, index in ((jrdf, jstring, dict),
                               (trdf, tstring, IndexedNodesMap.build)):
        nodes = [rdf.Literal(t, datatype=rdf.xsd("string")) for t in texts] \
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
    assert max(int(x) for _, _, n in got for x in n) == tstring.MAX_CHARS
    # the synthetic writer's rows are the vectorizer's
    rows = synthetic.tokenized_strings(cfg, texts[:20])
    assert [len(r) for r in rows[0]] == rows[2].tolist()
    assert all(np.array_equal(r, want[0][0][i]) for i, r in
               enumerate(rows[0][:10:2]))


# --------------------------------------------------------------------------
# what is not read raises
# --------------------------------------------------------------------------

@pytest.mark.parametrize("change, match", [
    ("byte_fallback", "byte_fallback"),
    ("pre_tokenizer", "pre_tokenizer 'Whitespace'"),
    ("normalizer", "normalizer 'BertNormalizer'"),
    ("post_processor", "post_processor 'ByteLevel'"),
    ("single_word", "single_word"),
    ("spiece_only", "xlm-roberta tokenizer .* spiece.model and no "
                    "tokenizer.json"),
    ("prefix_space_conflict", "add_prefix_space does not match"),
    ("unicode", "1.1.0")])
def test_unsupported_unigram_files_raise(snapshots, tmp_path, monkeypatch,
                                         change, match):
    directory = tmp_path / change
    shutil.copytree(snapshots["xlm-roberta"], directory)
    path = directory / "tokenizer.json"
    spec = json.loads(path.read_text("utf-8"))
    if change == "byte_fallback":
        spec["model"]["byte_fallback"] = True
    elif change == "pre_tokenizer":
        spec["pre_tokenizer"] = {"type": "Whitespace"}
    elif change == "normalizer":
        spec["normalizer"] = {"type": "BertNormalizer"}
    elif change == "post_processor":
        spec["post_processor"] = {"type": "ByteLevel"}
    elif change == "single_word":
        spec["added_tokens"][0]["single_word"] = True
    elif change == "prefix_space_conflict":
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                                 "add_prefix_space": False}
    elif change == "unicode":
        monkeypatch.setattr(unigram, "UNIDATA_VERSION", "1.1.0")
    path.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    if change == "spiece_only":
        path.unlink()
        (directory / "spiece.model").write_bytes(b"\0")
        # the JAX package cannot convert it without sentencepiece, and
        # trains the byte-level tokenizer's model instead
        assert isinstance(jstring.load_tokenizer(feature(directory)),
                          jstring.ByteTokenizer)
    error = RuntimeError if change == "unicode" else ValueError
    with pytest.raises(error, match=match):
        tstring.load_tokenizer(feature(directory))


def test_charsmap_in_the_file_is_the_writers(snapshots):
    spec = json.loads((snapshots["albert"] / "tokenizer.json")
                      .read_text("utf-8"))
    kinds = [n["type"] for n in spec["normalizer"]["normalizers"]]
    assert kinds == ["Replace", "Replace", "NFKD", "StripAccents",
                     "Lowercase", "Precompiled", "Replace"]
    raw = base64.b64decode(spec["normalizer"]["normalizers"][5]
                           ["precompiled_charsmap"])
    assert raw == synthetic.nfkc_charsmap()
