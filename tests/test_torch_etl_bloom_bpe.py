"""The port's BLOOM byte-level BPE against the JAX package's
``AutoTokenizer`` (transformers' ``BloomTokenizerFast``) and the Rust
``tokenizers`` library.

BLOOM's ``tokenizer.json`` is written by the port
(``tasks/synthetic.save_bloom_bpe``) to bigscience/bloom's layout: no
normalizer; a ``Sequence`` pre-tokenizer of ``Split`` on ``"
?[^(\\\\s|[.,!?…。，、।۔،])]+"``, ``Isolated``, then ``ByteLevel`` without a
prefix space or its regex; a ``ByteLevel`` post-processor (no ids);
``<unk> <s> </s> <pad>`` at 0-3; the 256 byte symbols and syllable
merges. Three snapshots: the tokenizer class named in
``tokenizer_config.json``; none there (``config.json``'s ``model_type``
picks); ``add_prefix_space`` set (``BloomTokenizerFast`` turns it on in
the pickled ``ByteLevel``, which then puts a space before every piece of
the ``Split``). The ids of ``encode(text, add_special_tokens=True)`` must
be equal to ``AutoTokenizer``'s and to the Rust tokenizer's on every
case: parentheses and ``|``, the pattern's punctuation, runs of spaces,
tabs and newlines, added tokens inside the text, the empty string,
generated strings (``synthetic.text_literals``) and seeded random ones;
the pad id and the string vectorizer's arrays too. Every code point goes
through the ``Split`` against the Rust pre-tokenizer. Other BPE set-ups
raise, naming the part.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import json  # noqa: E402
import shutil  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mrgcn_tpu.encodings.xsd import string as jstring  # noqa: E402
from mrgcn_tpu_torch.encodings.xsd import bpe  # noqa: E402
from mrgcn_tpu_torch.encodings.xsd import string as tstring  # noqa: E402
from mrgcn_tpu_torch.tasks import synthetic  # noqa: E402
from tests.test_torch_etl_bpe import feature  # noqa: E402

pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

STOPS = "(|).,!?…。，、।۔،"
LAYOUTS = ("class", "model_type", "prefix_space", "roberta_class",
           "gpt2_split")
CASES = [
    "", " ", "   ", "\t", "\n", "\t\n\r", "Hello world", " Hello world",
    "(a|b) c.", "f(x) = (y|z)", "a(b)c|d", "||((  ))", "x ,y", "x , y",
    "hi, there!! ok…。", "… 。 ， 、 । ۔ ،", "a…b。c，d、e।f۔g،h",
    "東京大学。京都，大阪、", "नमस्ते। दुनिया", "سلام، دنیا۔",
    "runs   of    spaces  ", "  leading and trailing  ", "tabs\tand\t\ttabs",
    "new\nlines\n\n", "mixed \t\n 　 white space", "a\u001cb\u001d",
    "x <pad> y", "<s>start</s>", "<unk><pad><s></s>", " <pad> ", "a<pad>b",
    "emoji 😀😀 and 👍🏽 x", "don't stop", "3.14, 2.71! 42?", "x" * 700,
    "the cat " * 300]


def random_strings(n=150, seed=1):
    """Strings over an alphabet of every class the pattern tells apart."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ019 '\t\n-_") + list(STOPS) + [
        "é", "東", "😀", "　", " ", "\u001c", "́", "ba", "Ko",
        "<pad>", "<s>", "  ", " (", " |", "ba be"]
    return ["".join(rng.choice(alphabet, rng.integers(0, 40)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """{layout: directory} of one BLOOM-layout byte-level BPE."""
    root = tmp_path_factory.mktemp("bloom_bpe")
    out = {}
    for layout in LAYOUTS:
        directory = synthetic.save_bloom_bpe(root / layout, 900)
        (directory / "config.json").write_text(json.dumps(
            {"model_type": "bloom"}))
        tok_cfg = json.loads(
            (directory / "tokenizer_config.json").read_text())
        if layout == "model_type":
            del tok_cfg["tokenizer_class"]
        elif layout in ("prefix_space", "roberta_class"):
            tok_cfg["add_prefix_space"] = True
        if layout == "roberta_class":
            tok_cfg["tokenizer_class"] = "RobertaTokenizerFast"
        if layout == "gpt2_split":
            spec = json.loads((directory / "tokenizer.json").read_text())
            spec["pre_tokenizer"] = {"type": "ByteLevel",
                                     "add_prefix_space": True,
                                     "trim_offsets": True, "use_regex": True}
            (directory / "tokenizer.json").write_text(json.dumps(spec))
        (directory / "tokenizer_config.json").write_text(json.dumps(tok_cfg))
        out[layout] = directory
    return out


def both(directory, layout="class"):
    jtok = jstring.load_tokenizer(feature(directory))
    ttok = tstring.load_tokenizer(feature(directory))
    assert type(jtok).__name__ == ("RobertaTokenizerFast"
                                   if layout == "roberta_class"
                                   else "BloomTokenizerFast")
    assert isinstance(ttok, bpe.ByteLevelBPE) and ttok.wrap is None
    assert ttok.parts is (bpe.gpt2_parts if layout == "gpt2_split"
                          else bpe.bloom_parts)
    return jtok, ttok


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ids_match_autotokenizer_and_rust(snapshots, layout):
    """Each layout, and two that mix BLOOM's and RoBERTa's: transformers
    sets a ``ByteLevel`` pre-tokenizer's ``add_prefix_space`` to the
    config's (the BLOOM class over GPT-2's ``ByteLevel`` with a prefix
    space in the file drops it), and inside BLOOM's ``Sequence`` only
    ``BloomTokenizerFast`` does (the RoBERTa class with the config's set
    keeps none)."""
    from tokenizers import Tokenizer
    jtok, ttok = both(snapshots[layout], layout)
    assert ttok.add_prefix_space == (layout == "prefix_space")
    rust = Tokenizer.from_file(str(snapshots[layout] / "tokenizer.json"))
    texts = CASES + synthetic.text_literals(60, seed=2) + random_strings()
    for text in texts:
        want = jtok.encode(text, add_special_tokens=True)
        assert ttok.encode(text, add_special_tokens=True) == want, text[:40]
        assert jtok.encode(text, add_special_tokens=False) == want
        # transformers changes the file's tokenizer there: the prefix
        # space, RobertaTokenizerFast's <mask>
        if layout in ("class", "model_type"):
            assert rust.encode(text).ids == want, text[:40]
    # the added tokens are cut out of the text; no id is added around it
    pad, start = ttok.encode("<pad>"), ttok.encode("<s>x</s>")
    assert pad == [3] and start[0] == 1 and start[-1] == 2
    # merges apply: a syllable word after a space is one token
    assert len(ttok.encode(" baba")) == 1


def test_pad_symbol_and_vectorizer_match_jax(snapshots):
    from mrgcn_tpu.data import rdf as jrdf
    from mrgcn_tpu_torch.data import rdf as trdf
    from mrgcn_tpu_torch.encodings.common import IndexedNodesMap
    for directory in snapshots.values():
        cfg = feature(directory)
        assert tstring.pad_symbol_for(cfg) == jstring.pad_symbol_for(cfg) \
            == 3
    cfg = feature(snapshots["class"])
    out = []
    for rdf, string, index in ((jrdf, jstring, dict),
                               (trdf, tstring, IndexedNodesMap.build)):
        nodes = [rdf.Literal(t, datatype=rdf.xsd("string")) for t in CASES]
        nodes_map = index({node: i for i, node in enumerate(nodes)})
        preds = {node: {f"http://x/p{i % 2}"}
                 for i, node in enumerate(nodes)}
        out.append(string.generate_features(nodes_map, preds, cfg))
    want, got = out
    for (g_seq, g_idx, g_len), (w_seq, w_idx, w_len) in zip(got, want):
        assert g_idx.tolist() == w_idx.tolist()
        assert g_len.tolist() == w_len.tolist()
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(g_seq, w_seq))


def test_every_code_point_splits_as_the_rust_library(snapshots):
    """Each code point through the Rust pre-tokenizer of the file: those
    the port's class lets into a piece, in chunks behind ``a``, must come
    back as one piece, and those it stops at (White_Space and the
    pattern's punctuation), behind a tab, as one stretch between pieces;
    a code point the Rust pattern sees otherwise would cut the chunk.
    Then every stop between letters, after a space and alone."""
    from tokenizers import Tokenizer
    rust = Tokenizer.from_file(
        str(snapshots["class"] / "tokenizer.json")).pre_tokenizer
    stops = {cp for lo, hi in bpe.char_classes()["s"]
             for cp in range(lo, hi + 1)} | set(map(ord, STOPS))
    seen = 0
    for head, inside in (("a", False), ("\t", True)):
        cps = [cp for cp in range(0x110000)
               if (cp in stops) == inside and not 0xD800 <= cp <= 0xDFFF]
        seen += len(cps)
        for i in range(0, len(cps), 1 << 16):
            text = head + "".join(map(chr, cps[i:i + (1 << 16)]))
            want = [part for part, _ in rust.pre_tokenize_str(text)]
            assert len(want) == 1, (head, hex(cps[i]))
            assert bpe.pre_tokenize(text, bpe.bloom_parts) == want
    assert seen == 0x110000 - 0x800
    mixed = "".join(f"a{chr(cp)}b {chr(cp)} {chr(cp)}c" for cp in
                    sorted(stops))
    assert bpe.pre_tokenize(mixed, bpe.bloom_parts) == [
        part for part, _ in rust.pre_tokenize_str(mixed)]


def _split(spec):
    return spec["pre_tokenizer"]["pretokenizers"][0]


@pytest.mark.parametrize("change, match", [
    (lambda s: _split(s).update(pattern={"Regex": " ?[^\\s]+"}),
     "Split.*' \\?\\[\\^\\\\\\\\s\\]\\+'"),
    (lambda s: _split(s).update(behavior="Removed"), "Split.*Removed"),
    (lambda s: _split(s).update(invert=True), "Split.*True"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"].append(
        {"type": "Digits", "individual_digits": True}),
     "Sequence of \\['Split', 'ByteLevel', 'Digits'\\]"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][1].update(
        use_regex=True), "ByteLevel after Split.*\\(False, True\\)"),
    (lambda s: s.update(post_processor={
        "type": "TemplateProcessing", "single": [], "pair": [],
        "special_tokens": {}}), "post_processor 'TemplateProcessing'")],
    ids=["pattern", "behavior", "invert", "sequence", "byte_level_regex",
         "post_processor"])
def test_other_bloom_setups_raise_naming_them(snapshots, tmp_path, change,
                                              match):
    """A ``tokenizer.json`` whose pre-tokenizer or post-processor is not
    BLOOM's raises ``ValueError`` naming the part that differs; the JAX
    package would run another tokenizer, or take the byte-level one."""
    directory = tmp_path / "edited"
    shutil.copytree(snapshots["class"], directory)
    spec = json.loads((directory / "tokenizer.json").read_text())
    change(spec)
    (directory / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=match):
        tstring.load_tokenizer(feature(directory))


def test_bloom_without_tokenizer_json_raises(snapshots, tmp_path):
    """``BloomTokenizerFast`` has no slow tokenizer: a BLOOM snapshot with
    ``vocab.json`` and ``merges.txt`` and no ``tokenizer.json`` raises,
    naming the file (the JAX package's ``AutoTokenizer`` fails, and it
    takes the byte-level tokenizer)."""
    directory = tmp_path / "slow"
    shutil.copytree(snapshots["class"], directory)
    spec = json.loads((directory / "tokenizer.json").read_text())
    (directory / "tokenizer.json").unlink()
    (directory / "vocab.json").write_text(json.dumps(spec["model"]["vocab"]))
    (directory / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(m + "\n" for m in spec["model"]["merges"]))
    assert isinstance(jstring.load_tokenizer(feature(directory)),
                      jstring.ByteTokenizer)
    with pytest.raises(ValueError, match="vocab.json, merges.txt and no "
                                         "tokenizer.json"):
        tstring.load_tokenizer(feature(directory))
