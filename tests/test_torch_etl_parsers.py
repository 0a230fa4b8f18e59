"""The port's RDF terms and N-Triples / N-Quads parsers against the JAX
package's.

Both packages' ``KnowledgeGraph`` must hold equal triples, in equal order
(term class, lexical form, language, datatype), on the parity graphs under
``benchmarks/parity/big`` and on a small file written here with escapes
(``\\u``, ``\\U``, ``\\"``, ``\\t``), language tags, datatypes, blank nodes,
comments, a malformed line and an N-Quads graph label, plain and gzipped.
In the port, the native C++ parser and the Python parser give equal
triples; where the native library cannot be built the port parses with
Python and says so at warning level. Every extension the JAX package
reads (Turtle, TriG, RDF/XML, JSON-LD; plain and gzipped) dispatches to
the same serialisation in the port, with equal graphs
(``tests/test_torch_etl_serialisations.py`` holds the readers themselves).
"""

import gzip
import logging
from pathlib import Path

import pytest

from mrgcn_tpu.data import kg as jkg
from mrgcn_tpu_torch.data import kg as tkg
from mrgcn_tpu_torch.data import native, ntriples

REPO = Path(__file__).resolve().parent.parent
BIG = REPO / "benchmarks" / "parity" / "big"

LINES = [
    '<http://x/a> <http://x/p> <http://x/b> .',
    '_:b1 <http://x/p> "plain lit" .',
    '<http://x/a> <http://x/q> "bonjour"@fr .',
    '<http://x/a> <http://x/q> "hallo"@nl-BE .',
    '<http://x/a> <http://x/q> "42"^^<http://www.w3.org/2001/XMLSchema#int> .',
    '<http://x/a> <http://x/q> "esc\\t\\"q\\" \\u00e9 \\U0001F600 \\\\" .',
    '<http://x/\\u00e9> <http://x/p> _:b2 .',
    '# a comment line',
    '',
    'malformed junk',
    '<http://x/a> <http://x/p> .',
    '<http://x/b>\t<http://x/p>   <http://x/c>  .  # trailing comment',
    '<http://x/a> <http://x/q> "2000"^^<http://www.w3.org/2001/XMLSchema#gYear> .',
    '<http://x/a> <http://x/q> "2000"^^<http://www.w3.org/2001/XMLSchema#integer> .',
    '<http://x/a> <http://x/p> <http://x/b> .',   # a duplicate
    '<http://x/c> <http://x/p> <http://x/a> <http://x/graph> .',
]
QUAD_LINES = LINES + ['_:b3 <http://x/r> "in a graph"@en _:g1 .']


def write(path: Path, lines) -> str:
    text = "\n".join(lines) + "\n"
    if path.suffix == ".gz":
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write(text)
    else:
        path.write_text(text, encoding="utf-8")
    return str(path)


def term_key(term):
    return (type(term).__name__, str(term), getattr(term, "language", None),
            getattr(term, "datatype", None))


def keys(triples):
    return [tuple(map(term_key, t)) for t in triples]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("rdf")
    return {name: write(d / name, QUAD_LINES if ".nq" in name else LINES)
            for name in ("small.nt", "small.nt.gz", "small.nq",
                         "small.nq.gz")}


BIG_FILES = sorted(str(p.relative_to(BIG)) for p in BIG.glob("*/*.nt.gz"))


@pytest.mark.parametrize("name", BIG_FILES + ["small.nt", "small.nt.gz",
                                              "small.nq", "small.nq.gz"])
def test_knowledge_graphs_match_the_jax_package(name, small):
    path = small[name] if name.startswith("small") else str(BIG / name)
    want = keys(jkg.KnowledgeGraph(path).triples(separate_literals=False))
    got = keys(tkg.KnowledgeGraph(path).triples(separate_literals=False))
    assert got == want and len(got) > 0
    if name.startswith("small"):
        # the duplicate is dropped, the malformed lines skipped; the
        # N-Quads path keeps the labelled statements, N-Triples drops them
        assert len(got) == (12 if ".nq" in name else 10)
        assert ("Literal", 'esc\t"q" é \U0001F600 \\', None, None) \
            in [t[2] for t in got]


@pytest.mark.parametrize("name", ["small.nt", "small.nt.gz",
                                  "nc/context.nt.gz"])
def test_native_parser_equals_python(name, small):
    path = small[name] if name.startswith("small") else str(BIG / name)
    if native.get_lib() is None:
        pytest.skip("no C++ compiler or zlib headers")
    assert "_build" in native._SO and "mrgcn_tpu_torch" in native._SO
    got = native.parse_file_native(path)
    assert keys(got) == keys(ntriples.parse_file(path))


# one small document a serialisation: prefixes, a relative IRI (RDF/XML:
# against the file's URI), a blank node, literals with a language and a
# datatype
DOCS = {
    "turtle": """@prefix x: <http://x/> .
        x:a x:p x:b , [ x:q "v"@en ] ; x:r 42 .
        _:b1 x:p "2000"^^<http://www.w3.org/2001/XMLSchema#gYear> .""",
    "trig": """@prefix x: <http://x/> .
        x:a x:p x:b .
        GRAPH x:g { x:b x:p [ x:q "v"@en ] . _:b1 x:r 1.5 }""",
    "rdfxml": """<?xml version="1.0"?>
        <rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#"
                 xmlns:x="http://x/">
          <rdf:Description rdf:about="local">
            <x:p rdf:resource="http://x/b"/>
            <x:q xml:lang="en">v</x:q>
            <x:r rdf:parseType="Resource"><x:s>1</x:s></x:r>
          </rdf:Description>
        </rdf:RDF>""",
    "jsonld": """{"@context": {"x": "http://x/", "@vocab": "http://x/"},
        "@graph": [{"@id": "x:a", "p": [{"@id": "x:b"}, {"q": "v"}],
                    "r": 42, "s": {"@value": "v", "@language": "en"}}]}""",
}
EXTENSION_DOCS = {".ttl": "turtle", ".n3": "turtle", ".turtle": "turtle",
                  ".trig": "trig", ".rdf": "rdfxml", ".rdfs": "rdfxml",
                  ".owl": "rdfxml", ".xml": "rdfxml", ".jsonld": "jsonld",
                  ".json": "jsonld", ".ttl.gz": "turtle",
                  ".jsonld.gz": "jsonld"}


@pytest.mark.parametrize("ext", list(EXTENSION_DOCS))
def test_every_extension_dispatches_as_the_jax_package(ext, tmp_path):
    path = write(tmp_path / f"graph{ext}", [DOCS[EXTENSION_DOCS[ext]]])
    assert tkg._format_of(path) == jkg._format_of(path)
    want = keys(jkg.KnowledgeGraph(path).triples(separate_literals=False))
    got = keys(tkg.KnowledgeGraph(path).triples(separate_literals=False))
    assert got == want and len(got) >= 4


def test_unknown_extension_raises(tmp_path):
    with pytest.raises(ValueError, match="Unsupported RDF serialisation"):
        tkg._format_of(str(tmp_path / "graph.csv"))


def test_wrong_serialisation_in_an_nt_file_raises(tmp_path):
    path = write(tmp_path / "turtle.nt", ["@prefix x: <http://x/> .",
                                          "x:a x:p x:b ."])
    with pytest.raises(ValueError, match="no valid N-Triples"):
        tkg.KnowledgeGraph(path)


def test_python_path_where_the_library_cannot_be_built(small, monkeypatch,
                                                       caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "_load_so", lambda *a, **k: None)
    with caplog.at_level(logging.WARNING,
                         logger="mrgcn_tpu_torch.data.native"):
        got = keys(tkg.KnowledgeGraph(small["small.nt.gz"]).triples())
    assert "parsing takes the Python path" in caplog.text
    assert got == keys(jkg.KnowledgeGraph(small["small.nt.gz"]).triples())


def test_truncated_gzip_raises_where_the_reference_takes_part_of_it(
        tmp_path, caplog):
    """Reference fault (ROADMAP Queue 3): the JAX package's native parser
    takes the end of a truncated gzip stream for the end of the file and
    returns the triples before it. The port's native parser reports the
    stream's error (logged at warning level); the Python parser then
    raises on it, as it does in both packages."""
    from mrgcn_tpu.data import native as jnative
    whole = gzip.compress(("\n".join(LINES * 200) + "\n").encode())
    path = tmp_path / "cut.nt.gz"
    path.write_bytes(whole[: len(whole) // 2])
    with pytest.raises(EOFError):
        list(ntriples.parse_file(str(path)))
    if jnative.get_lib() is not None:
        partial = jkg.KnowledgeGraph(str(path))
        assert 0 < len(partial) <= 10
    if native.get_lib() is not None:
        with caplog.at_level(logging.WARNING,
                             logger="mrgcn_tpu_torch.data.native"):
            assert native.parse_file_native(str(path)) is None
        assert "native parse error" in caplog.text
    with pytest.raises(EOFError):
        tkg.KnowledgeGraph(str(path))


def test_native_fault_propagates_where_the_reference_hides_it(
        small, monkeypatch):
    """Reference fault (ROADMAP Queue 3): ``mrgcn_tpu.data.kg._read_path``
    catches every exception of the native path and parses with Python,
    logging at debug level only; the port catches nothing there, so a
    fault of the native parser shows."""
    from mrgcn_tpu.data import native as jnative

    def broken(path):
        raise RuntimeError("native parser fault")

    monkeypatch.setattr(jnative, "parse_file_native", broken)
    monkeypatch.setattr(native, "parse_file_native", broken)
    assert len(jkg.KnowledgeGraph(small["small.nt"])) == 10
    with pytest.raises(RuntimeError, match="native parser fault"):
        tkg.KnowledgeGraph(small["small.nt"])


def test_terms_sort_and_compare_as_the_jax_package():
    from mrgcn_tpu.data import rdf as jrdf
    from mrgcn_tpu_torch.data import rdf as trdf
    for mod in (jrdf, trdf):
        lit = mod.Literal("2000", datatype=mod.xsd("gYear"))
        assert lit == mod.Literal("2000", datatype=mod.xsd("gYear"))
        assert lit != mod.Literal("2000", datatype=mod.xsd("integer"))
        assert lit != mod.UniqueLiteral("s", "p", lit)
        assert str(lit) == "2000" and isinstance(mod.IRI("x"), str)
    triples = [(trdf.IRI(f"http://x/{i % 3}"), trdf.IRI("http://x/p"),
                trdf.BNode(f"b{i}")) for i in range(6)]
    assert [tuple(map(str, t)) for t in sorted(triples)] == \
        sorted(tuple(map(str, t)) for t in triples)
