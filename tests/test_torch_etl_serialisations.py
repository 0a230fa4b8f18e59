"""The port's Turtle / TriG, RDF/XML and JSON-LD readers, and the rest of
its ``KnowledgeGraph``, against the JAX package's.

* Every document of ``tests/test_turtle.py``, ``test_rdfxml.py`` and
  ``test_jsonld.py`` (and a few more on bases the JAX package resolves
  right) parses to equal triples in equal order in both packages, or
  raises the same error class in both.
* The parity graphs under ``benchmarks/parity/big``, written in each
  serialisation by ``chip_smoke.py``'s writers, plain and gzipped, give
  equal graphs in both packages, equal to the N-Triples file's.
* ``mkdataset`` builds equal artifacts in both packages from a small graph
  in each serialisation.
* The faults of the JAX package's readers that the port mends, each shown
  beside the port's result: relative IRIs in Turtle and JSON-LD (RFC 3986,
  :mod:`mrgcn_tpu_torch.data.iri`), JSON-LD's cyclic context, and
  generated blank nodes that merge with a document's own label in Turtle
  and JSON-LD; and RDF/XML's ``urljoin`` against a ``urn:`` base.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import copy  # noqa: E402
import json  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402
from urllib.parse import urljoin  # noqa: E402

import pytest  # noqa: E402

import chip_smoke  # noqa: E402
from mrgcn_tpu import mkdataset as jmk  # noqa: E402
from mrgcn_tpu.config import load_config  # noqa: E402
from mrgcn_tpu.data import jsonld as jjsonld  # noqa: E402
from mrgcn_tpu.data import kg as jkg  # noqa: E402
from mrgcn_tpu.data import rdfxml as jrdfxml  # noqa: E402
from mrgcn_tpu.data import turtle as jturtle  # noqa: E402
from mrgcn_tpu_torch import mkdataset as tmk  # noqa: E402
from mrgcn_tpu_torch.data import iri  # noqa: E402
from mrgcn_tpu_torch.data import jsonld as tjsonld  # noqa: E402
from mrgcn_tpu_torch.data import kg as tkg  # noqa: E402
from mrgcn_tpu_torch.data import rdfxml as trdfxml  # noqa: E402
from mrgcn_tpu_torch.data import turtle as tturtle  # noqa: E402

from tests import prestage  # noqa: E402
from tests.test_torch_etl_mkdataset import (  # noqa: E402,F401
    empty_hub, same_build)
from tests.test_torch_etl_parsers import keys  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
BIG = REPO / "benchmarks" / "parity" / "big"
RDF = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
XSD = "http://www.w3.org/2001/XMLSchema#"
EX = "http://example.org/"
EXNS = "http://example.org/ns#"
MODULES = {"turtle": (jturtle, tturtle), "rdfxml": (jrdfxml, trdfxml),
           "jsonld": (jjsonld, tjsonld)}


def rdfxml_doc(body, base=None):
    base_attr = f' xml:base="{base}"' if base else ""
    return (f'<?xml version="1.0"?>\n<rdf:RDF xmlns:rdf="{RDF}" '
            f'xmlns:ex="{EXNS}"{base_attr}>\n{body}\n</rdf:RDF>')


TURTLE = {
    "basic": """
        @prefix ex: <http://example.org/> .
        @prefix xsd: <http://www.w3.org/2001/XMLSchema#> .
        ex:s ex:p ex:o .
        ex:s ex:q "plain" .
        ex:s ex:q "tagged"@en-GB .
        ex:s ex:n "3.5"^^xsd:double .""",
    "lists_and_a": """
        @prefix ex: <http://example.org/> .
        ex:s a ex:T ;
             ex:p ex:o1 , ex:o2 ;
             ex:q "v" .""",
    "shorthand": """@prefix ex: <http://example.org/> .
        ex:s ex:i 42 ; ex:d 3.14 ; ex:e 1e3 ; ex:b true ; ex:f false .""",
    "final_dot": "@prefix ex: <http://e/> . ex:s ex:p ex:o.",
    "bnodes": """
        @prefix ex: <http://example.org/> .
        _:b1 ex:p ex:o .
        ex:s ex:knows [ ex:name "anna" ; ex:age 7 ] .""",
    "collections": """@prefix ex: <http://e/> .
        ex:s ex:list ( ex:a ex:b ) .
        ex:t ex:empty ( ) .""",
    "long_strings": '''@prefix ex: <http://e/> .
        ex:s ex:p """multi
line "quoted" text""" ; ex:q "tab\\there" .''',
    "sparql_directives": """
        BASE <http://example.org/data/>
        PREFIX ex: <http://example.org/>
        <item1> ex:p <sub/item2> .""",
    "equivalent": """
@prefix e: <http://e/> .
e:s e:p e:o ; e:q "lit"@nl ; e:r 5 .""",
    "error_line_3": "@prefix ex: <http://e/> .\nex:s ex:p ex:o .\n"
                    "ex:s ex:p ; .\n",
    "kg_file": "@prefix ex: <http://e/> .\nex:a ex:p ex:b .\n"
               " ex:b ex:p ex:c .\n",
    "braces_without_trig": "{ <http://e/s> <http://e/p> <http://e/o> . }",
    "http_base": """@base <http://x.org/dir/> .
        <name> <#p> </abs> , <//host/y> , <> .""",
    "file_base": """@base <file:///data/dir/g.ttl> .
        <name> <#p> </abs> , <//host/y> .""",
    "tb_label_without_clash": """@prefix ex: <http://e/> .
        ex:a ex:p [ ex:q "1" ] . _:tb7 ex:q "2" . _:x ex:q "3" .""",
}
TRIG = {
    "graph_blocks": """
        @prefix ex: <http://example.org/> .
        ex:top ex:p ex:o .
        { ex:anon ex:p ex:o . }
        GRAPH ex:g1 { ex:a ex:p ex:b ; ex:q ex:c . }
        ex:g2 { ex:d ex:p ex:e . ex:f ex:p ex:h }
        graph _:b0 { ex:i ex:p 7 }""",
    "trailing_semicolon": "@prefix ex: <http://e/> .\n"
                          "ex:g { ex:a ex:p ex:b ; }\n",
    "kg_file": "@prefix ex: <http://e/> .\n"
               "GRAPH ex:g { ex:a ex:p ex:b . ex:b ex:p ex:c . }\n",
    # a graph label with the generated form is no clash: labels are ignored
    "tb_graph_label": "@prefix ex: <http://e/> .\n"
                      "GRAPH _:tb0 { ex:a ex:p [ ex:q 1 ] . }\n",
}
RDFXML = {
    "typed_node": ('<ex:Person rdf:about="http://a/alice">'
                   '<ex:name>Alice</ex:name></ex:Person>', None),
    "resource_datatype": ('<rdf:Description rdf:about="http://a/x">'
                          '<ex:knows rdf:resource="http://a/y"/>'
                          f'<ex:age rdf:datatype="{XSD}integer">30</ex:age>'
                          '</rdf:Description>', None),
    "language": ('<rdf:Description rdf:about="http://a/x" xml:lang="en">'
                 '<ex:a>hello</ex:a><ex:b xml:lang="nl">hallo</ex:b>'
                 '</rdf:Description>', None),
    "base_and_id": ('<rdf:Description rdf:about="alice">'
                    '<ex:knows rdf:resource="bob"/></rdf:Description>'
                    '<rdf:Description rdf:ID="carol"><ex:x>1</ex:x>'
                    '</rdf:Description>', "http://base.org/dir/"),
    "node_id": ('<rdf:Description rdf:nodeID="b"><ex:n>x</ex:n>'
                '</rdf:Description><rdf:Description rdf:about="http://a/x">'
                '<ex:knows rdf:nodeID="b"/></rdf:Description>', None),
    "nested": ('<ex:A rdf:about="http://a/x"><ex:child>'
               '<ex:B rdf:about="http://a/y"><ex:n>y</ex:n></ex:B>'
               '</ex:child></ex:A>', None),
    "parsetype_resource": ('<rdf:Description rdf:about="http://a/x">'
                           '<ex:addr rdf:parseType="Resource">'
                           '<ex:city>Delft</ex:city></ex:addr>'
                           '</rdf:Description>', None),
    "parsetype_collection": ('<rdf:Description rdf:about="http://a/x">'
                             '<ex:items rdf:parseType="Collection">'
                             '<rdf:Description rdf:about="http://a/1"/>'
                             '<rdf:Description rdf:about="http://a/2"/>'
                             '</ex:items></rdf:Description>', None),
    "empty_collection": ('<rdf:Description rdf:about="http://a/x">'
                         '<ex:items rdf:parseType="Collection"/>'
                         '</rdf:Description>', None),
    "parsetype_literal": ('<rdf:Description rdf:about="http://a/x">'
                          '<ex:bio rdf:parseType="Literal">a <b>bold</b> b'
                          '</ex:bio></rdf:Description>', None),
    "container_li": ('<rdf:Seq rdf:about="http://a/seq">'
                     '<rdf:li>one</rdf:li><rdf:li>two</rdf:li></rdf:Seq>',
                     None),
    "property_attrs_node": ('<ex:Person rdf:about="http://a/x" '
                            'ex:nick="Al"/>', None),
    "property_attrs_empty": ('<rdf:Description rdf:about="http://a/x">'
                             '<ex:addr ex:city="Delft"/></rdf:Description>',
                             None),
    "about_and_node_id": ('<rdf:Description rdf:about="a" rdf:nodeID="b"/>',
                          None),
    "equivalence": ('<ex:Person rdf:about="http://a/alice" ex:nick="Al">'
                    f'<ex:age rdf:datatype="{XSD}integer">30</ex:age>'
                    '<ex:knows rdf:resource="http://a/bob"/>'
                    '<ex:name xml:lang="en">Alice</ex:name></ex:Person>',
                    None),
    "file_base": ('<rdf:Description rdf:about="name">'
                  '<ex:p rdf:resource="#frag"/><ex:p rdf:resource="/abs"/>'
                  '<ex:p rdf:resource="//host/y"/>'
                  '<ex:p rdf:resource="../up"/><ex:p rdf:resource=""/>'
                  '</rdf:Description>', "file:///data/dir/g.rdf"),
}
JSONLD = {
    "expanded": {"@id": EX + "alice", "@type": EX + "Person",
                 EX + "name": {"@value": "Alice", "@language": "en"},
                 EX + "age": {"@value": 31, "@type": XSD + "integer"},
                 EX + "knows": {"@id": EX + "bob"}},
    "context_terms": {"@context": {"ex": EX, "name": "ex:name",
                                   "knows": {"@id": "ex:knows",
                                             "@type": "@id"},
                                   "born": {"@id": "ex:born",
                                            "@type": "xsd:gYear"},
                                   "xsd": XSD},
                      "@id": "ex:alice", "name": "Alice", "knows": "ex:bob",
                      "born": "1990"},
    "vocab_scalars": {"@context": {"@vocab": EX, "@language": "nl"},
                      "@id": EX + "x", "label": "fiets", "count": 7,
                      "score": 2.5, "flag": True},
    "nested_bnodes": {"@context": {"@vocab": EX}, "@id": EX + "a",
                      "knows": [{"@id": EX + "b", "name": "B"},
                                {"name": "anon"}]},
    "list": {"@context": {"@vocab": EX, "seq": {"@id": EX + "seq",
                                                "@container": "@list"}},
             "@id": EX + "s", "seq": [1, 2]},
    "graph": {"@context": {"@vocab": EX},
              "@graph": [{"@id": EX + "a", "p": {"@id": EX + "b"}},
                         {"@id": EX + "g1", "@graph": [
                             {"@id": EX + "c", "p": {"@id": EX + "d"}}]}]},
    "remote_context": {"@context": "http://remote/ctx.jsonld",
                       "@id": EX + "x"},
    "reverse": {"@context": {"@vocab": EX}, "@id": EX + "x",
                "@reverse": {"p": {"@id": EX + "y"}}},
    "index_container": {"@context": {"t": {"@id": EX + "t",
                                           "@container": "@index"}}},
    "json_type": {"@id": EX + "x", EX + "v": {"@value": 1, "@type": "@json"}},
    "no_base": {"@id": "relative", EX + "p": {"@id": EX + "y"}},
    "nonstring_coercion": {"@context": {"xsd": XSD, "ex": EX,
                                        "born": {"@id": "ex:born",
                                                 "@type": "xsd:gYear"},
                                        "knows": {"@id": "ex:knows",
                                                  "@type": "@id"}},
                           "@id": EX + "a", "born": 2000, "knows": True},
    "coercion_without_id": {"@context": {"@vocab": EX, "xsd": XSD,
                                         "age": {"@type": "xsd:integer"}},
                            "@id": EX + "a", "age": "3"},
    "list_single_value": {"@context": {"seq": {"@id": EX + "seq",
                                               "@container": "@list"}},
                          "@id": EX + "s", "seq": 1},
    "value_object_language": {"@context": {"@language": "en", "@vocab": EX},
                              "@id": EX + "a", "p": {"@value": "x"}},
    "null_value": {"@id": EX + "a", EX + "p": {"@value": None}},
    "kg_file": {"@context": {"@vocab": EX},
                "@graph": [{"@id": EX + "a", "p": {"@id": EX + "b"}},
                           {"@id": EX + "b", "p": {"@id": EX + "c"}}]},
    "http_base": {"@context": {"@base": "http://x.org/dir/"},
                  "@graph": [{"@id": "name", EX + "p": [{"@id": "#frag"},
                                                        {"@id": "other"}]}]},
    "jb_label_without_clash": {"@graph": [
        {EX + "p": {EX + "q": "1"}}, {"@id": "_:jb9", EX + "q": "2"}]},
}
CORPUS = [pytest.param("turtle", t, {}, id=f"turtle-{k}")
          for k, t in TURTLE.items()]
CORPUS += [pytest.param("turtle", t, {"trig": True}, id=f"trig-{k}")
           for k, t in TRIG.items()]
CORPUS += [pytest.param("rdfxml", rdfxml_doc(body, base), {},
                        id=f"rdfxml-{k}")
           for k, (body, base) in RDFXML.items()]
CORPUS += [pytest.param("rdfxml", rdfxml_doc(RDFXML["file_base"][0]),
                        {"base_iri": "http://host/dir/g.rdf"},
                        id="rdfxml-base_iri"),
           pytest.param("rdfxml", "this is not XML at all", {},
                        id="rdfxml-not_xml")]
CORPUS += [pytest.param("jsonld", json.dumps(d), {}, id=f"jsonld-{k}")
           for k, d in JSONLD.items()]
CORPUS += [pytest.param("jsonld", "<rdf/>", {}, id="jsonld-not_json")]


def outcome(module, text, kwargs):
    """The triples' keys in order, or the name of the error raised."""
    try:
        return keys(module.parse_text(text, **kwargs))
    except ValueError as exc:
        return type(exc).__name__


@pytest.mark.parametrize("kind,text,kwargs", CORPUS)
def test_parsers_match_the_jax_package(kind, text, kwargs):
    jax_module, port_module = MODULES[kind]
    want = outcome(jax_module, text, kwargs)
    assert outcome(port_module, text, kwargs) == want


BIG_FILES = sorted(str(p.relative_to(BIG)) for p in BIG.glob("*/*.nt.gz"))
EXTENSIONS = {"turtle": ".ttl", "trig": ".trig", "rdfxml": ".rdf",
              "jsonld": ".jsonld"}


@pytest.mark.parametrize("gz", ["", ".gz"], ids=["plain", "gz"])
@pytest.mark.parametrize("serialisation", list(EXTENSIONS))
@pytest.mark.parametrize("name", BIG_FILES)
def test_parity_graphs_in_each_serialisation(name, serialisation, gz,
                                             tmp_path):
    path = tmp_path / (Path(name).name.split(".")[0]
                       + EXTENSIONS[serialisation] + gz)
    chip_smoke.write_serialised(chip_smoke.read_nt(BIG / name), path,
                                serialisation)
    want = keys(jkg.KnowledgeGraph(str(BIG / name)).triples(
        separate_literals=False))
    jax = keys(jkg.KnowledgeGraph(str(path)).triples(separate_literals=False))
    got = keys(tkg.KnowledgeGraph(str(path)).triples(separate_literals=False))
    assert got == jax == want and len(got) > 0


@pytest.mark.parametrize("serialisation", list(EXTENSIONS))
@pytest.mark.parametrize("name", ["dmg.toml", "fb15k-237.toml"])
def test_mkdataset_matches_the_jax_package(name, serialisation, tmp_path,
                                           empty_hub):
    config = copy.deepcopy(load_config(str(REPO / "configs" / name)))
    nt = prestage.make_dataset_for_config(config, str(tmp_path / "nt"))
    config["graph"].update(chip_smoke.serialise_graph(
        nt, tmp_path / serialisation, serialisation,
        EXTENSIONS[serialisation]))
    assert all(p.endswith(EXTENSIONS[serialisation] + ".gz")
               for p in config["graph"].values() if isinstance(p, str))
    if config["task"]["type"] == "node classification":
        config["task"]["target_property"] = prestage.EX + "hasClass"
        config["task"]["target_property_inv"] = ""
    want = jmk.build(copy.deepcopy(config))
    got = tmk.build(copy.deepcopy(config))
    same_build(got, want)
    assert got[0].num_edges > 0


# -- the JAX package's faults that the port mends -------------------------

def iris(triples):
    return [tuple(map(str, t)) for t in triples]


def test_turtle_relative_iris_resolve_by_rfc3986():
    """Reference fault: ``turtle._Parser._resolve`` cuts the base at its
    last ``/``: a path-less base loses its authority and ``..`` stays.
    The port resolves by RFC 3986 §5.2, as ``urljoin`` does here."""
    doc = "@base <http://example.com> . <alice> <p> <../b> ."
    assert iris(jturtle.parse_text(doc)) == [
        ("http://alice", "http://p", "http://../b")]
    assert iris(tturtle.parse_text(doc)) == [
        ("http://example.com/alice", "http://example.com/p",
         "http://example.com/b")]
    doc = "@base <http://x.org/a/b/c> . <s> <p> <../d> ."
    assert iris(jturtle.parse_text(doc))[0][2] == "http://x.org/a/b/../d"
    assert iris(tturtle.parse_text(doc))[0][2] == "http://x.org/a/d" \
        == urljoin("http://x.org/a/b/c", "../d")


def test_jsonld_relative_iris_resolve_by_rfc3986():
    """Reference fault (``ADVICE.md``): ``jsonld._Context.expand_iri``
    cuts ``@base`` at its last ``/``; the port resolves by RFC 3986."""
    doc = json.dumps({"@context": {"@base": "http://example.com"},
                      "@id": "alice",
                      EX + "p": [{"@id": "../b"}, {"@id": "/abs"}]})
    assert iris(jjsonld.parse_text(doc)) == [
        ("http://alice", EX + "p", "http://../b"),
        ("http://alice", EX + "p", "http:///abs")]
    assert iris(tjsonld.parse_text(doc)) == [
        ("http://example.com/alice", EX + "p", "http://example.com/b"),
        ("http://example.com/alice", EX + "p", "http://example.com/abs")]


def test_jsonld_cyclic_context_raises_naming_the_term():
    """Reference fault (``ADVICE.md``): a cyclic IRI mapping recurses
    until ``RecursionError`` in the JAX package; the port raises
    ``JsonLdError`` naming the term."""
    doc = json.dumps({"@context": {"a": "a:x"}, "@id": EX + "s",
                      "a": "v"})
    with pytest.raises(RecursionError):
        jjsonld.parse_text(doc)
    with pytest.raises(tjsonld.JsonLdError, match="cyclic.*'a'"):
        tjsonld.parse_text(doc)
    doc = json.dumps({"@context": {"b": "c:y", "c": "b:z"},
                      "@id": EX + "s", "b": "v"})
    with pytest.raises(tjsonld.JsonLdError, match="cyclic"):
        tjsonld.parse_text(doc)


def test_turtle_generated_bnodes_stay_apart_from_document_labels():
    """Reference fault: the JAX package's Turtle reader names its blank
    nodes ``tb0, tb1, ...`` beside the document's own labels, so a
    document's ``_:tb0`` merges with the first ``[ ]``. The port keeps
    the two nodes apart; the document's label stays."""
    doc = '@prefix x: <http://x/> . x:a x:p [ x:q "1" ] . _:tb0 x:q "2" .'
    jax = jturtle.parse_text(doc)
    assert [str(t[0]) for t in jax] == ["tb0", "http://x/a", "tb0"]
    assert str(jax[1][2]) == "tb0"                        # one node
    port = tturtle.parse_text(doc)
    assert [str(t[0]) for t in port] == ["tb_0", "http://x/a", "tb0"]
    assert str(port[1][2]) == "tb_0"
    assert type(port[1][2]) is tkg.BNode and type(port[2][0]) is tkg.BNode
    # a generated node under another prefix where "tb_" is taken too
    doc += ' _:tb_0 x:q "3" .'
    assert [str(t[0]) for t in tturtle.parse_text(doc)] == [
        "tb__0", "http://x/a", "tb0", "tb_0"]


def test_jsonld_generated_bnodes_stay_apart_from_document_labels():
    """Reference fault (``ADVICE.md``): the JAX package's ``jb<n>`` blank
    nodes share the namespace of the document's ``_:`` labels; the port
    keeps a document's ``_:jb1`` apart from the node it makes (``jb0`` is
    the top object's, the graph label, ``jb1`` the first node's)."""
    doc = json.dumps({"@graph": [
        {EX + "p": {"@value": "1"}},
        {"@id": "_:jb1", EX + "p": {"@value": "2"}}]})
    assert [str(t[0]) for t in jjsonld.parse_text(doc)] == ["jb1", "jb1"]
    assert [str(t[0]) for t in tjsonld.parse_text(doc)] == ["jb_1", "jb1"]


def test_rdfxml_urn_base_resolves_by_rfc3986():
    """Reference fault: ``urljoin`` returns a reference unresolved against
    a scheme it does not take as hierarchical (``urn:``); the port's
    RDF/XML reader resolves by RFC 3986 §5.2."""
    doc = rdfxml_doc('<rdf:Description rdf:about="item"><ex:p '
                     'rdf:resource="#frag"/></rdf:Description>',
                     base="urn:isbn:0451450523")
    assert iris(jrdfxml.parse_text(doc)) == [("item", EXNS + "p", "#frag")]
    assert iris(trdfxml.parse_text(doc)) == [
        ("urn:item", EXNS + "p", "urn:isbn:0451450523#frag")]


# -- RFC 3986 §5.4's examples ----------------------------------------------

RFC_BASE = "http://a/b/c/d;p?q"
RFC_EXAMPLES = {
    "g:h": "g:h", "g": "http://a/b/c/g", "./g": "http://a/b/c/g",
    "g/": "http://a/b/c/g/", "/g": "http://a/g", "//g": "http://g",
    "?y": "http://a/b/c/d;p?y", "g?y": "http://a/b/c/g?y",
    "#s": "http://a/b/c/d;p?q#s", "g#s": "http://a/b/c/g#s",
    "g?y#s": "http://a/b/c/g?y#s", ";x": "http://a/b/c/;x",
    "g;x": "http://a/b/c/g;x", "g;x?y#s": "http://a/b/c/g;x?y#s",
    "": "http://a/b/c/d;p?q", ".": "http://a/b/c/", "./": "http://a/b/c/",
    "..": "http://a/b/", "../": "http://a/b/", "../g": "http://a/b/g",
    "../..": "http://a/", "../../": "http://a/", "../../g": "http://a/g",
    "../../../g": "http://a/g", "../../../../g": "http://a/g",
    "/./g": "http://a/g", "/../g": "http://a/g", "g.": "http://a/b/c/g.",
    ".g": "http://a/b/c/.g", "g..": "http://a/b/c/g..",
    "..g": "http://a/b/c/..g", "./../g": "http://a/b/g",
    "./g/.": "http://a/b/c/g/", "g/./h": "http://a/b/c/g/h",
    "g/../h": "http://a/b/c/h", "g;x=1/./y": "http://a/b/c/g;x=1/y",
    "g;x=1/../y": "http://a/b/c/y", "g?y/./x": "http://a/b/c/g?y/./x",
    "g?y/../x": "http://a/b/c/g?y/../x", "g#s/./x": "http://a/b/c/g#s/./x",
    "g#s/../x": "http://a/b/c/g#s/../x", "http:g": "http:g",
}


@pytest.mark.parametrize("ref", list(RFC_EXAMPLES))
def test_resolve_gives_rfc3986_examples(ref):
    assert iri.resolve(ref, RFC_BASE) == RFC_EXAMPLES[ref]


@pytest.mark.parametrize("base", ["http://host/dir/",
                                  "http://host/dir/g.ttl", "http://host",
                                  "file:///tmp/x/g.rdf"])
def test_resolve_equals_urljoin_on_hierarchical_bases(base):
    for ref in ("name", "#frag", "/abs", "//host2/x", "../b", "a/./b/../c",
                "?q", "", "sub/", "."):
        assert iri.resolve(ref, base) == urljoin(base, ref), ref


# -- the rest of KnowledgeGraph ---------------------------------------------

GRAPH = [
    f"<{EX}a> <{EX}p> <{EX}b> .",
    f"<{EX}a> <{EX}q> \"1\"^^<{XSD}integer> .",
    f"<{EX}b> <{EX}q> \"1\"^^<{XSD}integer> .",
    f"<{EX}b> <{EX}r> \"x\"@en .",
    f"_:n <{EX}p> <{EX}c> .",
    f"<{EX}c> <{EX}r> \"y\" .",
    f"<{EX}a> <{EX}r> \"x\"@en .",
]


class FirstTwo:
    """A sampling strategy: the graph's first two triples."""

    @staticmethod
    def sample(kg, offset=0):
        triples = list(kg.triples(separate_literals=False))
        return type(kg)(triples[offset:offset + 2])


def views(kg):
    """Every read-only view of a graph, as comparable plain values."""
    p = f"{EX}q"
    return {
        "len": len(kg),
        "triples": keys(kg.triples(separate_literals=False)),
        "unique": keys(kg.triples()),
        "atoms": keys([(a,) for a in kg.atoms()]),
        "non_terminal": keys([(a,) for a in kg.non_terminal_atoms()]),
        "terminal": keys([(a,) for a in kg.terminal_atoms()]),
        "objecttype": sorted(map(str, kg.objecttype_properties())),
        "datatype": sorted(map(str, kg.datatype_properties())),
        "attributes": keys([(a,) for a in kg.attributes()]),
        "entities": keys([(a,) for a in kg.entities()]),
        "entities_no_bnodes": keys([(a,) for a in
                                    kg.entities(omit_blank_nodes=True)]),
        "properties": [str(t) for t in kg.properties()],
        "frequency": {str(k): v for k, v in kg.property_frequency().items()},
        "frequency_q": kg.property_frequency(p),
        "attribute_frequency": keys([(o,) for o, _ in
                                     kg.attribute_frequency(p)]),
        "attribute_counts": [n for _, n in kg.attribute_frequency(p, 1)],
        "sample": keys(kg.sample(FirstTwo, offset=1).triples()),
    }


@pytest.fixture
def graph_file(tmp_path):
    path = tmp_path / "g.nt"
    path.write_text("\n".join(GRAPH) + "\n")
    return str(path)


@pytest.mark.parametrize("source", ["path", "paths", "triples", "graph",
                                    "empty"])
def test_knowledge_graph_surface_matches_the_jax_package(source, graph_file):
    graphs = []
    for module in (jkg, tkg):
        base = module.KnowledgeGraph(graph_file)
        arg = {"path": graph_file, "paths": [graph_file, graph_file],
               "triples": list(base.triples(separate_literals=False)),
               "graph": base, "empty": None}[source]
        kg = module.KnowledgeGraph(arg) if arg is not None \
            else module.KnowledgeGraph()
        graphs.append(kg)
    jax, port = graphs
    if source == "empty":
        assert len(jax) == len(port) == 0
        assert port.property_frequency() == Counter() \
            == jax.property_frequency()
        return
    assert views(port) == views(jax)
    triple = next(iter(jax.triples(separate_literals=False)))
    ported = next(iter(port.triples(separate_literals=False)))
    assert (triple in jax) and (ported in port)


def test_add_and_remove_keep_the_frequencies_in_step(graph_file):
    """``add`` of a duplicate is a no-op in both packages; ``add`` and
    ``remove_triples`` move ``property_frequency`` with the store."""
    graphs = [module.KnowledgeGraph(graph_file) for module in (jkg, tkg)]
    for kg in graphs:
        first = next(iter(kg.triples(separate_literals=False)))
        kg.add(first)
        new = (first[0], first[1], first[0])
        kg.add(new)
        kg.add(new)
        assert new in kg
        kg.remove_triples([first, first])
    jax, port = graphs
    assert views(port) == views(jax)
    assert port.property_frequency(f"{EX}p") == 2


def test_sample_needs_a_strategy(graph_file):
    for module in (jkg, tkg):
        with pytest.raises(ValueError, match="Strategy cannot be left"):
            module.KnowledgeGraph(graph_file).sample()


@pytest.mark.parametrize("name,text", [
    ("g.ttl", "@prefix x: <http://x/> .\n"),
    ("g.trig", "@prefix x: <http://x/> .\nGRAPH x:g { }\n"),
    ("g.rdf", f'<rdf:RDF xmlns:rdf="{RDF}"/>\n'),
    ("g.jsonld", '{"@graph": []}\n')])
def test_a_file_without_statements_raises(name, text, tmp_path):
    """The port's stance for every serialisation, as for N-Triples: a
    non-empty file that gives no triple raises (the JAX package returns
    an empty graph for these)."""
    path = tmp_path / name
    path.write_text(text)
    assert len(jkg.KnowledgeGraph(str(path))) == 0
    with pytest.raises(ValueError, match="no valid .* statements"):
        tkg.KnowledgeGraph(str(path))
