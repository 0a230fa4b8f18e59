"""Streaming-friendly Turtle (TTL) and TriG parser.

The port's copy of :mod:`mrgcn_tpu.data.turtle`. The reference accepts any
rdflib-supported RDF serialisation, gzipped or not
(reference: mrgcn/data/io/knowledge_graph.py:45-56); this module reads
Turtle with the N-Triples reader's term model
(:mod:`mrgcn_tpu_torch.data.rdf`). It gives the JAX package's triples in
the JAX package's order, with two faults of that copy mended:

* relative IRIs resolve by RFC 3986 (:func:`..iri.resolve`), where the
  JAX package cuts the base at its last ``/`` (``@base
  <http://example.com>`` + ``<alice>`` gave ``http://alice``; ``../``
  stayed in the IRI);
* the blank nodes it makes (``tb0``, ``tb1``, ...) stay apart from a
  document's own ``_:tb0`` (:func:`..rdf.keep_generated_apart`), where
  the JAX package merges the two nodes.

Supported grammar (the subset real-world datasets use):

* ``@prefix`` / ``@base`` directives and their SPARQL forms
  (``PREFIX`` / ``BASE``, case-insensitive, no trailing dot);
* prefixed names with numeric-escape-free local parts (incl. ``%``-encoded
  and ``\\``-escaped local characters), the ``a`` keyword;
* predicate lists (``;``), object lists (``,``);
* IRIs (resolved against the base), blank nodes (``_:x``, ``[]``, and
  bracketed anonymous nodes with property lists), collections ``( ... )``
  expanded to rdf:first/rest/nil chains;
* literals: short/long single/double-quoted strings with escapes, language
  tags, ``^^`` datatypes, and the numeric / boolean shorthands typed as
  xsd:integer / xsd:decimal / xsd:double / xsd:boolean;
* TriG (``trig=True``): named graph blocks ``{...}``, ``GRAPH label {...}``
  and ``label {...}`` — graph labels parsed and IGNORED (every statement
  lands in one graph), the same posture as the N-Quads reader.

Parse errors raise :class:`TurtleError` with the line number — ingestion is
fail-loud (a format mistake must not silently produce an empty graph).
"""

from __future__ import annotations

import gzip
import io
import itertools
import re
from typing import Iterator, List, Optional, Tuple

from mrgcn_tpu_torch.data.iri import resolve
from mrgcn_tpu_torch.data.ntriples import _unescape
from mrgcn_tpu_torch.data.rdf import IRI, BNode, Literal, keep_generated_apart

RDF_NS = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
XSD_NS = "http://www.w3.org/2001/XMLSchema#"
RDF_TYPE = IRI(RDF_NS + "type")
RDF_FIRST = IRI(RDF_NS + "first")
RDF_REST = IRI(RDF_NS + "rest")
RDF_NIL = IRI(RDF_NS + "nil")


class TurtleError(ValueError):
    pass


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<iriref><[^<>"{}|^`\\\x00-\x20]*>)
  | (?P<string>
        \"\"\"(?:[^"\\]|\\.|"(?!""))*\"\"\"
      | '''(?:[^'\\]|\\.|'(?!''))*'''
      | "(?:[^"\\\n]|\\.)*"
      | '(?:[^'\\\n]|\\.)*'
    )
  | (?P<langtag>@[a-zA-Z]+(?:-[a-zA-Z0-9]+)*)
  | (?P<dtype>\^\^)
  | (?P<number>[+-]?(?:(?:\d+\.\d*|\.\d+|\d+)[eE][+-]?\d+
                     |\d+\.\d+|\.\d+|\d+))
  | (?P<bnode>_:[^\s;,.\])}]+)
  | (?P<punct>[;,.\[\](){}])
  | (?P<pname>(?:[^\s;,"'<>\[\](){}#^@]|%[0-9A-Fa-f]{2}|\\[-_~.!$&'()*+,;=/?\#@%])*
              :(?:[^\s;,"'<>\[\](){}^#@]|%[0-9A-Fa-f]{2}|\\[-_~.!$&'()*+,;=/?\#@%])*)
  | (?P<keyword>[A-Za-z][A-Za-z0-9_]*)
""", re.VERBOSE)


def _tokenize(text: str) -> Iterator[Tuple[str, str, int]]:
    """(kind, value, line) tokens; whitespace/comments dropped."""
    pos, line = 0, 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == pos:
            snippet = text[pos:pos + 20].splitlines()[0]
            raise TurtleError(f"line {line}: cannot tokenize near "
                              f"{snippet!r}")
        kind = m.lastgroup
        value = m.group()
        if kind == "pname":
            # PN_LOCAL must not end with unescaped dots — a statement-final
            # "ex:o." tokenizes greedily, so peel trailing dots back off
            dots = 0
            while value.endswith(".") and not value.endswith("\\."):
                value = value[:-1]
                dots += 1
            yield kind, value, line
            for _ in range(dots):
                yield "punct", ".", line
        elif kind not in ("ws", "comment"):
            yield kind, value, line
        line += m.group().count("\n")
        pos = m.end()


class _Parser:
    def __init__(self, text: str):
        self.tokens = _tokenize(text)
        self.pushed: List[Tuple[str, str, int]] = []
        self.prefixes = {}
        self.base = ""
        self.line = 1
        self._bnode_ids = itertools.count()
        self._generated: List[BNode] = []
        self._labels = set()
        self.triples: List[Tuple] = []

    # -- token stream -----------------------------------------------------
    def next(self, required=True) -> Optional[Tuple[str, str, int]]:
        if self.pushed:
            tok = self.pushed.pop()
        else:
            tok = next(self.tokens, None)
        if tok is None:
            if required:
                raise TurtleError(f"line {self.line}: unexpected end of "
                                  "input")
            return None
        self.line = tok[2]
        return tok

    def push(self, tok):
        self.pushed.append(tok)

    def expect_punct(self, chars: str) -> str:
        kind, value, line = self.next()
        if kind != "punct" or value not in chars:
            raise TurtleError(f"line {line}: expected one of {chars!r}, "
                              f"got {value!r}")
        return value

    # -- terms ------------------------------------------------------------
    def _resolve(self, iri: str) -> str:
        return resolve(iri, self.base) if self.base else iri

    def _pname_to_iri(self, pname: str, line: int) -> IRI:
        prefix, _, local = pname.partition(":")
        if prefix not in self.prefixes:
            raise TurtleError(f"line {line}: unknown prefix {prefix!r}")
        local = re.sub(r"\\(.)", r"\1", local)
        return IRI(self.prefixes[prefix] + local)

    def fresh_bnode(self) -> BNode:
        node = BNode(f"tb{next(self._bnode_ids)}")
        self._generated.append(node)
        return node

    def document_bnode(self, value: str) -> BNode:
        self._labels.add(value[2:])
        return BNode(value[2:])

    def _string_value(self, raw: str) -> str:
        if raw[:3] in ('"""', "'''"):
            return _unescape(raw[3:-3])
        return _unescape(raw[1:-1])

    def parse_literal(self, raw: str) -> Literal:
        value = self._string_value(raw)
        tok = self.next(required=False)
        if tok is None:
            return Literal(value)
        kind, tval, line = tok
        if kind == "langtag":
            return Literal(value, language=tval[1:])
        if kind == "dtype":
            dt = self.parse_iri_term()
            return Literal(value, datatype=str(dt))
        self.push(tok)
        return Literal(value)

    def parse_iri_term(self) -> IRI:
        kind, value, line = self.next()
        if kind == "iriref":
            return IRI(self._resolve(_unescape(value[1:-1])))
        if kind == "pname":
            return self._pname_to_iri(value, line)
        raise TurtleError(f"line {line}: expected IRI, got {value!r}")

    def parse_object(self):
        kind, value, line = self.next()
        if kind == "iriref":
            return IRI(self._resolve(_unescape(value[1:-1])))
        if kind == "pname":
            return self._pname_to_iri(value, line)
        if kind == "bnode":
            return self.document_bnode(value)
        if kind == "string":
            self.push((kind, value, line))
            self.next()
            return self.parse_literal(value)
        if kind == "number":
            if re.search(r"[eE]", value):
                dt = XSD_NS + "double"
            elif "." in value:
                dt = XSD_NS + "decimal"
            else:
                dt = XSD_NS + "integer"
            return Literal(value, datatype=dt)
        if kind == "keyword" and value in ("true", "false"):
            return Literal(value, datatype=XSD_NS + "boolean")
        if kind == "punct" and value == "[":
            node = self.fresh_bnode()
            tok = self.next()
            if tok[0] == "punct" and tok[1] == "]":
                return node
            self.push(tok)
            self.parse_predicate_object_list(node)
            self.expect_punct("]")
            return node
        if kind == "punct" and value == "(":
            return self.parse_collection()
        raise TurtleError(f"line {line}: unexpected object token "
                          f"{value!r}")

    def parse_collection(self):
        items = []
        while True:
            tok = self.next()
            if tok[0] == "punct" and tok[1] == ")":
                break
            self.push(tok)
            items.append(self.parse_object())
        if not items:
            return RDF_NIL
        head = self.fresh_bnode()
        node = head
        for i, item in enumerate(items):
            self.triples.append((node, RDF_FIRST, item))
            nxt = self.fresh_bnode() if i + 1 < len(items) else RDF_NIL
            self.triples.append((node, RDF_REST, nxt))
            node = nxt
        return head

    # -- statements ---------------------------------------------------------
    def parse_verb(self):
        kind, value, line = self.next()
        if kind == "keyword" and value == "a":
            return RDF_TYPE
        self.push((kind, value, line))
        return self.parse_iri_term()

    def parse_predicate_object_list(self, subject):
        while True:
            verb = self.parse_verb()
            while True:
                obj = self.parse_object()
                self.triples.append((subject, verb, obj))
                tok = self.next(required=False)
                if tok is None:
                    return
                if tok[0] == "punct" and tok[1] == ",":
                    continue
                self.push(tok)
                break
            tok = self.next(required=False)
            if tok is None:
                return
            if tok[0] == "punct" and tok[1] == ";":
                # a ; may be followed by . or ] — or } inside a TriG
                # graph block (trailing semicolon)
                nxt = self.next(required=False)
                if nxt is None:
                    return
                self.push(nxt)
                if nxt[0] == "punct" and nxt[1] in ".]}":
                    return
                continue
            self.push(tok)
            return

    def parse_at_directive(self, value, line):
        lowered = value.lower()
        if lowered == "@prefix":
            ktok = self.next()
            if ktok[0] == "pname" and ktok[1].endswith(":"):
                name = ktok[1][:-1]
            elif ktok[0] == "keyword":
                # "p" ":" may tokenize oddly; treat as error
                raise TurtleError(f"line {ktok[2]}: bad @prefix")
            else:
                raise TurtleError(f"line {ktok[2]}: bad @prefix")
            iri = self.parse_iri_term()
            self.prefixes[name] = str(iri)
        elif lowered == "@base":
            iri = self.parse_iri_term()
            self.base = str(iri)
        else:
            raise TurtleError(f"line {line}: unknown directive {value!r}")
        self.expect_punct(".")

    def parse_subject(self):
        kind, value, line = self.next()
        if kind == "iriref":
            return IRI(self._resolve(_unescape(value[1:-1])))
        if kind == "pname":
            return self._pname_to_iri(value, line)
        if kind == "bnode":
            return self.document_bnode(value)
        if kind == "punct" and value == "[":
            node = self.fresh_bnode()
            tok = self.next()
            if tok[0] == "punct" and tok[1] == "]":
                return node
            self.push(tok)
            self.parse_predicate_object_list(node)
            self.expect_punct("]")
            return node
        if kind == "punct" and value == "(":
            return self.parse_collection()
        raise TurtleError(f"line {line}: unexpected subject token "
                          f"{value!r}")

    def parse_graph_block(self):
        """TriG ``{ triples ('.' triples?)* '.'? }`` — graph statements land
        in the same triple list (the graph label is parsed and ignored,
        matching the N-Quads posture)."""
        while True:
            tok = self.next()
            if tok[0] == "punct" and tok[1] == "}":
                return
            self.push(tok)
            subject = self.parse_subject()
            self.parse_predicate_object_list(subject)
            # the final statement's dot is optional before '}'
            tok = self.next()
            if tok[0] == "punct" and tok[1] == "}":
                return
            if not (tok[0] == "punct" and tok[1] == "."):
                raise TurtleError(f"line {tok[2]}: expected '.' or '}}' in "
                                  f"graph block, got {tok[1]!r}")

    def run(self, trig: bool = False) -> List[Tuple]:
        while True:
            tok = self.next(required=False)
            if tok is None:
                break
            kind, value, line = tok
            if kind == "langtag" and value.lower() in ("@prefix", "@base"):
                self.parse_at_directive(value, line)
                continue
            if kind == "keyword" and value.lower() in ("prefix", "base"):
                if value.lower() == "prefix":
                    ktok = self.next()
                    if ktok[0] != "pname" or not ktok[1].endswith(":"):
                        raise TurtleError(
                            f"line {ktok[2]}: bad PREFIX declaration")
                    name = ktok[1][:-1]
                    iri = self.parse_iri_term()
                    self.prefixes[name] = str(iri)
                else:
                    self.base = str(self.parse_iri_term())
                nxt = self.next(required=False)
                if nxt is not None and not (nxt[0] == "punct"
                                            and nxt[1] == "."):
                    self.push(nxt)
                continue
            if trig:
                # TriG block forms: '{...}', 'GRAPH label {...}',
                # 'label {...}'
                if kind == "punct" and value == "{":
                    self.parse_graph_block()
                    continue
                if kind == "keyword" and value.lower() == "graph":
                    self.parse_subject()        # the label (IRI or bnode)
                    self.expect_punct("{")
                    self.parse_graph_block()
                    continue
            self.push(tok)
            subject = self.parse_subject()
            if trig:
                nxt = self.next(required=False)
                if nxt is not None and nxt[0] == "punct" and nxt[1] == "{":
                    # the "subject" was a graph label
                    self.parse_graph_block()
                    continue
                if nxt is not None:
                    self.push(nxt)
            self.parse_predicate_object_list(subject)
            self.expect_punct(".")
        return keep_generated_apart(self.triples, self._generated,
                                    self._labels, "tb")


def parse_text(text: str, trig: bool = False) -> List[Tuple]:
    return _Parser(text).run(trig=trig)


def parse_file(path: str, trig: bool = False) -> List[Tuple]:
    if path.endswith(".gz"):
        with io.TextIOWrapper(gzip.open(path, "rb"),
                              encoding="utf-8") as f:
            return parse_text(f.read(), trig=trig)
    with open(path, "r", encoding="utf-8") as f:
        return parse_text(f.read(), trig=trig)
