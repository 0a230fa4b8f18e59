"""Streaming RDF/XML parser (plain or gzipped).

The port's copy of :mod:`mrgcn_tpu.data.rdfxml`. The reference accepts any
rdflib-supported RDF serialisation
(reference: mrgcn/data/io/knowledge_graph.py:45-56); RDF/XML is the classic
one — the original AIFB distribution, most OWL ontologies, and many legacy
datasets ship as ``.rdf`` / ``.owl``. This module reads it with the
N-Triples reader's term model (:mod:`mrgcn_tpu_torch.data.rdf`) and an
expat (SAX) event stream, so documents are never materialised as a DOM.
It gives the JAX package's triples in the JAX package's order. Relative
IRIs resolve by RFC 3986 (:func:`..iri.resolve`, as the Turtle and
JSON-LD readers do): on the hierarchical bases that is what the JAX
package's :func:`urllib.parse.urljoin` gives, and against a ``urn:`` base,
where ``urljoin`` returns the reference unresolved, it is the RFC's IRI.

Supported grammar (the W3C RDF/XML syntax as used in practice):

* ``rdf:Description`` and typed node elements (element name becomes an
  ``rdf:type`` triple), with ``rdf:about`` / ``rdf:ID`` / ``rdf:nodeID``
  subject selection and fresh blank nodes otherwise;
* property elements with ``rdf:resource`` / ``rdf:nodeID`` object
  references, nested node elements, text content with ``rdf:datatype``
  or inherited ``xml:lang``;
* property attributes on node and empty property elements (each becomes a
  literal triple; ``rdf:type`` attribute becomes a type triple);
* ``rdf:parseType="Resource"`` (implicit blank node),
  ``rdf:parseType="Collection"`` (rdf:first/rest/nil chain), and
  ``rdf:parseType="Literal"`` (content re-serialised as an
  ``rdf:XMLLiteral``);
* container membership shorthand ``rdf:li`` → ``rdf:_1, rdf:_2, …``
  (numbered per node element);
* ``xml:base`` / ``xml:lang`` scoping and relative-IRI resolution;
  ``rdf:ID`` on property elements is accepted (the statement triple is
  emitted; reification quads are not materialised, matching what this
  framework consumes).

Parse errors raise :class:`RDFXMLError` with the source line — ingestion is
fail-loud, like the Turtle path.
"""

from __future__ import annotations

import gzip
import io
import itertools
from typing import List, Optional, Tuple
from xml.parsers import expat
from xml.sax.saxutils import escape, quoteattr

from mrgcn_tpu_torch.data.iri import resolve
from mrgcn_tpu_torch.data.rdf import IRI, BNode, Literal

RDF_NS = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
XML_NS = "http://www.w3.org/XML/1998/namespace"

RDF_TYPE = IRI(RDF_NS + "type")
RDF_FIRST = IRI(RDF_NS + "first")
RDF_REST = IRI(RDF_NS + "rest")
RDF_NIL = IRI(RDF_NS + "nil")
RDF_XMLLITERAL = RDF_NS + "XMLLiteral"

# rdf:* attributes that are syntax, not property attributes
_SYNTAX_ATTRS = {RDF_NS + a for a in
                 ("about", "ID", "nodeID", "resource", "datatype",
                  "parseType", "RDF", "Description", "li", "aboutEach",
                  "aboutEachPrefix", "bagID")}
# node/property element names that are illegal as such
_ILLEGAL_NODE = {RDF_NS + a for a in ("RDF", "ID", "about", "bagID",
                                      "parseType", "resource", "nodeID",
                                      "datatype", "li", "aboutEach",
                                      "aboutEachPrefix")}


class RDFXMLError(ValueError):
    pass


class _Frame:
    """One open XML element: either a node element or a property element."""

    __slots__ = ("kind", "subject", "predicate", "base", "lang", "datatype",
                 "text", "li_counter", "reify_seen", "collection",
                 "parse_type", "xml_depth", "xml_parts", "empty",
                 "object_seen", "attr_object")

    def __init__(self, kind: str, base: str, lang: Optional[str]):
        self.kind = kind                # "node" | "property" | "xmlliteral"
        self.subject = None             # node frames: the subject term
        self.predicate = None           # property frames: predicate IRI
        self.base = base
        self.lang = lang
        self.datatype = None
        self.text: List[str] = []
        self.li_counter = 0
        self.collection: Optional[List] = None
        self.parse_type = None
        self.xml_parts: Optional[List[str]] = None
        self.xml_depth = 0
        self.empty = True               # no child elements seen yet
        self.object_seen = False        # property got an object already
        self.attr_object = None         # object fixed by rdf:resource/nodeID


class _Parser:
    def __init__(self, base_iri: str = ""):
        self.triples: List[Tuple] = []
        self.stack: List[_Frame] = []
        self.base = base_iri
        self._bnode_ids = itertools.count()
        self._nodeid_map = {}
        self._parser = expat.ParserCreate(namespace_separator=" ")
        self._parser.buffer_text = True
        self._parser.StartElementHandler = self._start
        self._parser.EndElementHandler = self._end
        self._parser.CharacterDataHandler = self._chars

    # -- helpers ----------------------------------------------------------

    def _err(self, msg: str) -> RDFXMLError:
        return RDFXMLError(
            f"line {self._parser.CurrentLineNumber}: {msg}")

    def _fresh_bnode(self) -> BNode:
        return BNode(f"rxg{next(self._bnode_ids)}")

    def _named_bnode(self, node_id: str) -> BNode:
        # keep document nodeIDs distinct from generated ones
        if node_id not in self._nodeid_map:
            self._nodeid_map[node_id] = BNode(f"rxn-{node_id}")
        return self._nodeid_map[node_id]

    def _resolve(self, iri: str, base: str) -> IRI:
        if not base:
            return IRI(iri)
        # the empty (same-document) reference gives the base without its
        # fragment
        return IRI(resolve(iri, base))

    def _split(self, name: str) -> Tuple[str, str]:
        """expat gives 'nsuri local' (or bare name when unprefixed)."""
        if " " in name:
            ns, local = name.rsplit(" ", 1)
            return ns, local
        return "", name

    def _emit(self, s, p, o):
        self.triples.append((s, p, o))

    # -- expat handlers ---------------------------------------------------

    def _start(self, name, attrs):
        parent = self.stack[-1] if self.stack else None

        # inside parseType="Literal": record raw XML, no RDF interpretation
        if parent is not None and parent.kind == "xmlliteral":
            frame = _Frame("xmlliteral", parent.base, parent.lang)
            self.stack.append(frame)
            self._xml_open(name, attrs)
            return

        ns, local = self._split(name)
        full = ns + local if ns else local

        base = parent.base if parent else self.base
        lang = parent.lang if parent else None
        if (XML_NS + " base") in attrs:
            base = resolve(attrs[XML_NS + " base"], base) if base \
                else attrs[XML_NS + " base"]
        if (XML_NS + " lang") in attrs:
            lang = attrs[XML_NS + " lang"] or None

        # document element rdf:RDF is a transparent wrapper
        if full == RDF_NS + "RDF" and (
                parent is None or parent.kind not in ("node", "property")):
            frame = _Frame("root", base, lang)
            self.stack.append(frame)
            return

        if parent is None or parent.kind in ("root",):
            self._start_node(full, attrs, base, lang, None)
        elif parent.kind == "node":
            self._start_property(full, attrs, base, lang, parent)
        elif parent.kind == "property":
            if parent.parse_type == "Collection":
                item = self._start_node(full, attrs, base, lang, None)
                parent.collection.append(item)
            else:
                if parent.object_seen or parent.attr_object is not None:
                    raise self._err(
                        f"property element <{full}> already has an object")
                obj = self._start_node(full, attrs, base, lang, None)
                subj = self._node_parent_subject(parent)
                self._emit(subj, parent.predicate, obj)
                parent.object_seen = True
        else:  # pragma: no cover - defensive
            raise self._err(f"unexpected element <{full}>")

    def _node_parent_subject(self, prop_frame: _Frame):
        """The subject a property frame attaches to (set at creation)."""
        return prop_frame.subject

    def _start_node(self, full, attrs, base, lang, forced_subject):
        """Open a node element; returns its subject term."""
        if full in _ILLEGAL_NODE:
            raise self._err(f"<{full}> is not a valid node element")

        about = attrs.get(RDF_NS + " about")
        rid = attrs.get(RDF_NS + " ID")
        node_id = attrs.get(RDF_NS + " nodeID")
        if sum(x is not None for x in (about, rid, node_id)) > 1:
            raise self._err(
                "at most one of rdf:about / rdf:ID / rdf:nodeID allowed")

        if forced_subject is not None:
            subject = forced_subject
        elif about is not None:
            subject = self._resolve(about, base)
        elif rid is not None:
            subject = self._resolve("#" + rid, base)
        elif node_id is not None:
            subject = self._named_bnode(node_id)
        else:
            subject = self._fresh_bnode()

        frame = _Frame("node", base, lang)
        frame.subject = subject
        self.stack.append(frame)

        if full != RDF_NS + "Description":
            self._emit(subject, RDF_TYPE, IRI(full))

        # property attributes
        for aname, avalue in attrs.items():
            ans, alocal = self._split(aname)
            afull = (ans + alocal) if ans else alocal
            if ans == XML_NS or afull in _SYNTAX_ATTRS or ans == "":
                # unprefixed non-xml attributes are not property attrs
                continue
            if afull == RDF_NS + "type":
                self._emit(subject, RDF_TYPE, self._resolve(avalue, base))
            elif afull.startswith(RDF_NS + "_") or not afull.startswith(
                    RDF_NS) or afull in (RDF_NS + "value",):
                self._emit(subject, IRI(afull), Literal(avalue, lang))
        return subject

    def _start_property(self, full, attrs, base, lang, parent):
        if full == RDF_NS + "Description" or (
                full in _ILLEGAL_NODE and full != RDF_NS + "li"):
            raise self._err(f"<{full}> is not a valid property element")
        if full == RDF_NS + "li":
            parent.li_counter += 1
            predicate = IRI(f"{RDF_NS}_{parent.li_counter}")
        else:
            predicate = IRI(full)

        frame = _Frame("property", base, lang)
        frame.predicate = predicate
        frame.subject = parent.subject
        frame.datatype = attrs.get(RDF_NS + " datatype")
        self.stack.append(frame)

        ptype = attrs.get(RDF_NS + " parseType")
        resource = attrs.get(RDF_NS + " resource")
        node_id = attrs.get(RDF_NS + " nodeID")

        prop_attrs = []
        for aname, avalue in attrs.items():
            ans, alocal = self._split(aname)
            afull = (ans + alocal) if ans else alocal
            if ans in ("", XML_NS) or afull in _SYNTAX_ATTRS:
                continue
            prop_attrs.append((afull, avalue))

        if ptype is not None:
            frame.parse_type = ptype
            if ptype == "Resource":
                obj = self._fresh_bnode()
                self._emit(parent.subject, predicate, obj)
                # behave like a node frame for children
                frame.kind = "node"
                frame.subject = obj
            elif ptype == "Collection":
                frame.collection = []
            elif ptype == "Literal":
                frame.kind = "xmlliteral"
                frame.xml_parts = []
            else:
                # unknown parseType is treated as Literal per the spec
                frame.kind = "xmlliteral"
                frame.xml_parts = []
                frame.parse_type = "Literal"
            return

        if resource is not None and node_id is not None:
            raise self._err("rdf:resource and rdf:nodeID are exclusive")
        if resource is not None:
            frame.attr_object = self._resolve(resource, base)
        elif node_id is not None:
            frame.attr_object = self._named_bnode(node_id)

        if prop_attrs:
            # empty property element with property attributes: implicit
            # blank node object carrying those attributes
            obj = frame.attr_object
            if obj is None:
                obj = self._fresh_bnode()
                frame.attr_object = obj
            for afull, avalue in prop_attrs:
                if afull == RDF_NS + "type":
                    self._emit(obj, RDF_TYPE, self._resolve(avalue, base))
                else:
                    self._emit(obj, IRI(afull), Literal(avalue, lang))

    def _chars(self, data):
        if not self.stack:
            return
        frame = self.stack[-1]
        if frame.kind == "xmlliteral":
            if frame.xml_parts is not None:
                frame.xml_parts.append(escape(data))
            else:  # nested element inside the literal
                self._xml_text(data)
        elif frame.kind == "property":
            frame.text.append(data)
        # whitespace between elements elsewhere is ignored

    def _end(self, name):
        frame = self.stack.pop()
        parent = self.stack[-1] if self.stack else None

        if frame.kind == "xmlliteral" and frame.xml_parts is None:
            # closing a raw element inside a parseType=Literal body
            self._xml_close(name)
            return

        if frame.kind == "root" or frame.kind == "node":
            # node elements emit nothing at close (triples were emitted as
            # children arrived); parseType=Resource frames were retyped to
            # node and already emitted their statement
            return

        if frame.kind == "xmlliteral":
            # a parseType=Literal property element closing
            xml = "".join(frame.xml_parts)
            self._emit(frame.subject, frame.predicate,
                       Literal(xml, None, RDF_XMLLITERAL))
            return

        # property frame
        if frame.parse_type == "Collection":
            items = frame.collection or []
            if not items:
                self._emit(frame.subject, frame.predicate, RDF_NIL)
            else:
                heads = [self._fresh_bnode() for _ in items]
                self._emit(frame.subject, frame.predicate, heads[0])
                for i, item in enumerate(items):
                    self._emit(heads[i], RDF_FIRST, item)
                    rest = heads[i + 1] if i + 1 < len(items) else RDF_NIL
                    self._emit(heads[i], RDF_REST, rest)
            return

        if frame.attr_object is not None:
            self._emit(frame.subject, frame.predicate, frame.attr_object)
            return
        if frame.object_seen:
            return

        text = "".join(frame.text)
        if frame.datatype is not None:
            obj = Literal(text, None, frame.datatype)
        else:
            obj = Literal(text, frame.lang)
        self._emit(frame.subject, frame.predicate, obj)

    # -- raw XML reconstruction for rdf:XMLLiteral ------------------------

    def _literal_frame(self) -> _Frame:
        for frame in reversed(self.stack):
            if frame.xml_parts is not None:
                return frame
        raise self._err("XML literal content outside a literal")  # pragma: no cover

    def _xml_open(self, name, attrs):
        holder = self._literal_frame()
        ns, local = self._split(name)
        tag = local if not ns else f"ns:{local}"
        parts = [f"<{tag}"]
        if ns:
            parts.append(f' xmlns:ns={quoteattr(ns)}')
        for aname, avalue in attrs.items():
            ans, alocal = self._split(aname)
            aattr = alocal if not ans else f"ns:{alocal}"
            parts.append(f" {aattr}={quoteattr(avalue)}")
        parts.append(">")
        holder.xml_parts.append("".join(parts))

    def _xml_text(self, data):
        self._literal_frame().xml_parts.append(escape(data))

    def _xml_close(self, name):
        holder = self._literal_frame()
        ns, local = self._split(name)
        tag = local if not ns else f"ns:{local}"
        holder.xml_parts.append(f"</{tag}>")

    # -- parsing ----------------------------------------------------------

    def parse(self, data: bytes) -> List[Tuple]:
        try:
            self._parser.Parse(data, True)
        except expat.ExpatError as e:
            raise RDFXMLError(f"XML error: {e}") from None
        return self.triples


def parse_bytes(data: bytes, base_iri: str = "") -> List[Tuple]:
    return _Parser(base_iri).parse(data)


def parse_text(text: str, base_iri: str = "") -> List[Tuple]:
    return parse_bytes(text.encode("utf-8"), base_iri)


def parse_file(path: str, base_iri: str = "") -> List[Tuple]:
    opener = gzip.open if path.endswith(".gz") else io.open
    with opener(path, "rb") as f:
        return parse_bytes(f.read(), base_iri)
