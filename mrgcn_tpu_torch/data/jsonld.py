"""JSON-LD reader (deliberate, fail-loud subset).

The port's copy of :mod:`mrgcn_tpu.data.jsonld`. The reference accepts
JSON-LD through rdflib (reference: mrgcn/data/io/knowledge_graph.py:45-56).
This module covers the
JSON-LD 1.0 constructs real KG dumps use, WITHOUT network access (zero
egress — remote ``@context`` URLs fail loudly) and without the long tail of
the 1.1 API. Everything outside the subset raises :class:`JsonLdError`
naming the construct — ingestion must never silently drop statements.

Supported:

* inline ``@context`` (dict, or array of dicts): term -> IRI string
  mappings, expanded term definitions with ``@id``, ``@type`` (coercion to
  ``@id`` or a datatype), ``@language``, ``@container`` (``@list`` /
  ``@set``), plus ``@vocab``, ``@base``, default ``@language``, and
  compact IRIs (``prefix:suffix``) in both term definitions and data;
* node objects: ``@id`` (IRI or ``_:`` blank node; fresh blank node when
  absent), ``@type`` (string or array -> ``rdf:type`` triples), nested
  node objects (emitted and linked), node references ``{"@id": ...}``;
* value objects ``{"@value": ..., "@type"|"@language": ...}``; JSON
  scalars typed per JSON-LD rules (string -> plain / context language,
  int -> xsd:integer, float -> xsd:double, bool -> xsd:boolean);
* arrays as multi-values, ``@list`` (and list containers) expanded to
  ``rdf:first``/``rdf:rest``/``rdf:nil`` chains;
* ``@graph`` at the top level or inside a node object with only
  ``@id``/``@context`` siblings — the graph label is parsed and IGNORED
  (every statement lands in one graph, the N-Quads/TriG posture).

Fails loudly on: remote/string contexts, ``@reverse``, ``@nest``,
``@included``, ``@index`` containers, ``@json`` datatypes, property-scoped
contexts, relative IRIs with no ``@base``, and cyclic IRI mappings
(``{"a": "a:x"}``).

It gives the JAX package's triples in the JAX package's order and its
lexical forms for JSON numbers and booleans, with three faults of that
copy mended: relative IRIs resolve against ``@base`` by RFC 3986
(:func:`..iri.resolve`; the JAX package turns ``@base
"http://example.com"`` + ``"alice"`` into ``http://alice``); a cyclic IRI
mapping raises :class:`JsonLdError` naming the term (the JAX package
recurses until ``RecursionError``); and the blank nodes it makes (``jb0``,
``jb1``, ...) stay apart from a document's own ``_:jb0``
(:func:`..rdf.keep_generated_apart`; the JAX package merges the two).
"""

from __future__ import annotations

import gzip
import itertools
import json
from typing import Dict, List, Optional, Tuple

from mrgcn_tpu_torch.data.iri import is_absolute, resolve
from mrgcn_tpu_torch.data.rdf import IRI, BNode, Literal, keep_generated_apart

RDF_NS = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
XSD_NS = "http://www.w3.org/2001/XMLSchema#"
RDF_TYPE = IRI(RDF_NS + "type")
RDF_FIRST = IRI(RDF_NS + "first")
RDF_REST = IRI(RDF_NS + "rest")
RDF_NIL = IRI(RDF_NS + "nil")

_UNSUPPORTED_KEYWORDS = ("@reverse", "@nest", "@included", "@index",
                         "@direction", "@version", "@propagate",
                         "@protected", "@import")


class JsonLdError(ValueError):
    pass


class _Context:
    """One resolved (non-remote) JSON-LD context."""

    def __init__(self):
        self.terms: Dict[str, dict] = {}
        self.vocab: Optional[str] = None
        self.base: Optional[str] = None
        self.language: Optional[str] = None

    def copy(self) -> "_Context":
        c = _Context()
        c.terms = dict(self.terms)
        c.vocab, c.base, c.language = self.vocab, self.base, self.language
        return c

    def apply(self, ctx) -> "_Context":
        """Merge a ``@context`` value into a copy of this context."""
        out = self.copy()
        parts = ctx if isinstance(ctx, list) else [ctx]
        for part in parts:
            if part is None:
                out = _Context()
                continue
            if isinstance(part, str):
                raise JsonLdError(
                    f"remote @context {part!r} is not supported (zero "
                    "egress); inline the context object")
            if not isinstance(part, dict):
                raise JsonLdError(f"unsupported @context entry: {part!r}")
            for key, val in part.items():
                if key == "@vocab":
                    out.vocab = val
                elif key == "@base":
                    out.base = val
                elif key == "@language":
                    out.language = val
                elif key.startswith("@"):
                    raise JsonLdError(
                        f"unsupported @context keyword {key!r}")
                elif isinstance(val, str):
                    out.terms[key] = {"@id": val}
                elif isinstance(val, dict):
                    bad = [k for k in val if k not in
                           ("@id", "@type", "@language", "@container")]
                    if bad:
                        raise JsonLdError(
                            f"unsupported term-definition keys {bad} for "
                            f"term {key!r}")
                    container = val.get("@container")
                    if container not in (None, "@list", "@set"):
                        raise JsonLdError(
                            f"unsupported @container {container!r} for "
                            f"term {key!r}")
                    out.terms[key] = dict(val)
                elif val is None:
                    out.terms.pop(key, None)
                else:
                    raise JsonLdError(
                        f"unsupported term definition for {key!r}: "
                        f"{val!r}")
        return out

    # -- IRI expansion --------------------------------------------------
    def expand_iri(self, value: str, vocab: bool = False,
                   seen: frozenset = frozenset()) -> str:
        """Expand a term / compact IRI / IRI reference. ``vocab=True``
        resolves bare terms against term definitions and ``@vocab``
        (predicate/type position); otherwise against ``@base``. ``seen``:
        the terms whose mapping this expansion is inside, so that a cycle
        raises."""
        if value.startswith("@"):
            return value                      # keyword, caller handles
        if value in self.terms and vocab:
            mapped = self.terms[value].get("@id")
            if mapped is not None:
                if mapped.startswith("@"):
                    return mapped             # keyword alias
                return self.expand_iri(mapped, True,
                                       self._enter(value, seen))
            # expanded term definition without @id (coercion only, e.g.
            # {"age": {"@type": "xsd:integer"}}): the term itself expands
            # against @vocab below, per JSON-LD 1.0
        prefix, sep, suffix = value.partition(":")
        if sep and not suffix.startswith("//"):
            if prefix == "_":                 # blank node
                return value
            if prefix in self.terms:
                head = self.terms[prefix].get("@id")
                if head is not None and not head.startswith("@"):
                    return self.expand_iri(
                        head, True, self._enter(prefix, seen)) + suffix
        if is_absolute(value):
            return value
        if vocab and self.vocab is not None:
            return self.vocab + value
        if self.base is not None:
            return resolve(value, self.base)
        raise JsonLdError(
            f"cannot expand relative IRI {value!r}: no "
            f"{'@vocab' if vocab else '@base'} in context")

    @staticmethod
    def _enter(term: str, seen: frozenset) -> frozenset:
        if term in seen:
            raise JsonLdError(f"cyclic IRI mapping: term {term!r} expands "
                              "through itself")
        return seen | {term}


class _Parser:
    def __init__(self):
        self.triples: List[Tuple] = []
        self._bnode_ids = itertools.count()
        self.generated: List[BNode] = []
        self.labels = set()

    def fresh_bnode(self) -> BNode:
        node = BNode(f"jb{next(self._bnode_ids)}")
        self.generated.append(node)
        return node

    def subject_term(self, value: str, ctx: _Context):
        expanded = ctx.expand_iri(value, vocab=False)
        if expanded.startswith("_:"):
            self.labels.add(expanded[2:])
            return BNode(expanded[2:])
        return IRI(expanded)

    # -- values ----------------------------------------------------------
    @staticmethod
    def _expand_datatype(coerce, ctx: _Context) -> Optional[str]:
        """A term definition's @type as a datatype IRI, fully expanded.
        ``@id``/``@vocab`` coercions are IRI coercions, not datatypes —
        they apply to string values only (handled in object_term) and
        return None here so non-string scalars keep their JSON typing."""
        if coerce is None or coerce in ("@id", "@vocab"):
            return None
        if coerce.startswith("@"):
            raise JsonLdError(f"unsupported @type coercion {coerce!r}")
        return ctx.expand_iri(coerce, vocab=True)

    def scalar_literal(self, value, term_def: dict, ctx: _Context):
        """JSON scalar -> Literal per the term's coercion / context."""
        coerce = self._expand_datatype(term_def.get("@type"), ctx)
        if isinstance(value, bool):
            return Literal("true" if value else "false",
                           datatype=coerce or XSD_NS + "boolean")
        if isinstance(value, int):
            return Literal(str(value), datatype=coerce or XSD_NS + "integer")
        if isinstance(value, float):
            # repr() is a valid xsd:double lexical form and round-trips;
            # the numeric vectorizer parses it with float(str(node))
            return Literal(repr(value), datatype=coerce or XSD_NS + "double")
        # string
        if coerce is not None:
            return Literal(value, datatype=coerce)
        lang = term_def.get("@language", ctx.language)
        return Literal(value, language=lang)

    def value_object(self, obj: dict, ctx: _Context):
        bad = [k for k in obj if k not in ("@value", "@type", "@language",
                                           "@index")]
        if bad:
            raise JsonLdError(f"unsupported keys {bad} in value object")
        if "@index" in obj:
            raise JsonLdError("@index is not supported")
        value = obj["@value"]
        if value is None:
            raise JsonLdError(
                "@value: null is not supported (JSON-LD drops such "
                "statements; drop it from the input instead)")
        if "@type" in obj:
            dt = obj["@type"]
            if dt == "@json":
                raise JsonLdError("@json datatypes are not supported")
            if not isinstance(dt, str) or dt.startswith("@"):
                raise JsonLdError(f"unsupported @type {dt!r} in value "
                                  f"object")
            lex = value if isinstance(value, str) else \
                str(self.scalar_literal(value, {}, ctx))
            return Literal(lex, datatype=ctx.expand_iri(dt, vocab=True))
        if "@language" in obj:
            if not isinstance(value, str):
                raise JsonLdError("@language on a non-string @value")
            return Literal(value, language=obj["@language"])
        if isinstance(value, str):
            # explicit value objects do NOT inherit the context default
            # language (JSON-LD expansion applies it to bare strings only)
            return Literal(value)
        return self.scalar_literal(value, {}, ctx)

    def list_node(self, items: list, term_def: dict, ctx: _Context):
        terms = [self.object_term(i, term_def, ctx) for i in items]
        if not terms:
            return RDF_NIL
        head = self.fresh_bnode()
        node = head
        for i, t in enumerate(terms):
            self.triples.append((node, RDF_FIRST, t))
            nxt = self.fresh_bnode() if i + 1 < len(terms) else RDF_NIL
            self.triples.append((node, RDF_REST, nxt))
            node = nxt
        return head

    def object_term(self, value, term_def: dict, ctx: _Context):
        """One object position -> an RDF term (emitting nested triples)."""
        if isinstance(value, dict):
            if "@value" in value:
                return self.value_object(value, ctx)
            if "@list" in value:
                items = value["@list"]
                if not isinstance(items, list):
                    items = [items]
                return self.list_node(items, term_def, ctx)
            if set(value) == {"@id"}:
                return self.subject_term(value["@id"], ctx)
            return self.node_object(value, ctx)      # nested node
        if isinstance(value, str) and term_def.get("@type") == "@id":
            return self.subject_term(value, ctx)
        if isinstance(value, str) and term_def.get("@type") == "@vocab":
            return IRI(ctx.expand_iri(value, vocab=True))
        if isinstance(value, (str, int, float, bool)):
            return self.scalar_literal(value, term_def, ctx)
        raise JsonLdError(f"unsupported object value: {value!r}")

    # -- nodes -----------------------------------------------------------
    def node_object(self, obj: dict, ctx: _Context):
        if "@context" in obj:
            ctx = ctx.apply(obj["@context"])
        for kw in _UNSUPPORTED_KEYWORDS:
            if kw in obj:
                raise JsonLdError(f"{kw} is not supported")
        if "@id" in obj:
            subject = self.subject_term(obj["@id"], ctx)
        else:
            subject = self.fresh_bnode()

        if "@graph" in obj:
            allowed = {"@graph", "@id", "@context"}
            extra = [k for k in obj if k not in allowed]
            if extra:
                raise JsonLdError(
                    f"@graph with sibling properties {extra} is not "
                    f"supported (graph labels are ignored)")
            self.walk(obj["@graph"], ctx)
            return subject

        types = obj.get("@type", [])
        if not isinstance(types, list):
            types = [types]
        for t in types:
            if not isinstance(t, str):
                raise JsonLdError(f"non-string @type {t!r}")
            self.triples.append(
                (subject, RDF_TYPE,
                 IRI(ctx.expand_iri(t, vocab=True))))

        for key, value in obj.items():
            if key in ("@id", "@type", "@context", "@graph"):
                continue
            if key.startswith("@"):
                raise JsonLdError(f"unsupported keyword {key!r}")
            term_def = ctx.terms.get(key, {})
            expanded = ctx.expand_iri(key, vocab=True)
            if expanded.startswith("@"):
                raise JsonLdError(
                    f"keyword-aliased property {key!r} -> {expanded!r} "
                    f"is not supported")
            predicate = IRI(expanded)
            if term_def.get("@container") == "@list" \
                    and not (isinstance(value, dict)
                             and "@list" in value):
                # expansion wraps non-array values of list containers
                items = value if isinstance(value, list) else [value]
                self.triples.append(
                    (subject, predicate,
                     self.list_node(items, term_def, ctx)))
                continue
            values = value if isinstance(value, list) else [value]
            for v in values:
                self.triples.append(
                    (subject, predicate, self.object_term(v, term_def,
                                                          ctx)))
        return subject

    def walk(self, doc, ctx: _Context):
        if isinstance(doc, list):
            for item in doc:
                self.walk(item, ctx)
            return
        if not isinstance(doc, dict):
            raise JsonLdError(f"expected a node object, got {doc!r}")
        self.node_object(doc, ctx)


def parse_text(text: str) -> List[Tuple]:
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as exc:
        raise JsonLdError(f"not valid JSON: {exc}") from exc
    parser = _Parser()
    ctx = _Context()
    if isinstance(doc, dict) and "@context" in doc:
        ctx = ctx.apply(doc["@context"])
    parser.walk(doc, ctx)
    return keep_generated_apart(parser.triples, parser.generated,
                                parser.labels, "jb")


def parse_file(path: str) -> List[Tuple]:
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return parse_text(f.read())
    with open(path, "r", encoding="utf-8") as f:
        return parse_text(f.read())
