"""Minimal RDF term model.

The port's copy of :mod:`mrgcn_tpu.data.rdf`. The reference wraps rdflib
(reference: mrgcn/data/io/knowledge_graph.py:11-16); the ETL only needs a
small, fast term model: IRIs, blank nodes, and literals with optional
language tag / datatype. IRIs and blank nodes subclass ``str``, so the
target triples sort as raw tuples (``tasks/build.mk_target_matrices``);
terms are hashable and sort deterministically by their string form,
matching the reference's ``quickSort`` on ``str(member)``
(reference: mrgcn/data/io/knowledge_graph.py:171-192).
"""

from __future__ import annotations

from typing import Optional

XSD = "http://www.w3.org/2001/XMLSchema#"
OGC = "http://www.opengis.net/ont/geosparql#"
KGBENCH = "http://kgbench.info/dt#"


def xsd(local: str) -> str:
    return XSD + local


class IRI(str):
    """An IRI reference. Subclasses str: ``str(iri)`` is the IRI text."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"IRI({str.__repr__(self)})"


class BNode(str):
    """A blank node label (without the ``_:`` prefix)."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"BNode({str.__repr__(self)})"


class Literal:
    """An RDF literal: lexical form + optional language tag or datatype IRI.

    ``str(literal)`` is the lexical form, mirroring rdflib so that node
    sorting and feature extraction behave like the reference
    (reference: mrgcn/encodings/xsd/numeric.py:116 ``float(str(node))``).
    """

    __slots__ = ("lexical", "language", "datatype", "_hash")

    def __init__(self, lexical: str, language: Optional[str] = None,
                 datatype: Optional[str] = None):
        self.lexical = lexical
        self.language = language
        self.datatype = datatype
        self._hash = None

    def __str__(self) -> str:
        return self.lexical

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if self.language is not None:
            return f"Literal({self.lexical!r}@{self.language})"
        if self.datatype is not None:
            return f"Literal({self.lexical!r}^^<{self.datatype}>)"
        return f"Literal({self.lexical!r})"

    def _key(self):
        return (self.lexical, self.language, self.datatype)

    def __eq__(self, other) -> bool:
        return type(other) is Literal and self._key() == other._key()

    def __hash__(self) -> int:
        # cached: literal hashing is hot during structure indexing (427k
        # calls on a 160k-triple graph, ~1 s uncached)
        if self._hash is None:
            self._hash = hash(("Literal", self._key()))
        return self._hash


class UniqueLiteral(Literal):
    """A literal made unique per (subject, predicate, object) occurrence.

    When ``separate_literals`` is enabled, equal literal values linked from
    different triples become distinct graph nodes
    (reference: mrgcn/data/io/knowledge_graph.py:194-228).
    """

    __slots__ = ("s", "p")

    def __init__(self, s, p, o: Literal):
        super().__init__(o.lexical, o.language, o.datatype)
        self.s = str(s)
        self.p = str(p)

    def _key(self):
        return (self.s, self.p, self.lexical, self.language, self.datatype)

    def __eq__(self, other) -> bool:
        return type(other) is UniqueLiteral and self._key() == other._key()

    def __hash__(self) -> int:
        if self._hash is None:
            self._hash = hash(("UniqueLiteral", self._key()))
        return self._hash

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"UniqueLiteral({self.lexical!r}, s={self.s!r}, p={self.p!r})"
