"""In-memory knowledge graph with the reference's iteration semantics.

The port's copy of :mod:`mrgcn_tpu.data.kg`. Mirrors the behavioural
contract of the reference's rdflib wrapper
(reference: mrgcn/data/io/knowledge_graph.py:18-228): a de-duplicated triple
store with deterministic atom enumeration, optional per-occurrence literal
separation (``UniqueLiteral``), property frequencies, and graph subtraction
for target-relation stripping. It reads every serialisation the JAX
package reads, plain or gzipped: N-Triples, N-Quads, Turtle, TriG, RDF/XML
and JSON-LD (the documented subset of :mod:`.jsonld`).
"""

from __future__ import annotations

import logging
from collections import Counter
from typing import Dict, Iterable, Iterator, List, Optional

from mrgcn_tpu_torch.data.ntriples import Triple, Term, parse_file
from mrgcn_tpu_torch.data.rdf import BNode, Literal, UniqueLiteral

logger = logging.getLogger(__name__)


def _format_of(path: str) -> str:
    """RDF serialisation by extension (.gz-transparent). The reference
    defers to rdflib's format guessing
    (reference: data/io/knowledge_graph.py:45-56)."""
    stem = path[:-3] if path.endswith(".gz") else path
    ext = stem.rsplit(".", 1)[-1].lower() if "." in stem else ""
    if ext in ("nt", "ntriples"):
        return "ntriples"
    if ext in ("nq", "nquads"):
        return "nquads"   # graph labels parsed and ignored
    if ext in ("ttl", "turtle", "n3"):
        return "turtle"
    if ext == "trig":
        return "trig"     # graph labels parsed and ignored
    if ext in ("rdf", "rdfs", "owl", "xml"):
        return "rdfxml"
    if ext in ("jsonld", "json"):
        return "jsonld"   # fail-loud subset, see data/jsonld.py
    raise ValueError(
        f"Unsupported RDF serialisation {'.' + ext if ext else path!r}: "
        f"{path}. Supported: N-Triples (.nt[.gz]), N-Quads (.nq[.gz]), "
        f"Turtle (.ttl/.n3[.gz]), TriG (.trig[.gz]), RDF/XML "
        f"(.rdf/.rdfs/.owl/.xml[.gz]) and JSON-LD (.jsonld[.gz], "
        f"documented subset). Convert other serialisations to N-Triples "
        f"first, e.g. with `rapper` or rdflib.")


_NAMES = {"ntriples": "N-Triples", "nquads": "N-Quads", "turtle": "Turtle",
          "trig": "TriG", "rdfxml": "RDF/XML", "jsonld": "JSON-LD"}


def _read_path(path: str):
    """Parse one RDF file. N-Triples takes the native C++ parser
    (``mrgcn_tpu_torch/native/ntparse.cpp``) where its library builds and
    the file reads, else the Python parser, which gives the same triples
    (the JAX package falls back on any exception, silently; the port only
    where :func:`..native.parse_file_native` returns None, which it logs).
    N-Quads takes the Python parser, which drops graph labels; Turtle /
    TriG, RDF/XML (relative IRIs against the file's ``file:`` URI, as
    rdflib does) and JSON-LD their own readers. Fails loudly when a
    non-empty file parses to zero triples: a silent empty graph poisons
    everything downstream."""
    fmt = _format_of(path)
    if fmt in ("turtle", "trig"):
        from mrgcn_tpu_torch.data import turtle
        triples = turtle.parse_file(path, trig=(fmt == "trig"))
    elif fmt == "jsonld":
        from mrgcn_tpu_torch.data import jsonld
        triples = jsonld.parse_file(path)
    elif fmt == "rdfxml":
        # relative IRIs against the document's URI, as rdflib resolves
        # them: otherwise cross-file references to one IRI diverge
        import pathlib
        from mrgcn_tpu_torch.data import rdfxml
        base = pathlib.Path(path).absolute().as_uri()
        triples = rdfxml.parse_file(path, base_iri=base)
    elif fmt == "nquads":
        # only this dispatch path accepts the N-Quads graph label; the
        # native fast path does not, so quads stay on the Python path
        triples = list(parse_file(path, allow_quads=True))
    else:
        from mrgcn_tpu_torch.data.native import parse_file_native
        triples = parse_file_native(path)
        if triples is None:
            triples = list(parse_file(path))
    if not triples and _has_content(path):
        hint = " (Turtle needs a .ttl extension)" if fmt == "ntriples" \
            else ""
        raise ValueError(
            f"{path}: no valid {_NAMES[fmt]} statements found in a "
            f"non-empty file — wrong serialisation?{hint}")
    return triples


def _has_content(path: str) -> bool:
    import gzip
    import io
    opener = gzip.open if path.endswith(".gz") else open
    with io.TextIOWrapper(opener(path, "rb"), encoding="utf-8",
                          errors="replace") as f:
        for line in f:
            stripped = line.strip()
            if stripped and not stripped.startswith("#"):
                return True
    return False


class KnowledgeGraph:
    """Deduped, insertion-ordered triples plus convenience generators.

    Construct from one RDF path (any serialisation of :func:`_format_of`,
    plain or ``.gz``) or a list of them, another graph, an iterable of
    triples, or nothing (empty graph).
    """

    def __init__(self, source=None):
        # dedup container with INSERTION order (dict, not set): every
        # generator — atoms(), columns(), triples() — iterates in
        # parse/first-appearance order, so node indexing, edge order and
        # float accumulation order are reproducible across processes.
        # A set here would make all of those follow randomized str hashing
        # whenever distinct terms share a sort key (e.g. "2000"^^gYear vs
        # "2000"^^integer under separate_literals=false).
        self._triples: Dict[Triple, None] = {}

        if source is None:
            pass
        elif isinstance(source, str):
            self._triples.update(dict.fromkeys(_read_path(source)))
        elif isinstance(source, (list, tuple)) and source \
                and isinstance(source[0], str):
            for path in source:
                self._triples.update(dict.fromkeys(_read_path(path)))
        elif isinstance(source, KnowledgeGraph):
            self._triples.update(source._triples)
        else:  # iterable of triples
            self._triples.update(dict.fromkeys(source))

        self._property_distribution = Counter(p for _, p, _ in self._triples)
        logger.debug("Knowledge graph imported (%d facts)", len(self._triples))

    # -- basics --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._triples)

    def __contains__(self, triple: Triple) -> bool:
        return triple in self._triples

    def __enter__(self) -> "KnowledgeGraph":
        return self

    def __exit__(self, *exc) -> None:
        self._triples.clear()

    def add(self, triple: Triple) -> None:
        # a duplicate is a no-op (set semantics): the distribution keeps
        # counting the deduped store, or property_frequency over-counts
        if triple not in self._triples:
            self._triples[triple] = None
            self._property_distribution[triple[1]] += 1

    def remove_triples(self, triples: Iterable[Triple]) -> int:
        """Subtract triples; returns the number removed.

        Used by ``strip_graph`` to drop inverse-target edges and prevent label
        leakage (reference: mrgcn/data/utils.py:64-80).
        """
        removed = 0
        for t in set(triples):
            if t in self._triples:
                del self._triples[t]
                self._property_distribution[t[1]] -= 1
                removed += 1
        return removed

    # -- generators (reference: knowledge_graph.py:70-144) --------------

    def triples(self, pattern=(None, None, None),
                separate_literals: bool = True) -> Iterator[Triple]:
        ps, pp, po = pattern
        for s, p, o in self._triples:
            if ps is not None and s != ps:
                continue
            if pp is not None and p != pp:
                continue
            if po is not None and o != po:
                continue
            if separate_literals and isinstance(o, Literal):
                o = UniqueLiteral(s, p, o)
            yield s, p, o

    def columns(self):
        """Columnar ``(subjects, predicates, objects)`` tuples over the
        deduped triples — ONE C-level zip instead of a per-triple Python
        generator. The fast path for whole-graph scans (structure
        indexing, property enumeration): the ``triples()`` generator
        costs ~1.3 us/triple in scan loops, this ~60 ns."""
        if not self._triples:
            return (), (), ()
        return tuple(zip(*self._triples))

    def atoms(self, separate_literals: bool = True) -> Iterator[Term]:
        """Unique subjects and objects, literals optionally made per-triple
        unique (reference: knowledge_graph.py:70-82)."""
        seen = set()
        for s, p, o in self._triples:
            for atom in (s, o):
                if separate_literals and atom is o and isinstance(o, Literal):
                    atom = UniqueLiteral(s, p, o)
                if atom in seen:
                    continue
                seen.add(atom)
                yield atom

    def non_terminal_atoms(self) -> Iterator[Term]:
        # dict.fromkeys, not a set: first-appearance order, like the rest
        # of the generators
        yield from dict.fromkeys(s for s, _, _ in self._triples)

    def terminal_atoms(self) -> Iterator[Term]:
        """Objects that never appear as subjects
        (reference: knowledge_graph.py:89-96)."""
        non_terminal = frozenset(self.non_terminal_atoms())
        for _, _, o in self._triples:
            if o not in non_terminal:
                yield o

    def _property_kinds(self):
        """One pass: properties used with >=1 non-literal object vs
        literal-only properties."""
        objecttype, any_prop = set(), set()
        for _, p, o in self._triples:
            any_prop.add(p)
            if type(o) is not Literal:
                objecttype.add(p)
        return objecttype, any_prop - objecttype

    def objecttype_properties(self) -> Iterator[Term]:
        """Properties used with at least one non-literal object
        (reference: knowledge_graph.py:113-122)."""
        yield from self._property_kinds()[0]

    def datatype_properties(self) -> Iterator[Term]:
        """Properties used exclusively with literal objects
        (reference: knowledge_graph.py:124-132)."""
        yield from self._property_kinds()[1]

    def attributes(self) -> Iterator[Literal]:
        for _, _, o in self._triples:
            if type(o) is Literal:
                yield o

    def entities(self, omit_blank_nodes: bool = False) -> Iterator[Term]:
        for res in self.atoms():
            if isinstance(res, Literal) or \
                    (omit_blank_nodes and type(res) is BNode):
                continue
            yield res

    def properties(self) -> Iterator[Term]:
        for _, p, _ in self._triples:
            yield p

    # -- statistics -----------------------------------------------------

    def property_frequency(self, prop: Optional[Term] = None):
        if prop is None:
            return self._property_distribution
        return self._property_distribution.get(prop, 0)

    def attribute_frequency(self, prop: Term, limit: Optional[int] = None):
        freq = Counter(o for _, p, o in self._triples if p == prop)
        return freq.most_common(limit)

    # -- operators --------------------------------------------------------

    def sample(self, strategy=None, **kwargs) -> "KnowledgeGraph":
        """Sample this graph with a user-provided strategy object
        (reference: knowledge_graph.py:161-169)."""
        if strategy is None:
            raise ValueError("Strategy cannot be left undefined")
        logger.debug("Sampling graph")
        return strategy.sample(self, **kwargs)

    # -- determinism ----------------------------------------------------

    @staticmethod
    def sort_atoms(atoms: Iterable[Term]) -> List[Term]:
        """Deterministic string-keyed sort; stable for equal keys, matching
        the reference's quickSort pivot grouping
        (reference: knowledge_graph.py:171-192)."""
        return sorted(atoms, key=str)
