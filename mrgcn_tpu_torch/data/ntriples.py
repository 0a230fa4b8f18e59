"""Streaming N-Triples / N-Quads-subset parser (plain or gzipped).

Replaces the reference's rdflib-based reader
(reference: mrgcn/data/io/knowledge_graph.py:45-56). All bundled reference
datasets are N-Triples (``*.nt.gz``); this parser implements the W3C
N-Triples grammar including numeric and string escapes, language tags and
datatyped literals, and streams lines so very large graphs never need to be
held as text.

The port's copy of :mod:`mrgcn_tpu.data.ntriples`. The native C++ parser
(:mod:`mrgcn_tpu_torch.data.native`) is used where its library builds; this
pure-Python path is the reference semantics and the fallback.
"""

from __future__ import annotations

import gzip
import io
import re
from typing import Iterable, Iterator, Tuple, Union

from mrgcn_tpu_torch.data.rdf import IRI, BNode, Literal

Term = Union[IRI, BNode, Literal]
Triple = Tuple[Term, Term, Term]

# Unescape: \t \b \n \r \f \" \' \\ and \uXXXX \UXXXXXXXX
_ESCAPE_RE = re.compile(
    r"\\(?:u([0-9A-Fa-f]{4})|U([0-9A-Fa-f]{8})|([tbnrf\"'\\]))")
_ESCAPE_MAP = {"t": "\t", "b": "\b", "n": "\n", "r": "\r", "f": "\f",
               '"': '"', "'": "'", "\\": "\\"}


def _unescape(value: str) -> str:
    if "\\" not in value:
        return value

    def repl(m: "re.Match[str]") -> str:
        u4, u8, c = m.groups()
        if u4 is not None:
            return chr(int(u4, 16))
        if u8 is not None:
            return chr(int(u8, 16))
        return _ESCAPE_MAP[c]

    return _ESCAPE_RE.sub(repl, value)


# One-shot triple pattern. Whitespace between terms is arbitrary; object is an
# IRI, blank node, or literal with optional language tag / datatype.
_TRIPLE_RE = re.compile(r"""
    ^[ \t]*
    (?:<(?P<s_iri>[^>]*)>|_:(?P<s_bnode>\S+))
    [ \t]+
    <(?P<p_iri>[^>]*)>
    [ \t]+
    (?:
        <(?P<o_iri>[^>]*)>
      | _:(?P<o_bnode>\S+)
      | "(?P<o_lex>(?:[^"\\]|\\.)*)"
        (?:@(?P<o_lang>[a-zA-Z]+(?:-[a-zA-Z0-9]+)*)
          |\^\^<(?P<o_dtype>[^>]*)>
        )?
    )
    (?P<g_label>[ \t]+(?:<[^>]*>|_:\S+))?  # N-Quads graph label
    [ \t]*\.[ \t]*(?:\#.*)?$
""", re.VERBOSE)


class NTriplesError(ValueError):
    pass


def parse_line(line: str, allow_quads: bool = False) -> Triple:
    m = _TRIPLE_RE.match(line)
    if m is None:
        raise NTriplesError(f"malformed N-Triples line: {line!r}")

    g = m.groupdict()
    if g["g_label"] is not None and not allow_quads:
        # graph labels are only legal on the N-Quads dispatch path; plain
        # .nt parsing must reject them so the Python fallback counts the
        # same triples as the native C++ parser (which skips such lines)
        raise NTriplesError(f"N-Quads graph label in N-Triples input: "
                            f"{line!r}")
    if g["s_iri"] is not None:
        s: Term = IRI(_unescape(g["s_iri"]))
    else:
        s = BNode(g["s_bnode"])

    p: Term = IRI(_unescape(g["p_iri"]))

    if g["o_iri"] is not None:
        o: Term = IRI(_unescape(g["o_iri"]))
    elif g["o_bnode"] is not None:
        o = BNode(g["o_bnode"])
    else:
        o = Literal(_unescape(g["o_lex"]),
                    language=g["o_lang"],
                    datatype=_unescape(g["o_dtype"]) if g["o_dtype"] else None)

    return (s, p, o)


def _open_text(path: str) -> io.TextIOBase:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def parse_lines(lines: Iterable[str],
                allow_quads: bool = False) -> Iterator[Triple]:
    """Yield triples from an iterable of N-Triples lines.

    Malformed lines are skipped; the reference's data pipeline is similarly
    fail-soft at the literal level
    (reference: mrgcn/encodings/xsd/numeric.py:115-119). ``allow_quads``
    accepts (and drops) an N-Quads graph label — only the .nq dispatch path
    sets it.
    """
    for line in lines:
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        try:
            yield parse_line(stripped, allow_quads=allow_quads)
        except NTriplesError:
            pass


def parse_file(path: str, allow_quads: bool = False) -> Iterator[Triple]:
    with _open_text(path) as f:
        yield from parse_lines(f, allow_quads=allow_quads)
