"""Relative IRI resolution (RFC 3986 §5.2), shared by the port's Turtle,
RDF/XML and JSON-LD readers.

The JAX package resolves Turtle's and JSON-LD's relative IRIs by cutting
the base at its last ``/``, which drops a path-less base's authority
(``http://example.com`` + ``alice`` -> ``http://alice``) and keeps dot
segments (``../b``); its RDF/XML reader takes :func:`urllib.parse.urljoin`,
which returns the reference unresolved against a scheme it does not know
as hierarchical (``urn:``, ``tag:``). :func:`resolve` follows §5.2 for
every scheme: on the hierarchical bases those readers get right
(``http://host/dir/``, ``file:`` URIs; references ``name``, ``#frag``,
``/abs``, ``//host``) it gives their result.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

# RFC 3986 Appendix B: scheme, authority, path, query, fragment; an
# unmatched optional group is None (undefined), not "" (defined, empty)
_URI_RE = re.compile(
    r"^(?:([^:/?#]+):)?(?://([^/?#]*))?([^?#]*)(?:\?([^#]*))?(?:#(.*))?$",
    re.DOTALL)
_SCHEME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9+.-]*:")

Parts = Tuple[Optional[str], Optional[str], str, Optional[str],
              Optional[str]]


def is_absolute(iri: str) -> bool:
    """Whether ``iri`` starts with a scheme (RFC 3986 §3.1)."""
    return _SCHEME_RE.match(iri) is not None


def _split(uri: str) -> Parts:
    return _URI_RE.match(uri).groups()


def remove_dot_segments(path: str) -> str:
    """RFC 3986 §5.2.4."""
    out = []
    while path:
        if path.startswith("../"):
            path = path[3:]
        elif path.startswith("./"):
            path = path[2:]
        elif path.startswith("/./"):
            path = path[2:]
        elif path == "/.":
            path = "/"
        elif path.startswith("/../"):
            path = path[3:]
            if out:
                out.pop()
        elif path == "/..":
            path = "/"
            if out:
                out.pop()
        elif path in (".", ".."):
            path = ""
        else:
            cut = path.find("/", 1)
            cut = len(path) if cut < 0 else cut
            out.append(path[:cut])
            path = path[cut:]
    return "".join(out)


def _merge(base: Parts, ref_path: str) -> str:
    """RFC 3986 §5.2.3."""
    if base[1] is not None and base[2] == "":
        return "/" + ref_path
    cut = base[2].rfind("/")
    return base[2][:cut + 1] + ref_path


def resolve(ref: str, base: str) -> str:
    """``ref`` resolved against ``base`` (RFC 3986 §5.2.2, the strict
    parser; a base without a scheme, which the RFC does not define, is
    merged as one with). A reference with a scheme is returned as written,
    as an N-Triples reader keeps it; the empty reference gives the base
    without its fragment."""
    if is_absolute(ref):
        return ref
    b = _split(base)
    _, r_auth, r_path, r_query, r_frag = _split(ref)
    if r_auth is not None:
        auth, path, query = r_auth, remove_dot_segments(r_path), r_query
    else:
        auth = b[1]
        if r_path == "":
            path = b[2]
            query = r_query if r_query is not None else b[3]
        else:
            path = remove_dot_segments(
                r_path if r_path.startswith("/") else _merge(b, r_path))
            query = r_query
    out = [] if b[0] is None else [b[0], ":"]
    if auth is not None:
        out += ["//", auth]
    out.append(path)
    if query is not None:
        out += ["?", query]
    if r_frag is not None:
        out += ["#", r_frag]
    return "".join(out)
