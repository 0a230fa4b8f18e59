"""SentencePiece's precompiled character map, read and applied as the
Rust ``tokenizers`` library's ``Precompiled`` normalizer applies it.

A charsmap (the ``precompiled_charsmap`` of a ``Precompiled`` normalizer
in ``tokenizer.json``, base64 there) is a little-endian u32, the byte
size of a trie; the trie, a darts-clone double array of u32 units; and a
blob of NUL-terminated UTF-8 replacements that the trie's leaves index.
A unit holds a label (bits 0-7), a has-leaf flag (bit 8) and an offset
(bits 10-30, shifted left by 8 more where bit 9 is set); a leaf unit holds
a value (bits 0-30) and bit 31. A byte ``c`` steps from position ``p``
to ``p ^ offset(p) ^ c``, whose label must be ``c``.

:meth:`Charsmap.normalize` follows the Rust normalizer, not
sentencepiece's C++ (which takes the longest match):

* each extended grapheme cluster (:mod:`.graphemes`) under 6 bytes is
  looked up whole; the first (shortest) key that is a prefix of its bytes
  replaces the whole cluster (with ``e`` -> ``E`` and ``e`` + U+0301 ->
  ``Z``, ``"e\\u0301x"`` gives ``"Ex"``);
* a cluster without such a key, and every cluster of 6 bytes or more, is
  looked up code point by code point, each replaced by its own first
  match or kept;
* the walk stops at a NUL byte.
"""

from __future__ import annotations

import struct
import sys
from array import array
from typing import Dict, Optional

from mrgcn_tpu_torch.encodings.xsd.graphemes import clusters

# a cluster of this many UTF-8 bytes or more is looked up code point by
# code point
WHOLE_BELOW = 6
# clusters whose replacements a charsmap keeps
CACHE_SIZE = 1 << 16


class Charsmap:
    """A precompiled charsmap (see the module docstring) from its bytes."""

    def __init__(self, data: bytes):
        if len(data) < 4:
            raise ValueError("precompiled charsmap shorter than its header")
        (size,) = struct.unpack_from("<I", data)
        if size % 4 or 4 + size > len(data):
            raise ValueError(f"precompiled charsmap: a trie of {size} bytes "
                             f"in {len(data)}")
        self.units = array("I", data[4:4 + size])
        if sys.byteorder != "little":
            self.units.byteswap()
        self.normalized = data[4 + size:]
        self.normalized.decode("utf-8")   # invalid UTF-8 raises, as in Rust
        # each cluster's replacement (itself where nothing matched)
        self._cache: Dict[str, str] = {}

    def first_match(self, key: bytes) -> Optional[int]:
        """The blob index of the first (shortest) key that is a prefix of
        ``key``, or None."""
        units = self.units
        n = len(units)
        unit = units[0]
        pos = (unit >> 10) << ((unit & 0x200) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= n:
                return None
            unit = units[pos]
            if unit & 0x800000FF != c:
                return None
            pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
            if unit & 0x100:
                return units[pos] & 0x7FFFFFFF
        return None

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement of ``chunk`` by its first prefix match, or
        None."""
        index = self.first_match(chunk.encode("utf-8"))
        if index is None:
            return None
        end = self.normalized.find(b"\0", index)
        return self.normalized[index:end if end >= 0 else None] \
            .decode("utf-8")

    def _cluster(self, cluster: str) -> str:
        if len(cluster) == 1 or len(cluster.encode("utf-8")) < WHOLE_BELOW:
            replaced = self.transform(cluster)
            if replaced is not None:
                return replaced
            if len(cluster) == 1:
                return cluster
        out = []
        for c in cluster:
            replaced = self.transform(c)
            out.append(c if replaced is None else replaced)
        return "".join(out)

    def normalize(self, text: str) -> str:
        cache = self._cache
        out = []
        for cluster in clusters(text):
            replaced = cache.get(cluster)
            if replaced is None:
                replaced = self._cluster(cluster)
                if len(cache) < CACHE_SIZE:
                    cache[cluster] = replaced
            out.append(replaced)
        return "".join(out)
