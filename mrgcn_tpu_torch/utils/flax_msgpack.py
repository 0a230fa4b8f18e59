"""The msgpack files flax writes (``flax_model.msgpack``), read and written
without msgpack or flax.

flax's ``serialization.msgpack_serialize`` writes a nested dict of arrays
as msgpack: maps with string keys, strings, integers, floats, nil and
booleans, arrays, and each numpy array as extension type 1, whose payload
is itself msgpack: ``(shape, dtype name, C-order bytes)``. An array of
more than 2^30 bytes is split into a map ``{"__msgpack_chunked_array__":
true, "shape": {"0": ..}, "chunks": {"0": flat chunk, ..}}``. This module
reads exactly that subset (:func:`restore`, ``msgpack_restore``'s
counterpart) and raises on anything else, naming the offset; it also
writes it (:func:`serialize`) for the fixtures of the tests and of
:mod:`..tasks.synthetic`.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY = 1
MAX_CHUNK_BYTES = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"


class FormatError(ValueError):
    """A byte sequence outside the subset flax writes."""


def _array(payload: memoryview) -> np.ndarray:
    shape, dtype, data = _Reader(payload).whole()
    return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()


class _Reader:

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def whole(self):
        value = self.value()
        if self.pos != len(self.buf):
            raise FormatError(f"{len(self.buf) - self.pos} bytes after the "
                              f"value, at byte {self.pos}")
        return value

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise FormatError(f"truncated at byte {self.pos} "
                              f"({n} bytes wanted)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _array(payload)
        raise FormatError(f"extension type {code} at byte {self.pos - n}")

    def value(self) -> Any:
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: "B", 0xc5: ">H", 0xc6: ">I",      # bin
                 0xd9: "B", 0xda: ">H", 0xdb: ">I"}      # str
        if b in sized:
            raw = self.take(self.unpack(sized[b]))
            return bytes(raw) if b <= 0xc6 else str(raw, "utf-8")
        if b in (0xc7, 0xc8, 0xc9):                     # ext 8 / 16 / 32
            n = self.unpack({0xc7: "B", 0xc8: ">H", 0xc9: ">I"}[b])
            return self.ext(self.unpack("b"), n)
        if 0xd4 <= b <= 0xd8:                           # fixext 1..16
            code = self.unpack("b")
            return self.ext(code, 1 << (b - 0xd4))
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: "B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: "b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xdc, 0xdd):
            return self.array(self.unpack(">H" if b == 0xdc else ">I"))
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        raise FormatError(f"msgpack byte 0x{b:02x} at byte {at} is not in "
                          "the subset flax writes")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unchunk(node):
    if isinstance(node, dict):
        if node.get(CHUNKED) is True:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def restore(data: bytes) -> Any:
    """The tree that flax's ``msgpack_restore`` returns for ``data``
    (arrays as numpy, chunked arrays joined)."""
    return _unchunk(_Reader(data).whole())


def load(path) -> Any:
    """:func:`restore` of a file."""
    with open(path, "rb") as f:
        return restore(f.read())


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def _pack_len(out: list, n: int, fix: Tuple[int, int], codes) -> None:
    """A container or string header: the fix form below ``fix[1]``, else
    the 8- (strings only), 16- or 32-bit form."""
    base, limit = fix
    if n < limit:
        out.append(bytes([base | n]))
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise FormatError(f"{n} entries is too many for msgpack")


def _pack(out: list, value) -> None:
    if value is None:
        out.append(b"\xc0")
    elif value is True or value is False:
        out.append(b"\xc3" if value else b"\xc2")
    elif isinstance(value, (int, np.integer)) \
            and not isinstance(value, bool):
        value = int(value)
        if 0 <= value <= 0x7f or -32 <= value < 0:
            out.append(struct.pack("b" if value < 0 else "B", value))
        elif value >= 0:
            out.append(b"\xcf" + struct.pack(">Q", value))
        else:
            out.append(b"\xd3" + struct.pack(">q", value))
    elif isinstance(value, float):
        out.append(b"\xcb" + struct.pack(">d", value))
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        _pack_len(out, len(raw), (0xa0, 32), ((0xd9, "B", 1 << 8),
                                              (0xda, ">H", 1 << 16),
                                              (0xdb, ">I", 1 << 32)))
        out.append(raw)
    elif isinstance(value, bytes):
        for code, fmt, top in ((0xc4, "B", 1 << 8), (0xc5, ">H", 1 << 16),
                               (0xc6, ">I", 1 << 32)):
            if len(value) < top:
                out.append(bytes([code]) + struct.pack(fmt, len(value)))
                break
        out.append(value)
    elif isinstance(value, dict):
        _pack_len(out, len(value), (0x80, 16), ((0xde, ">H", 1 << 16),
                                                (0xdf, ">I", 1 << 32)))
        for k, v in value.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(value, (list, tuple)):
        _pack_len(out, len(value), (0x90, 16), ((0xdc, ">H", 1 << 16),
                                                (0xdd, ">I", 1 << 32)))
        for v in value:
            _pack(out, v)
    elif isinstance(value, np.ndarray):
        payload: list = []
        arr = np.ascontiguousarray(value)
        _pack(payload, ([int(s) for s in arr.shape], arr.dtype.name,
                        arr.tobytes()))
        data = b"".join(payload)
        out.append(b"\xc9" + struct.pack(">I", len(data))
                   + struct.pack("b", EXT_NDARRAY))
        out.append(data)
    else:
        raise FormatError(f"cannot write {type(value).__name__}")


def _chunk(node):
    if isinstance(node, dict):
        return {k: _chunk(v) for k, v in node.items()}
    if isinstance(node, np.ndarray) and node.nbytes > MAX_CHUNK_BYTES:
        step = max(1, MAX_CHUNK_BYTES // node.dtype.itemsize)
        flat = node.reshape(-1)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {CHUNKED: True,
                "shape": {str(i): int(s) for i, s in enumerate(node.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return node


def serialize(tree) -> bytes:
    """``tree`` (nested dicts of numpy arrays and plain values) as flax's
    ``msgpack_serialize`` writes it."""
    out: list = []
    _pack(out, _chunk(tree))
    return b"".join(out)


def save(path, tree) -> None:
    """:func:`serialize` into a file."""
    with open(path, "wb") as f:
        f.write(serialize(tree))
