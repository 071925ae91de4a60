"""Reader for the msgpack files flax.serialization writes, in plain Python.

flax stores a variable tree as nested msgpack maps with str keys whose
leaves are ndarrays in msgpack ext type 1: the ext payload is itself a
msgpack array [shape, dtype name, raw C-order bytes]
(flax.serialization._ndarray_to_bytes).  This module decodes that subset
(maps, arrays, str, bin, int, float, ext type 1) into nested dicts of numpy
arrays, and raises on anything else, so the port needs no `msgpack` package.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1


class MsgpackError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError(f"truncated input at byte {self.pos} (+{n})")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        pos = self.pos
        t = self.unpack(">B")
        if t <= 0x7F:  # positive fixint
            return t
        if t >= 0xE0:  # negative fixint
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.read_map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.read_array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.read_str(t & 0x1F)
        simple = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if t in simple:
            return self.unpack(simple[t])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
                   0xDC: ">H", 0xDD: ">I",  # array
                   0xDE: ">H", 0xDF: ">I",  # map
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext
        if t in lengths:
            n = self.unpack(lengths[t])
            if t <= 0xC6:
                return bytes(self.take(n))
            if t <= 0xC9:
                return self.read_ext(n)
            if t <= 0xDB:
                return self.read_str(n)
            if t <= 0xDD:
                return self.read_array(n)
            return self.read_map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.read_ext(fixext[t])
        raise MsgpackError(f"unsupported msgpack type byte 0x{t:02x} at byte {pos}")

    def read_str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def read_array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, str):
                raise MsgpackError(f"map key {k!r} is not a str")
            out[k] = self.read()
        return out

    def read_ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise MsgpackError(f"unsupported msgpack ext type {code}")
        inner = _Reader(payload)
        shape, dtype, raw = inner.read()
        if inner.pos != len(payload):
            raise MsgpackError("trailing bytes in an ndarray ext payload")
        dt = np.dtype(dtype)
        if dt.kind not in "biuf":
            raise MsgpackError(f"unsupported ndarray dtype {dtype}")
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()


def loads(data: bytes):
    """Decode one msgpack document of the flax subset."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes")
    return obj


def load(path) -> dict:
    """Read a flax .msgpack file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return loads(f.read())
