"""Reader and writer for the msgpack files flax.serialization writes, in
plain Python.

flax stores a variable tree as nested msgpack maps with str keys whose
leaves are ndarrays in msgpack ext type 1: the ext payload is itself a
msgpack array [shape, dtype name, raw C-order bytes]
(flax.serialization._ndarray_to_bytes).  `loads` decodes that subset (maps,
arrays, str, bin, int, float, ext type 1) into nested dicts of numpy
arrays, and raises on anything else, so the port needs no `msgpack` package.
`dumps` writes nested dicts of ndarrays the way flax.serialization.to_bytes
does, byte for byte: keys in each dict's own order, as flax writes them,
each msgpack value in its shortest form.
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


# flax splits arrays of 2^30 bytes or more into chunks
# (flax.serialization.MAX_CHUNK_SIZE); no tree of this repository holds one
MAX_LEAF_BYTES = 2**30


def _sized(out: bytearray, n: int, small: tuple, wide: tuple, what: str) -> None:
    """Append the header of a value of length n: `small` = (the fix-format
    base byte, its largest n) or None; `wide` = the (type byte, struct
    format) of the 8-, 16- and 32-bit length forms, None where the format
    has none."""
    if small is not None and n <= small[1]:
        out.append(small[0] | n)
        return
    for (code, fmt), limit in zip(wide, (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out += struct.pack(">B" + fmt[1:], code, n)
            return
    raise MsgpackError(f"{what} of length {n} is too long for msgpack")


def _write_uint(out: bytearray, n: int) -> None:
    if n < 0:
        raise MsgpackError(f"negative int {n} (array shapes only)")
    if n <= 0x7F:
        out.append(n)
        return
    for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                             (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
        if n <= limit:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise MsgpackError(f"int {n} is too large for msgpack")


def _write_str(out: bytearray, s: str) -> None:
    raw = s.encode("utf-8")
    _sized(out, len(raw), (0xA0, 31), ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")), "str")
    out += raw


def _ndarray_payload(a: np.ndarray) -> bytes:
    """[shape, dtype name, raw C-order bytes], as flax packs it."""
    if a.dtype.kind not in "biuf":
        raise MsgpackError(f"unsupported ndarray dtype {a.dtype}")
    raw = a.tobytes("C")
    if len(raw) >= MAX_LEAF_BYTES:
        raise MsgpackError(f"array of {len(raw)} bytes: flax would chunk it")
    out = bytearray([0x93])  # fixarray of 3
    _sized(out, a.ndim, (0x90, 15), ((None, None), (0xDC, ">H"), (0xDD, ">I")), "shape")
    for n in a.shape:
        _write_uint(out, int(n))
    _write_str(out, a.dtype.name)
    _sized(out, len(raw), None, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")), "bin")
    out += raw
    return bytes(out)


def _write(out: bytearray, obj, path: str) -> None:
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise MsgpackError(f"{path or 'the tree'}: map keys must be str")
        _sized(out, len(obj), (0x80, 15), ((None, None), (0xDE, ">H"), (0xDF, ">I")), "map")
        for k in obj:
            _write_str(out, k)
            _write(out, obj[k], f"{path}/{k}")
        return
    if not isinstance(obj, np.ndarray):
        raise MsgpackError(f"{path}: leaves must be numpy arrays, got {type(obj).__name__}")
    payload = _ndarray_payload(obj)
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _sized(out, n, None, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")), "ext")
    out += struct.pack(">b", _EXT_NDARRAY)
    out += payload


def dumps(tree: dict) -> bytes:
    """Encode nested dicts (str keys) of numpy arrays (bool, int, uint or
    float) as flax.serialization.to_bytes encodes the same tree."""
    out = bytearray()
    _write(out, tree, "")
    return bytes(out)


def dump(path, tree: dict) -> None:
    """Write `dumps(tree)` to a file, atomically: utils/checkpoint.py's
    save_msgpack, the one file writer."""
    from .checkpoint import save_msgpack

    save_msgpack(path, tree)
