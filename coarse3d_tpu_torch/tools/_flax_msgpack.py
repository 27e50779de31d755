"""Read the ``.msgpack`` files Flax writes, without Flax or msgpack.

``flax.serialization.msgpack_serialize`` writes a tree of maps with string
keys and array leaves; every array is a msgpack extension of type 1 (type
3 for a numpy scalar) whose payload is itself msgpack: ``(shape, dtype
name, C-order bytes)``. This module decodes msgpack's maps, arrays,
strings, binaries, integers, floats, booleans, nil and those extensions,
and gives what ``flax.serialization.msgpack_restore`` gives: nested dicts
of numpy arrays (a numpy scalar comes back as a 0-d array, a bfloat16
array widened exactly to float32). What model checkpoints never hold is
refused: complex numbers, and arrays over 2**30 bytes, which Flax splits
into chunks.

The JAX package's checkpoint tools write such files
(``tools/convert_torch_ckpt.py``); ``tools/export_torch_ckpt.py --msgpack``
reads them with :func:`restore`.
"""

from __future__ import annotations

import struct

import numpy as np

_NDARRAY, _NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

# msgpack's type bytes past the fixed-size ranges
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBER = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
           0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {                          # kind -> {byte: format of its length}
    "bin": {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"},
    "str": {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"},
    "array": {0xDC: ">H", 0xDD: ">I"},
    "map": {0xDE: ">H", 0xDF: ">I"},
    "ext": {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"},
}


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw                  # keep strings as bytes

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        s = self.take(n)
        return s if self.raw else s.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMBER:
            return self.unpack(_NUMBER[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        for kind, sizes in _SIZED.items():
            if b in sizes:
                n = self.unpack(sizes[b])
                if kind == "bin":
                    return self.take(n)
                if kind == "str":
                    return self.string(n)
                if kind == "array":
                    return [self.value() for _ in range(n)]
                if kind == "map":
                    return self.map(n)
                return self.ext(n)
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if key == _CHUNKED:
                raise ValueError(
                    "a chunked array (over 2**30 bytes): not read here")
            out[key] = self.value()
        return out


def _loads(data: bytes, raw: bool = False):
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return out


def _ext(code: int, payload: bytes) -> np.ndarray:
    if code not in (_NDARRAY, _NPSCALAR):
        raise ValueError(f"unsupported msgpack extension type {code}")
    shape, dtype, buf = _loads(payload, raw=True)
    if dtype == b"bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes, when loaded, adds
        # one): widen exactly, the same wherever this runs
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape)


def restore(data: bytes):
    """The tree ``flax.serialization.msgpack_serialize`` encoded in
    ``data``: nested dicts with numpy array leaves."""
    return _loads(data)
