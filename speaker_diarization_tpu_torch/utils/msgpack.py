"""A decoder of flax's `serialization.to_bytes` format, without the msgpack package.

flax writes a variables tree as one msgpack map (the msgpack spec:
https://github.com/msgpack/msgpack/blob/master/spec.md) whose leaves are
msgpack extension types: 1 an ndarray (the msgpack of (shape, dtype name,
C-order bytes)), 2 a Python complex (the msgpack of (real, imag)), 3 a numpy
scalar (an ndarray of shape ()). Arrays larger than flax's chunk limit are
written as maps {'__msgpack_chunked_array__': True, 'shape': {'0': ...},
'chunks': {'0': flat array, ...}}, which `from_bytes` joins back. This module
reads maps, arrays, str and bin, ints, floats, bools and nil, and those
extension types; a bfloat16 array comes back as float32.

    from speaker_diarization_tpu_torch.utils.msgpack import from_bytes
    variables = from_bytes(open("vad.msgpack", "rb").read())
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data ends at byte {len(self.data)}, {n} bytes wanted at {self.pos}")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:  # uint 8..64, int 8..64
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} is no msgpack type")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == EXT_COMPLEX:
            re, im = _decode(payload)
            return complex(re, im)
        raise ValueError(f"unknown msgpack extension type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, buf = _decode(payload)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":  # the top 16 bits of a float32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _decode(data: bytes) -> Any:
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes left after the msgpack value")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def from_bytes(data: bytes) -> Any:
    """flax `serialization.to_bytes` output → the nested dicts of numpy
    arrays (and scalars) it holds, chunked arrays joined."""
    return _unchunk(_decode(data))


def describe(data: bytes) -> str:
    """Its size and first bytes: what a loader that reads neither npz nor
    msgpack says it found."""
    return f"{len(data)} bytes starting {bytes(data[:8]).hex(' ') or '(none)'}"


def flax_variables(data: bytes, source: str) -> dict:
    """flax `to_bytes` of a variables dict (or of its params alone) →
    {'params': ...}; bytes that are no such msgpack raise ValueError naming
    `source` and what they hold."""
    try:
        tree = from_bytes(data)
    except (ValueError, UnicodeDecodeError, KeyError, TypeError) as e:
        raise ValueError(f"{source} is neither an npz nor a flax msgpack file ({describe(data)}): {e}") from None
    if not isinstance(tree, dict):
        raise ValueError(f"{source} holds a msgpack {type(tree).__name__}, not flax variables ({describe(data)})")
    return tree if "params" in tree else {"params": tree}
