"""A msgpack codec of the port's own (stdlib and numpy only).

The JAX package writes its checkpoints with
``flax.serialization.msgpack_serialize``; the port reads and writes the
same files without ``msgpack`` or ``flax``. The codec covers the subset
those files use:

  * nil, bool, int (64-bit signed and unsigned), float (float64 on
    write; float32 and float64 on read), str, bin, array and map, each
    in the smallest encoding, as ``msgpack.packb(use_bin_type=True)``
    chooses it, so a packed payload is byte for byte what flax writes;
  * ext 1, an ndarray: the msgpack array ``(shape, dtype name, C-order
    bytes)``;
  * ext 3, a numpy scalar, packed as a 0-d ndarray.

Tuples pack as arrays and read back as lists. Flax's chunked-array
marker (``__msgpack_chunked_array__``), written only for arrays above
2^30 bytes, raises on read, as does any other ext type.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


def _head(out: bytearray, fix: int, fix_max: int, codes: Tuple[int, ...],
          n: int) -> None:
    """The header of a str, bin, array or map of ``n`` entries or bytes:
    the fix form ``fix | n`` where ``n <= fix_max``, else the 8-, 16- or
    32-bit form of ``codes`` (None where the type has none)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7f:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v > 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} does not fit 64 bits")


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _head(out, None, 0, (0xc7, 0xc8, 0xc9), len(data))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "supported")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif type(obj) is int:
        _int(out, obj)
    elif type(obj) is float:
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _head(out, 0xa0, 31, (0xd9, 0xda, 0xdb), len(data))
        out += data
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _head(out, None, 0, (0xc4, 0xc5, 0xc6), len(data))
        out += data
    elif type(obj) in (list, tuple):
        _head(out, 0x90, 15, (None, 0xdc, 0xdd), len(obj))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _head(out, 0x80, 15, (None, 0xde, 0xdf), len(obj))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (what ``flax.serialization.
    msgpack_serialize`` writes for arrays below 2^30 bytes)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack_from(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, name, buf = _Reader(data, raw=True).value()
        arr = np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(
            shape).copy()
        return arr[()] if code == EXT_NPSCALAR else arr

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map_(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str_(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        lengths = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack_from(lengths[b])))
        exts = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if b in exts:
            n = self.unpack_from(exts[b])
            return self.ext(self.unpack_from(">b"), n)
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack_from(numbers[b])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(self.unpack_from(">b"), fixext[b])
        strs = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if b in strs:
            return self.str_(self.unpack_from(strs[b]))
        if b in (0xdc, 0xdd):
            n = self.unpack_from(">H" if b == 0xdc else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map_(self.unpack_from(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack: unsupported type byte {b:#04x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if CHUNKED in out:
            raise ValueError("msgpack: a chunked array (an array above 2^30 "
                             "bytes, flax's chunked form) is not supported")
        return out


def unpackb(data: bytes) -> Any:
    """The object of msgpack bytes: maps as dicts (str keys), arrays as
    lists, ext 1 as ndarrays, ext 3 as numpy scalars."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: extra bytes after the object")
    return out
