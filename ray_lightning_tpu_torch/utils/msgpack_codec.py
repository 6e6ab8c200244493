"""A pure-Python msgpack codec for the types a state stream holds.

It stands in for the third-party ``msgpack`` that the JAX package's
``utils/state_stream.py`` imports, which the port's machines do not
have.  Types: nil, bool, int (every fixint/int/uint width), float64,
str (fix/8/16/32), bin (8/16/32), array (fix/16/32) and map (fix/16/32).
:func:`packb` gives the bytes ``msgpack.packb(obj, use_bin_type=True)``
gives, and :func:`unpackb` the object ``msgpack.unpackb(data,
raw=False)`` gives; any other type raises.

A state stream's leaves are large: :func:`packb` sizes the whole message
first and writes it into one ``bytearray``, and a :class:`RawBin` leaf
fills its own slice of that buffer (a tensor copies straight into it),
so no leaf's bytes are concatenated or copied twice.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Union

__all__ = ["RawBin", "packb", "unpackb", "Unpacker"]

_U32 = 0xFFFFFFFF


class RawBin:
    """A bin value of ``nbytes`` bytes that ``fill(view)`` writes into its
    slice (a writable byte ``memoryview``) of the packed message."""

    __slots__ = ("nbytes", "fill")

    def __init__(self, nbytes: int, fill: Callable[[memoryview], None]):
        self.nbytes = int(nbytes)
        self.fill = fill


_Part = Union[bytes, memoryview, RawBin]


def _header(n: int, fix: int, fix_max: int, codes: bytes,
            what: str) -> bytes:
    """The length header of a str/bin/array/map: a fix form up to
    ``fix_max`` (when ``fix`` is set), then 8-, 16- and 32-bit lengths
    (``codes`` holds their type bytes, the 8-bit one first or absent)."""
    if fix and n <= fix_max:
        return bytes((fix | n,))
    widths = ((0xFF, ">B"), (0xFFFF, ">H"), (_U32, ">I"))[3 - len(codes):]
    for code, (limit, fmt) in zip(codes, widths):
        if n <= limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"{what} of {n} too large for msgpack")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes((v,))
    if -0x20 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for code, limit, fmt in ((0xCC, 0xFF, ">B"), (0xCD, 0xFFFF, ">H"),
                                 (0xCE, _U32, ">I"),
                                 (0xCF, 0xFFFFFFFFFFFFFFFF, ">Q")):
            if v <= limit:
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        for code, limit, fmt in ((0xD0, -0x80, ">b"), (0xD1, -0x8000, ">h"),
                                 (0xD2, -0x80000000, ">i"),
                                 (0xD3, -0x8000000000000000, ">q")):
            if v >= limit:
                return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} out of msgpack's range")


def _pack(obj: Any, parts: List[_Part]) -> None:
    if obj is None:
        parts.append(b"\xc0")
    elif obj is True or obj is False:
        parts.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        parts.append(_int(int(obj)))
    elif isinstance(obj, float):
        parts.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        parts.append(_header(len(b), 0xA0, 31, b"\xd9\xda\xdb", "str"))
        parts.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        mv = memoryview(obj).cast("B")
        parts.append(_header(mv.nbytes, 0, 0, b"\xc4\xc5\xc6", "bin"))
        parts.append(mv)
    elif isinstance(obj, RawBin):
        parts.append(_header(obj.nbytes, 0, 0, b"\xc4\xc5\xc6", "bin"))
        parts.append(obj)
    elif isinstance(obj, (list, tuple)):
        parts.append(_header(len(obj), 0x90, 15, b"\xdc\xdd", "array"))
        for x in obj:
            _pack(x, parts)
    elif isinstance(obj, dict):
        parts.append(_header(len(obj), 0x80, 15, b"\xde\xdf", "map"))
        for k, v in obj.items():
            _pack(k, parts)
            _pack(v, parts)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytearray:
    """``obj`` as msgpack, in one ``bytearray`` sized up front."""
    parts: List[_Part] = []
    _pack(obj, parts)
    out = bytearray(sum(p.nbytes if isinstance(p, RawBin) else len(p)
                        for p in parts))
    view = memoryview(out)
    at = 0
    for p in parts:
        if isinstance(p, RawBin):
            p.fill(view[at:at + p.nbytes])
            at += p.nbytes
        else:
            view[at:at + len(p)] = p
            at += len(p)
    return out


class Unpacker:
    """One msgpack object from ``data``; ``bin`` maps each bin value (a
    ``memoryview`` slice of ``data``) to what the result holds: ``bytes``
    (a copy, as ``msgpack`` gives), or the slice itself, which keeps
    ``data`` alive and copies nothing."""

    def __init__(self, data, bin: Callable[[memoryview], Any] = bytes):
        self.view = memoryview(data).cast("B")
        self.bin = bin
        self.at = 0

    def _take(self, n: int) -> memoryview:
        end = self.at + n
        if end > len(self.view):
            raise ValueError(
                f"msgpack data truncated: {n} bytes wanted at offset "
                f"{self.at} of {len(self.view)}")
        out = self.view[self.at:end]
        self.at = end
        return out

    def _unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def load(self) -> Any:
        obj = self._object()
        if self.at != len(self.view):
            raise ValueError(
                f"extra data after the msgpack object: "
                f"{len(self.view) - self.at} bytes at offset {self.at}")
        return obj

    def _object(self) -> Any:
        t = self._unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        fixed = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fixed:
            return self._unpack(fixed[t])
        sized = {0xC4: (">B", self._bin), 0xC5: (">H", self._bin),
                 0xC6: (">I", self._bin), 0xD9: (">B", self._str),
                 0xDA: (">H", self._str), 0xDB: (">I", self._str),
                 0xDC: (">H", self._array), 0xDD: (">I", self._array),
                 0xDE: (">H", self._map), 0xDF: (">I", self._map)}
        if t in sized:
            fmt, read = sized[t]
            return read(self._unpack(fmt))
        raise ValueError(
            f"msgpack type byte {t:#04x} at offset {self.at - 1} is not one "
            f"a state stream holds")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _bin(self, n: int) -> Any:
        return self.bin(self._take(n))

    def _array(self, n: int) -> list:
        return [self._object() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self._object()
            out[k] = self._object()
        return out


def unpackb(data) -> Any:
    """The object msgpack ``data`` holds (bins as ``bytes``); raises
    ``ValueError`` on truncated, trailing or foreign data."""
    return Unpacker(data).load()
