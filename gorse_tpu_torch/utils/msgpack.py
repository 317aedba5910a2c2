"""A MessagePack codec in the standard library, for the port's dump stream.

:class:`Packer` writes the bytes that ``msgpack.Packer()`` writes with its
defaults (msgpack 1.x: ``use_bin_type=True``, floats as float64, every int
and str in its smallest form, lists and tuples as arrays, dicts as maps in
their order); an object of another type raises ``TypeError`` as it does
there. :class:`Unpacker` reads everything that packer writes, and the rest
of the format: float32, the str and bin families, arrays, maps (keys must
be str or bytes, as msgpack's ``strict_map_key``) and ext types, returned
as :class:`ExtType`. Strings come back as ``str``, bins as ``bytes``,
arrays as lists.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, NamedTuple

__all__ = ["ExtType", "Packer", "Unpacker", "packb", "unpackb"]


class ExtType(NamedTuple):
    code: int
    data: bytes


_B = struct.Struct(">B")
_H = struct.Struct(">BH")
_I = struct.Struct(">BI")
_Q = struct.Struct(">BQ")
_b = struct.Struct(">Bb")
_h = struct.Struct(">Bh")
_i = struct.Struct(">Bi")
_q = struct.Struct(">Bq")
_d = struct.Struct(">Bd")


def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(_B.pack(n))
    elif -0x20 <= n < 0:
        out.append(_B.pack(n & 0xFF))
    elif 0x80 <= n <= 0xFF:
        out.append(bytes((0xCC, n)))
    elif -0x80 <= n < 0:
        out.append(_b.pack(0xD0, n))
    elif 0xFF < n <= 0xFFFF:
        out.append(_H.pack(0xCD, n))
    elif -0x8000 <= n < -0x80:
        out.append(_h.pack(0xD1, n))
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out.append(_I.pack(0xCE, n))
    elif -0x80000000 <= n < -0x8000:
        out.append(_i.pack(0xD2, n))
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(_Q.pack(0xCF, n))
    elif -0x8000000000000000 <= n < -0x80000000:
        out.append(_q.pack(0xD3, n))
    else:
        raise OverflowError("Integer value out of range")


def _pack_header(n: int, fix: int, fix_max: int, codes: tuple, out: list) -> None:
    """A length header: the fix form under ``fix_max``, else 8/16/32-bit
    (``codes``; None where the family has no 8-bit form)."""
    if n < fix_max:
        out.append(_B.pack(fix | n))
    elif n <= 0xFF and codes[0] is not None:
        out.append(bytes((codes[0], n)))
    elif n <= 0xFFFF:
        out.append(_H.pack(codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(_I.pack(codes[2], n))
    else:
        raise ValueError("object too large to pack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(_d.pack(0xCB, obj))
    elif isinstance(obj, (bytes, bytearray)):
        _pack_header(len(obj), 0, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(bytes(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, memoryview):
        data = obj.tobytes()
        _pack_header(len(data), 0, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


class Packer:
    """``msgpack.Packer()``: :meth:`pack` returns one object's bytes."""

    def pack(self, obj) -> bytes:
        out: list = []
        _pack(obj, out)
        return b"".join(out)


def packb(obj) -> bytes:
    return Packer().pack(obj)


# ------------------------------------------------------------ unpacking


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes) -> None:
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        end = self.pos + st.size
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = st.unpack_from(self.buf, self.pos)
        self.pos = end
        return out[0]


_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_S8, _S16, _S32, _S64 = (struct.Struct(f">{c}") for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _read(r: _Reader):
    code = r.unpack(_U8)
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if code <= 0x8F:
        return _read_map(r, code & 0x0F)
    if code <= 0x9F:
        return [_read(r) for _ in range(code & 0x0F)]
    if code <= 0xBF:
        return r.take(code & 0x1F).decode("utf-8")
    if code == 0xC0:
        return None
    if code == 0xC2:
        return False
    if code == 0xC3:
        return True
    if code in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.unpack((_U8, _U16, _U32)[code - 0xC4])))
    if code in (0xC7, 0xC8, 0xC9):
        n = r.unpack((_U8, _U16, _U32)[code - 0xC7])
        ext = r.unpack(_S8)
        return ExtType(ext, bytes(r.take(n)))
    if code == 0xCA:
        return r.unpack(_F32)
    if code == 0xCB:
        return r.unpack(_F64)
    if 0xCC <= code <= 0xCF:
        return r.unpack((_U8, _U16, _U32, _U64)[code - 0xCC])
    if 0xD0 <= code <= 0xD3:
        return r.unpack((_S8, _S16, _S32, _S64)[code - 0xD0])
    if 0xD4 <= code <= 0xD8:
        ext = r.unpack(_S8)
        return ExtType(ext, bytes(r.take(1 << (code - 0xD4))))
    if code in (0xD9, 0xDA, 0xDB):
        return r.take(r.unpack((_U8, _U16, _U32)[code - 0xD9])).decode("utf-8")
    if code in (0xDC, 0xDD):
        return [_read(r) for _ in range(r.unpack((_U16, _U32)[code - 0xDC]))]
    if code in (0xDE, 0xDF):
        return _read_map(r, r.unpack((_U16, _U32)[code - 0xDE]))
    raise ValueError(f"unknown msgpack type 0x{code:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        if type(key) not in (str, bytes):
            raise ValueError(f"{type(key).__name__} is not allowed for map key")
        out[key] = _read(r)
    return out


class Unpacker:
    """Iterates the objects of a msgpack stream: ``src`` is bytes or a
    binary file, read to its end."""

    def __init__(self, src: bytes | bytearray | BinaryIO) -> None:
        data = src if isinstance(src, (bytes, bytearray, memoryview)) else src.read()
        self._r = _Reader(bytes(data))

    def __iter__(self):
        return self

    def __next__(self):
        if self._r.pos >= len(self._r.buf):
            raise StopIteration
        return _read(self._r)


def unpackb(data: bytes):
    """The one object in ``data``; trailing bytes raise ``ValueError``."""
    r = _Reader(bytes(data))
    out = _read(r)
    if r.pos != len(r.buf):
        raise ValueError("extra data after the msgpack object")
    return out
