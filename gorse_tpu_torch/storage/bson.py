"""Minimal BSON codec for the MongoDB wire client (copy of
gorse_tpu/storage/bson.py): double, string, document, array, binary
(subtype 0), bool, null, int32, int64 — the types the Mongo stores
exchange."""

from __future__ import annotations

import struct

__all__ = ["decode", "decode_all", "encode"]


def _encode_value(out: bytearray, key: str, v) -> None:
    name = key.encode() + b"\0"
    if isinstance(v, bool):  # before int — bool is an int subclass
        out += b"\x08" + name + (b"\x01" if v else b"\x00")
    elif isinstance(v, float):
        out += b"\x01" + name + struct.pack("<d", v)
    elif isinstance(v, str):
        b = v.encode()
        out += b"\x02" + name + struct.pack("<i", len(b) + 1) + b + b"\0"
    elif isinstance(v, dict):
        out += b"\x03" + name + encode(v)
    elif isinstance(v, (list, tuple)):
        out += b"\x04" + name + encode({str(i): x for i, x in enumerate(v)})
    elif isinstance(v, (bytes, bytearray)):
        out += b"\x05" + name + struct.pack("<i", len(v)) + b"\x00" + bytes(v)
    elif v is None:
        out += b"\x0a" + name
    elif isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            out += b"\x10" + name + struct.pack("<i", v)
        else:
            out += b"\x12" + name + struct.pack("<q", v)
    else:
        raise TypeError(f"cannot BSON-encode {type(v).__name__}")


def encode(doc: dict) -> bytes:
    body = bytearray()
    for k, v in doc.items():
        _encode_value(body, k, v)
    return struct.pack("<i", len(body) + 5) + bytes(body) + b"\0"


def _decode_value(data: bytes, off: int, typ: int):
    if typ == 0x01:
        return struct.unpack_from("<d", data, off)[0], off + 8
    if typ == 0x02:
        (n,) = struct.unpack_from("<i", data, off)
        return data[off + 4 : off + 4 + n - 1].decode(), off + 4 + n
    if typ == 0x03:
        (n,) = struct.unpack_from("<i", data, off)
        return decode(data[off : off + n]), off + n
    if typ == 0x04:
        (n,) = struct.unpack_from("<i", data, off)
        d = decode(data[off : off + n])
        return [d[str(i)] for i in range(len(d))], off + n
    if typ == 0x05:
        (n,) = struct.unpack_from("<i", data, off)
        return bytes(data[off + 5 : off + 5 + n]), off + 5 + n
    if typ == 0x07:  # ObjectId — surfaced as raw bytes
        return bytes(data[off : off + 12]), off + 12
    if typ == 0x08:
        return data[off] == 1, off + 1
    if typ == 0x09:  # UTC datetime (ms) — surfaced as int
        return struct.unpack_from("<q", data, off)[0], off + 8
    if typ == 0x0A:
        return None, off
    if typ == 0x10:
        return struct.unpack_from("<i", data, off)[0], off + 4
    if typ == 0x11 or typ == 0x12:
        return struct.unpack_from("<q", data, off)[0], off + 8
    raise ValueError(f"unsupported BSON type 0x{typ:02x}")


def decode(data: bytes) -> dict:
    (total,) = struct.unpack_from("<i", data, 0)
    off, out = 4, {}
    while off < total - 1:
        typ = data[off]
        off += 1
        end = data.index(b"\0", off)
        key = data[off:end].decode()
        off = end + 1
        out[key], off = _decode_value(data, off, typ)
    return out


def decode_all(data: bytes) -> list[dict]:
    docs, off = [], 0
    while off < len(data):
        (n,) = struct.unpack_from("<i", data, off)
        docs.append(decode(data[off : off + n]))
        off += n
    return docs
