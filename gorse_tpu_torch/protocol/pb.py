"""The nine messages of gorse_tpu/protocol/gorse_tpu.proto, encoded by hand
(port of its protoc output, gorse_tpu_pb2).

Each message is a dataclass with ``SerializeToString()`` and a classmethod
``FromString()``, so that protocol/rpc.py reads like the reference's. The
encoding is protoc's for proto3: fields in field-number order, default
values left out (a double by its bits, so -0.0 is written), ``int64`` as a
varint (a negative one in ten bytes), ``double`` as fixed64 little-endian,
``bool`` as a varint, repeated strings and messages one field each. Parsing
skips unknown fields of every wire type and fields whose wire type does not
match; the last value of a scalar wins.
"""

from __future__ import annotations

import dataclasses
import struct

_VARINT, _FIXED64, _LEN, _START_GROUP, _END_GROUP, _FIXED32 = 0, 1, 2, 3, 4, 5


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if i >= len(buf) or shift >= 70:
            raise DecodeError("truncated varint")
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value & ((1 << 64) - 1), i


def _skip(buf: bytes, i: int, wire: int, field: int) -> int:
    if wire == _VARINT:
        return _read_varint(buf, i)[1]
    if wire == _FIXED64:
        end = i + 8
    elif wire == _FIXED32:
        end = i + 4
    elif wire == _LEN:
        length, i = _read_varint(buf, i)
        end = i + length
    elif wire == _START_GROUP:
        while True:
            tag, i = _read_varint(buf, i)
            if tag & 7 == _END_GROUP:
                if tag >> 3 != field:
                    raise DecodeError("mismatched end group")
                return i
            i = _skip(buf, i, tag & 7, tag >> 3)
    else:
        raise DecodeError(f"invalid wire type {wire}")
    if end > len(buf):
        raise DecodeError("truncated field")
    return end


# field kinds: how a field is written and read
_STRING, _BYTES, _INT64, _DOUBLE, _BOOL = "string", "bytes", "int64", "double", "bool"
_WIRE = {_STRING: _LEN, _BYTES: _LEN, _INT64: _VARINT, _DOUBLE: _FIXED64, _BOOL: _VARINT}


class _Message:
    """Base of the messages: ``_FIELDS`` is ((number, attribute, kind,
    repeated), ...) in field-number order; a kind that is a class is a
    nested message."""

    _FIELDS: tuple = ()

    def SerializeToString(self) -> bytes:  # noqa: N802 - protobuf's name
        out = bytearray()
        for number, name, kind, repeated in self._FIELDS:
            value = getattr(self, name)
            for v in (value if repeated else (value,)):
                out += self._encode_field(number, kind, v, repeated)
        return bytes(out)

    @staticmethod
    def _encode_field(number: int, kind, v, repeated: bool) -> bytes:
        if isinstance(kind, type):
            body = v.SerializeToString()
            return _varint(number << 3 | _LEN) + _varint(len(body)) + body
        if kind in (_STRING, _BYTES):
            raw = v.encode() if kind == _STRING else bytes(v)
            if not raw and not repeated:
                return b""
            return _varint(number << 3 | _LEN) + _varint(len(raw)) + raw
        if kind == _DOUBLE:
            raw = struct.pack("<d", v)
            return b"" if raw == bytes(8) else _varint(number << 3 | _FIXED64) + raw
        v = int(v)
        return _varint(number << 3 | _VARINT) + _varint(v) if v else b""

    @classmethod
    def FromString(cls, data: bytes):  # noqa: N802 - protobuf's name
        fields = {number: (name, kind, repeated) for number, name, kind, repeated in cls._FIELDS}
        values: dict = {}
        buf = bytes(data)
        i = 0
        while i < len(buf):
            tag, i = _read_varint(buf, i)
            number, wire = tag >> 3, tag & 7
            if number == 0:
                raise DecodeError("field number 0")
            spec = fields.get(number)
            expected = None if spec is None else (
                _LEN if isinstance(spec[1], type) else _WIRE[spec[1]])
            if spec is None or wire != expected:
                i = _skip(buf, i, wire, number)
                continue
            name, kind, repeated = spec
            if wire == _LEN:
                length, i = _read_varint(buf, i)
                if i + length > len(buf):
                    raise DecodeError("truncated field")
                raw, i = buf[i:i + length], i + length
                if isinstance(kind, type):
                    v = kind.FromString(raw)
                elif kind == _STRING:
                    try:
                        v = raw.decode()
                    except UnicodeDecodeError as e:
                        raise DecodeError(f"invalid UTF-8 in field {name}") from e
                else:
                    v = raw
            elif wire == _FIXED64:
                if i + 8 > len(buf):
                    raise DecodeError("truncated field")
                v, i = struct.unpack("<d", buf[i:i + 8])[0], i + 8
            else:
                v, i = _read_varint(buf, i)
                if kind == _INT64:
                    v = v - (1 << 64) if v >> 63 else v
                else:
                    v = bool(v)
            if repeated:
                values.setdefault(name, []).append(v)
            else:
                values[name] = v
        return cls(**values)


def _message(name: str, fields, doc: str):
    """A message dataclass of ``fields``: (number, attribute, kind, repeated)."""
    defaults = {_STRING: "", _BYTES: b"", _INT64: 0, _DOUBLE: 0.0, _BOOL: False}
    cls = dataclasses.make_dataclass(
        name,
        [(attr, list if repeated else object,
          dataclasses.field(default_factory=list) if repeated
          else dataclasses.field(default=defaults[kind]))
         for _, attr, kind, repeated in fields],
        bases=(_Message,),
        namespace={"_FIELDS": tuple(fields), "__doc__": doc},
    )
    cls.__module__ = __name__
    return cls


NodeInfo = _message("NodeInfo", (
    (1, "uuid", _STRING, False), (2, "hostname", _STRING, False),
    (3, "node_type", _STRING, False), (4, "version", _STRING, False),
), "A node's registration (GetMeta's request).")
Meta = _message("Meta", (
    (1, "config_json", _STRING, False), (2, "cf_model_id", _STRING, False),
    (3, "ctr_model_id", _STRING, False), (4, "servers", _STRING, True),
    (5, "workers", _STRING, True),
), "The config JSON, the model ids and the peer lists (GetMeta's answer).")
ProgressSpan = _message("ProgressSpan", (
    (1, "name", _STRING, False), (2, "total", _INT64, False), (3, "count", _INT64, False),
    (4, "status", _STRING, False), (5, "start_time", _DOUBLE, False),
    (6, "finish_time", _DOUBLE, False), (7, "error", _STRING, False),
), "One task span of a node's progress.")
Progress = _message("Progress", (
    (1, "uuid", _STRING, False), (2, "spans", ProgressSpan, True),
), "A node's progress (PushProgress's request).")
PushProgressResponse = _message("PushProgressResponse", (), "PushProgress's empty answer.")
BlobChunk = _message("BlobChunk", (
    (1, "name", _STRING, False), (2, "filename", _STRING, False),
    (3, "data", _BYTES, False), (4, "eof", _BOOL, False),
), "A chunk of a file of a blob (Upload's requests, Download's answers).")
BlobRequest = _message("BlobRequest", ((1, "name", _STRING, False),),
                       "A blob's name (Download's and List's request).")
BlobList = _message("BlobList", ((1, "names", _STRING, True),), "The blob names (List's answer).")
UploadResponse = _message("UploadResponse", ((1, "bytes_received", _INT64, False),),
                          "The bytes an upload wrote (Upload's answer).")

MESSAGES = (NodeInfo, Meta, ProgressSpan, Progress, PushProgressResponse, BlobChunk,
            BlobRequest, BlobList, UploadResponse)
