"""Minimal BSON codec (bsonspec.org) — the subset MongoDB commands use.

Hand-rolled from the public spec (no pymongo in the image): doubles,
strings, embedded documents, arrays, binary (subtype 0), booleans, null,
int32, int64. Dict order is preserved (BSON documents are ordered; the
first key of a command document IS the command name).

Used by filer/mongo_store.py (the OP_MSG client) and utils/mini_mongo.py
(the in-process protocol double that decodes and verifies every frame).

The port's copy of seaweedfs_tpu/utils/bson_lite.py, unchanged: the
port's mongo store and MiniMongo encode the reference's bytes.
"""

from __future__ import annotations

import struct

_DOUBLE = 0x01
_STRING = 0x02
_DOC = 0x03
_ARRAY = 0x04
_BINARY = 0x05
_OBJECTID = 0x07
_BOOL = 0x08
_DATETIME = 0x09
_NULL = 0x0A
_INT32 = 0x10
_TIMESTAMP = 0x11
_INT64 = 0x12

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


class Int64(int):
    """Force int64 (0x12) encoding — the protocol requires it for some
    fields (e.g. getMore) regardless of magnitude."""


def encode(doc: dict) -> bytes:
    out = bytearray()
    for key, value in doc.items():
        _encode_element(out, key, value)
    return _I32.pack(len(out) + 5) + bytes(out) + b"\x00"


def _encode_element(out: bytearray, key: str, value) -> None:
    name = key.encode() + b"\x00"
    if isinstance(value, bool):  # before int (bool is an int subclass)
        out += bytes([_BOOL]) + name + (b"\x01" if value else b"\x00")
    elif isinstance(value, float):
        out += bytes([_DOUBLE]) + name + _F64.pack(value)
    elif isinstance(value, Int64):
        out += bytes([_INT64]) + name + _I64.pack(value)
    elif isinstance(value, int):
        if -(2**31) <= value < 2**31:
            out += bytes([_INT32]) + name + _I32.pack(value)
        else:
            out += bytes([_INT64]) + name + _I64.pack(value)
    elif isinstance(value, str):
        raw = value.encode()
        out += bytes([_STRING]) + name + _I32.pack(len(raw) + 1) + raw + b"\x00"
    elif isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
        out += bytes([_BINARY]) + name + _I32.pack(len(raw)) + b"\x00" + raw
    elif value is None:
        out += bytes([_NULL]) + name
    elif isinstance(value, dict):
        out += bytes([_DOC]) + name + encode(value)
    elif isinstance(value, (list, tuple)):
        out += bytes([_ARRAY]) + name + encode(
            {str(i): v for i, v in enumerate(value)})
    else:
        raise TypeError(f"bson: unsupported type {type(value).__name__}")


def decode(data: bytes, offset: int = 0) -> tuple[dict, int]:
    """Decode one document at `offset`; returns (doc, next_offset)."""
    (total,) = _I32.unpack_from(data, offset)
    end = offset + total
    if data[end - 1] != 0:
        raise ValueError("bson: document missing trailing NUL")
    pos = offset + 4
    doc: dict = {}
    while pos < end - 1:
        etype = data[pos]
        pos += 1
        nul = data.index(b"\x00", pos)
        key = data[pos:nul].decode()
        pos = nul + 1
        if etype == _DOUBLE:
            (doc[key],) = _F64.unpack_from(data, pos)
            pos += 8
        elif etype == _STRING:
            (ln,) = _I32.unpack_from(data, pos)
            doc[key] = data[pos + 4:pos + 4 + ln - 1].decode()
            pos += 4 + ln
        elif etype in (_DOC, _ARRAY):
            sub, pos = decode(data, pos)
            doc[key] = (list(sub.values()) if etype == _ARRAY else sub)
        elif etype == _BINARY:
            (ln,) = _I32.unpack_from(data, pos)
            doc[key] = bytes(data[pos + 5:pos + 5 + ln])
            pos += 5 + ln
        elif etype == _BOOL:
            doc[key] = data[pos] == 1
            pos += 1
        elif etype == _NULL:
            doc[key] = None
        elif etype == _INT32:
            (doc[key],) = _I32.unpack_from(data, pos)
            pos += 4
        elif etype in (_INT64, _DATETIME):
            # datetime decodes to UTC millis (real mongod replies carry
            # localTime; the stores never interpret it)
            (doc[key],) = _I64.unpack_from(data, pos)
            if etype == _INT64:
                doc[key] = Int64(doc[key])
            pos += 8
        elif etype == _TIMESTAMP:
            (doc[key],) = struct.unpack_from("<Q", data, pos)
            pos += 8
        elif etype == _OBJECTID:
            doc[key] = bytes(data[pos:pos + 12])
            pos += 12
        else:
            raise ValueError(f"bson: unsupported element type 0x{etype:02x}")
    return doc, end
