"""Structured-record schema for MQ topics (reference weed/mq/schema/:
schema.go, schema_builder.go, struct_to_schema.go, to_schema_value.go).

Three capabilities, mirroring the reference:
  * infer_record_type(value)   — Python dict/dataclass -> RecordType proto
    (struct_to_schema.go's reflection walk, over Python types);
  * encode/decode              — typed record dict <-> RecordValue proto
    bytes, validated against the schema (value_builder.go /
    to_schema_value.go);
  * to_columnar/from_columnar  — a batch of records <-> flat numpy
    columns. The reference maps records onto PARQUET (to_parquet_schema.go
    with def/rep levels); the tpu-native analogue is columnar numpy:
    nested record fields flatten to dotted column paths exactly like
    parquet column paths, and list fields become (offsets, values) pairs —
    the layout `torch.from_numpy` ingests without host-side reshuffling.
    Full parquet def/rep level encoding for nullable nesting is a
    documented simplification: fields here are required (proto3
    semantics), so def levels are constant and omitted.

The port's copy of seaweedfs_tpu/mq/schema.py; the code is unchanged (its
RecordType, RecordValue and column bytes equal the reference's), and this
module, like the reference's, needs only numpy, not the device library.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..pb import mq_schema_pb2 as spb

# -- scalar type table -------------------------------------------------------

_SCALAR_DTYPES = {
    spb.BOOL: np.dtype(np.bool_),
    spb.INT32: np.dtype(np.int32),
    spb.INT64: np.dtype(np.int64),
    spb.FLOAT: np.dtype(np.float32),
    spb.DOUBLE: np.dtype(np.float64),
}
_VALUE_FIELD = {
    spb.BOOL: "bool_value",
    spb.INT32: "int32_value",
    spb.INT64: "int64_value",
    spb.FLOAT: "float_value",
    spb.DOUBLE: "double_value",
    spb.BYTES: "bytes_value",
    spb.STRING: "string_value",
}


def scalar(kind: int) -> spb.Type:
    return spb.Type(scalar_type=kind)


TypeBool = scalar(spb.BOOL)
TypeInt32 = scalar(spb.INT32)
TypeInt64 = scalar(spb.INT64)
TypeFloat = scalar(spb.FLOAT)
TypeDouble = scalar(spb.DOUBLE)
TypeBytes = scalar(spb.BYTES)
TypeString = scalar(spb.STRING)


# -- builder (reference schema_builder.go) -----------------------------------

class RecordTypeBuilder:
    """record_type_begin().with_field(...).record_type_end() chain."""

    def __init__(self):
        self._fields: list[spb.Field] = []

    def with_field(self, name: str, ftype: spb.Type) -> "RecordTypeBuilder":
        self._fields.append(spb.Field(name=name, type=ftype))
        return self

    def with_record_field(self, name: str,
                          rec: "RecordTypeBuilder") -> "RecordTypeBuilder":
        self._fields.append(spb.Field(
            name=name, type=spb.Type(record_type=rec.build())))
        return self

    def with_list_field(self, name: str,
                        element: spb.Type) -> "RecordTypeBuilder":
        self._fields.append(spb.Field(name=name, type=spb.Type(
            list_type=spb.ListType(element_type=element))))
        return self

    def build(self) -> spb.RecordType:
        rt = spb.RecordType()
        for i, f in enumerate(sorted(self._fields, key=lambda f: f.name)):
            f.field_index = i
            rt.fields.append(f)
        return rt


def record_type_begin() -> RecordTypeBuilder:
    return RecordTypeBuilder()


# -- inference (reference struct_to_schema.go) -------------------------------

def _infer_type(v: Any) -> spb.Type:
    if isinstance(v, bool):
        return TypeBool
    if isinstance(v, int):
        return TypeInt64 if abs(v) > 0x7FFFFFFF else TypeInt32
    if isinstance(v, float):
        return TypeDouble
    if isinstance(v, bytes):
        return TypeBytes
    if isinstance(v, str):
        return TypeString
    if isinstance(v, (list, tuple)):
        if not v:
            raise ValueError("cannot infer element type of an empty list")
        return spb.Type(list_type=spb.ListType(element_type=_infer_type(v[0])))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        v = dataclasses.asdict(v)
    if isinstance(v, dict):
        return spb.Type(record_type=infer_record_type(v))
    raise TypeError(f"unsupported field type {type(v).__name__}")


def infer_record_type(value: Any) -> spb.RecordType:
    """Schema from an example record (dict or dataclass instance)."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        value = dataclasses.asdict(value)
    if not isinstance(value, dict):
        raise TypeError("record must be a dict or dataclass instance")
    b = record_type_begin()
    for name, v in value.items():
        b.with_field(name, _infer_type(v))
    return b.build()


# -- value encode/decode (reference to_schema_value.go, value_builder.go) ----

def _encode_value(v: Any, ftype: spb.Type) -> spb.Value:
    out = spb.Value()
    kind = ftype.WhichOneof("kind")
    if kind == "scalar_type":
        attr = _VALUE_FIELD[ftype.scalar_type]
        if ftype.scalar_type == spb.BOOL and not isinstance(v, bool):
            raise TypeError(f"expected bool, got {type(v).__name__}")
        setattr(out, attr, v)
    elif kind == "list_type":
        for item in v:
            out.list_value.values.append(
                _encode_value(item, ftype.list_type.element_type))
        # presence: an empty list must still mark the oneof
        out.list_value.SetInParent()
    elif kind == "record_type":
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            v = dataclasses.asdict(v)
        out.record_value.CopyFrom(_encode_record(v, ftype.record_type))
    else:
        raise TypeError(f"field type has no kind: {ftype}")
    return out


def _encode_record(record: dict, rt: spb.RecordType) -> spb.RecordValue:
    rv = spb.RecordValue()
    for f in rt.fields:
        if f.name not in record:
            raise KeyError(f"record missing field {f.name!r}")
        rv.fields[f.name].CopyFrom(_encode_value(record[f.name], f.type))
    extra = set(record) - {f.name for f in rt.fields}
    if extra:
        raise KeyError(f"record has fields not in schema: {sorted(extra)}")
    return rv


def _decode_value(val: spb.Value, ftype: spb.Type) -> Any:
    kind = ftype.WhichOneof("kind")
    if kind == "scalar_type":
        return getattr(val, _VALUE_FIELD[ftype.scalar_type])
    if kind == "list_type":
        return [_decode_value(x, ftype.list_type.element_type)
                for x in val.list_value.values]
    return _decode_record(val.record_value, ftype.record_type)


def _decode_record(rv: spb.RecordValue, rt: spb.RecordType) -> dict:
    return {f.name: _decode_value(rv.fields[f.name], f.type)
            for f in rt.fields}


class Schema:
    """A validated RecordType + its codec (reference schema.go Schema)."""

    def __init__(self, record_type: spb.RecordType):
        self.record_type = record_type
        self.fields = {f.name: f for f in record_type.fields}

    @classmethod
    def infer(cls, example: Any) -> "Schema":
        return cls(infer_record_type(example))

    @classmethod
    def from_bytes(cls, data: bytes) -> "Schema":
        rt = spb.RecordType()
        rt.ParseFromString(data)
        return cls(rt)

    def schema_bytes(self) -> bytes:
        return self.record_type.SerializeToString()

    def encode(self, record: dict | Any) -> bytes:
        if dataclasses.is_dataclass(record) and not isinstance(record, type):
            record = dataclasses.asdict(record)
        return _encode_record(record, self.record_type).SerializeToString()

    def decode(self, data: bytes) -> dict:
        rv = spb.RecordValue()
        rv.ParseFromString(data)
        return _decode_record(rv, self.record_type)

    # -- columnar batches (the parquet-mapping analogue) ---------------------
    def _columns(self, rt: spb.RecordType | None = None, prefix: str = ""
                 ) -> list[tuple[str, spb.Type]]:
        cols = []
        for f in (rt or self.record_type).fields:
            path = f"{prefix}{f.name}"
            kind = f.type.WhichOneof("kind")
            if kind == "record_type":
                cols.extend(self._columns(f.type.record_type, path + "."))
            else:
                cols.append((path, f.type))
        return cols

    def to_columnar(self, records: list[dict]) -> dict[str, np.ndarray]:
        """Batch of records -> {column path: numpy array}. Scalar columns
        are dense arrays; bytes/str columns are object arrays; a list
        column becomes `path.offsets` (int64, n+1 prefix sums — parquet's
        repetition structure collapsed for required fields) plus
        `path.values`."""
        def get(rec: dict, path: str):
            cur: Any = rec
            for part in path.split("."):
                if dataclasses.is_dataclass(cur) and not isinstance(cur, type):
                    cur = dataclasses.asdict(cur)
                cur = cur[part]
            return cur

        out: dict[str, np.ndarray] = {}
        for path, ftype in self._columns():
            kind = ftype.WhichOneof("kind")
            vals = [get(r, path) for r in records]
            if kind == "scalar_type":
                dt = _SCALAR_DTYPES.get(ftype.scalar_type)
                out[path] = (np.array(vals, dtype=dt) if dt is not None
                             else np.array(vals, dtype=object))
            else:  # list
                el = ftype.list_type.element_type
                dt = (_SCALAR_DTYPES.get(el.scalar_type)
                      if el.WhichOneof("kind") == "scalar_type" else None)
                lens = np.array([len(v) for v in vals], dtype=np.int64)
                out[f"{path}.offsets"] = np.concatenate(
                    ([0], np.cumsum(lens)))
                flat = [x for v in vals for x in v]
                out[f"{path}.values"] = (
                    np.array(flat, dtype=dt) if dt is not None
                    else np.array(flat, dtype=object))
        return out

    def from_columnar(self, cols: dict[str, np.ndarray]) -> list[dict]:
        paths = self._columns()
        n = None
        for path, ftype in paths:
            key = (path if ftype.WhichOneof("kind") == "scalar_type"
                   else f"{path}.offsets")
            m = (len(cols[key]) if ftype.WhichOneof("kind") == "scalar_type"
                 else len(cols[key]) - 1)
            if n is None:
                n = m
            elif n != m:
                raise ValueError(f"column {path}: {m} rows, expected {n}")
        records: list[dict] = [{} for _ in range(n or 0)]

        def put(rec: dict, path: str, v: Any):
            parts = path.split(".")
            for part in parts[:-1]:
                rec = rec.setdefault(part, {})
            rec[parts[-1]] = v

        for path, ftype in paths:
            if ftype.WhichOneof("kind") == "scalar_type":
                col = cols[path]
                for i in range(n):
                    put(records[i], path, col[i].item()
                        if isinstance(col[i], np.generic) else col[i])
            else:
                offs = cols[f"{path}.offsets"]
                vals = cols[f"{path}.values"]
                for i in range(n):
                    seg = vals[offs[i]:offs[i + 1]]
                    put(records[i], path,
                        [x.item() if isinstance(x, np.generic) else x
                         for x in seg])
        return records
