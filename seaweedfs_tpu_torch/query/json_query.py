"""JSON line filtering with dotted-path lookups.

Behavior mirrors reference weed/query/json/query_json.go:17 (QueryJson:
filter on one (field, op, value) predicate, then project paths), :29
(filterJson), with the gjson path subset we need: dotted keys, numeric
array indices, `#` for array length, and `array.#.key` fan-out.
Comparison semantics follow query_json.go:45-106 — string compares for
string values, numeric compares for numbers, existence when op is "".
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any


@dataclass
class Query:
    field: str = ""
    op: str = ""  # "", =, !=, <, <=, >, >=
    value: str = ""


_MISSING = object()


def get_path(doc: Any, path: str):
    """Dotted-path getter; returns _MISSING sentinel when absent.
    `arr.#` is the array length; `arr.#.rest` fans out `rest` over the
    elements (gjson semantics), dropping elements where it's absent."""
    if not path:
        return _MISSING
    cur = doc
    parts = path.split(".")
    for i, part in enumerate(parts):
        if isinstance(cur, list):
            if part == "#":
                rest = ".".join(parts[i + 1:])
                if not rest:
                    return len(cur)
                fan = [get_path(el, rest) for el in cur]
                return [v for v in fan if v is not _MISSING]
            try:
                cur = cur[int(part)]
                continue
            except (ValueError, IndexError):
                return _MISSING
        if isinstance(cur, dict):
            if part in cur:
                cur = cur[part]
                continue
            return _MISSING
        return _MISSING
    return cur


def _compare(value: Any, op: str, rhs: str) -> bool:
    if value is _MISSING:
        return False
    if op == "":
        return True  # existence check (query_json.go:39-44)
    if isinstance(value, list):
        # fan-out result: the predicate matches if any element matches
        return any(_compare(v, op, rhs) for v in value)
    if isinstance(value, bool):
        want = rhs.lower() == "true"
        return (value == want) if op == "=" else (
            value != want if op == "!=" else False)
    if isinstance(value, (int, float)):
        try:
            r = float(rhs)
        except ValueError:
            return False
        return {"=": value == r, "!=": value != r, "<": value < r,
                "<=": value <= r, ">": value > r, ">=": value >= r}.get(op, False)
    if isinstance(value, str):
        return {"=": value == rhs, "!=": value != rhs, "<": value < rhs,
                "<=": value <= rhs, ">": value > rhs,
                ">=": value >= rhs}.get(op, False)
    if value is None:
        return op == "=" and rhs.lower() in ("null", "")
    return False


def query_json(line: str, projections: list[str],
               query: Query) -> tuple[bool, list[Any]]:
    """One JSON document: (passed_filter, projected values).
    Reference QueryJson query_json.go:17."""
    try:
        doc = json.loads(line)
    except json.JSONDecodeError:
        return False, []
    if query.field:
        if not _compare(get_path(doc, query.field), query.op, query.value):
            return False, []
    if not projections:
        return True, [doc]
    out = []
    for p in projections:
        v = get_path(doc, p)
        out.append(None if v is _MISSING else v)
    return True, out


def query_json_lines(data: bytes, projections: list[str],
                     query: Query) -> list[list[Any]]:
    """Newline-delimited JSON scan (the volume Query RPC input shape)."""
    results = []
    for raw in data.splitlines():
        raw = raw.strip()
        if not raw:
            continue
        ok, values = query_json(raw.decode("utf-8", errors="replace"),
                                projections, query)
        if ok:
            results.append(values)
    return results
