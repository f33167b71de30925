"""CSV scan/filter: the part the reference stubs out
(volume_grpc_query.go:38 `if req.InputSerialization.CsvInput != nil {}`).

Columns are addressed by header name (when has_header) or `_1`, `_2`, …
positional names, like S3 Select.
"""

from __future__ import annotations

import csv
import io
from typing import Any

from .json_query import Query, _compare  # shared predicate semantics


def _coerce(s: str) -> Any:
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return s


def query_csv_lines(data: bytes, projections: list[str], query: Query,
                    delimiter: str = ",",
                    has_header: bool = False) -> list[list[Any]]:
    text = data.decode("utf-8", errors="replace")
    reader = csv.reader(io.StringIO(text), delimiter=delimiter or ",")
    rows = list(reader)
    if not rows:
        return []
    if has_header:
        header = rows[0]
        rows = rows[1:]
    else:
        header = []
    results = []
    for row in rows:
        rec = {f"_{i + 1}": v for i, v in enumerate(row)}
        rec.update({h: v for h, v in zip(header, row)})
        if query.field:
            if query.field not in rec:
                continue
            if not _compare(_coerce(rec[query.field]), query.op, query.value):
                continue
        if projections:
            results.append([_coerce(rec[p]) if p in rec else None
                            for p in projections])
        else:
            results.append(row)
    return results
