"""The port's query engine (seaweedfs_tpu_torch/query/) against the JAX
package's: seeded JSON-lines and CSV documents through every predicate
operator, dotted and array paths, projections, headers and delimiters,
with equal rows."""

import json

import numpy as np
import pytest

from seaweedfs_tpu import query as ref_query
from seaweedfs_tpu_torch import query as port_query

OPS = ("", "=", "!=", "<", "<=", ">", ">=", "~")


def _docs(rng, n=60):
    """Seeded JSON documents: nested objects, arrays, nulls, numbers and
    strings that look like numbers."""
    docs = []
    for i in range(n):
        doc = {"id": i, "name": str(rng.choice(["ada", "bob", "cy", "dee"])),
               "score": round(float(rng.normal(50, 20)), 2),
               "tags": [str(t) for t in rng.choice(
                   ["a", "b", "c", "d"], int(rng.integers(0, 4)))],
               "user": {"age": int(rng.integers(10, 80)),
                        "city": str(rng.choice(["x", "y", "10"]))},
               "flag": bool(rng.integers(0, 2))}
        if rng.random() < 0.2:
            doc["opt"] = None
        if rng.random() < 0.3:
            doc["items"] = [{"k": int(rng.integers(0, 9)),
                             "v": str(rng.choice(["p", "q"]))}
                            for _ in range(int(rng.integers(1, 4)))]
        docs.append(doc)
    return docs


_FIELDS = ("id", "name", "score", "user.age", "user.city", "tags.#",
           "tags.0", "items.#.k", "items.0.v", "opt", "flag", "missing",
           "user")
_VALUES = ("", "50", "bob", "10", "2", "x", "true", "null", "abc", "3.5")


@pytest.mark.parametrize("seed", range(4))
def test_json_lines_equal(seed):
    rng = np.random.default_rng(seed)
    docs = _docs(rng)
    data = ("\n".join(json.dumps(d) for d in docs) + "\n\n").encode()
    checked = 0
    for field in _FIELDS:
        for op in OPS:
            value = str(rng.choice(_VALUES))
            proj = list(rng.choice(_FIELDS, int(rng.integers(0, 4)),
                                   replace=False))
            got = port_query.query_json_lines(
                data, proj, port_query.Query(field, op, value))
            want = ref_query.query_json_lines(
                data, proj, ref_query.Query(field, op, value))
            assert got == want, (field, op, value, proj)
            checked += bool(got)
    assert checked > 20


def _missing_as_none(mod, doc, path):
    """get_path with each package's own not-found sentinel as a marker."""
    got = mod.get_path(doc, path)
    return "<missing>" if got is mod.json_query._MISSING else got


@pytest.mark.parametrize("seed", range(2))
def test_get_path_and_single_line_equal(seed):
    docs = _docs(np.random.default_rng(seed), n=20)
    for doc in docs:
        for path in _FIELDS + ("items.1.k", "tags.9", "user.age.x", ""):
            assert _missing_as_none(port_query, doc, path) == \
                _missing_as_none(ref_query, doc, path), path
        line = json.dumps(doc)
        for field in ("id", "user.age", "tags.#"):
            q = (field, ">", "1")
            assert port_query.query_json(
                line, ["name", "user"], port_query.Query(*q)) == \
                ref_query.query_json(line, ["name", "user"],
                                     ref_query.Query(*q))
    assert port_query.query_json_lines(b"not json\n{}", [],
                                       port_query.Query()) == \
        ref_query.query_json_lines(b"not json\n{}", [], ref_query.Query())


@pytest.mark.parametrize("header,delim", [(True, ","), (False, ","),
                                          (True, "|"), (False, "\t")])
def test_csv_lines_equal(header, delim):
    rng = np.random.default_rng(7)
    cols = ["id", "name", "score", "city"]
    rows = [[str(i), str(rng.choice(["ada", "bob", "c,y"])),
             f"{rng.normal(5, 3):.2f}", str(rng.choice(["x", "10", ""]))]
            for i in range(50)]
    import csv
    import io
    sio = io.StringIO()
    w = csv.writer(sio, delimiter=delim, lineterminator="\n")
    if header:
        w.writerow(cols)
    w.writerows(rows)
    data = sio.getvalue().encode()
    names = cols if header else ["_1", "_2", "_3", "_4"]
    for field in names + ["_2", "nope", ""]:
        for op in OPS:
            for value in ("5", "bob", "10", "x"):
                for proj in ([], [names[1], names[3]], ["_1", "nope"]):
                    got = port_query.query_csv_lines(
                        data, proj, port_query.Query(field, op, value),
                        delimiter=delim, has_header=header)
                    want = ref_query.query_csv_lines(
                        data, proj, ref_query.Query(field, op, value),
                        delimiter=delim, has_header=header)
                    assert got == want, (field, op, value, proj)
    assert port_query.query_csv_lines(b"", [], port_query.Query()) == []
