"""The Prometheus text exposition of a server's /metrics, parsed into
{(name, ((label, value), ...)): number}, and the difference of two
scrapes."""

from __future__ import annotations

import re

_LINE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?\s+(\S+)")
_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str) -> "dict[tuple, float]":
    out: "dict[tuple, float]" = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if m is None:
            continue
        labels = tuple(sorted(_LABEL.findall(m.group(2) or "")))
        try:
            out[(m.group(1), labels)] = float(m.group(3))
        except ValueError:
            continue
    return out


def delta(before: "dict[tuple, float]",
          after: "dict[tuple, float]") -> "dict[tuple, float]":
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def total(series: "dict[tuple, float]", name: str, **want) -> float:
    """Sum of series `name` whose labels hold every `want` pair; a value
    starting with "!" matches anything but the rest of it."""
    s = 0.0
    for (n, labels), v in series.items():
        if n != name:
            continue
        lab = dict(labels)
        ok = True
        for k, w in want.items():
            have = lab.get(k)
            ok = have != w[1:] if w.startswith("!") else have == w
            if not ok:
                break
        if ok:
            s += v
    return s
