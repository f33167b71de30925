"""THE Prometheus text-exposition parser — one grammar, two consumers.

The port's copy of seaweedfs_tpu/stats/parse.py.

Before the telemetry plane, the only code that understood the
exposition grammar was the lint (`expo_lint.check_exposition`), and it
could only *validate* — nothing in the tree could read a scrape back
into values. The fleet collector (telemetry/collector.py) needs exactly
that: parse every node's /metrics into families + samples it can ingest
into the ring TSDB and merge across nodes. So the grammar lives here,
once: `expo_lint` imports this module for all tokenizing/structure and
keeps only the semantic lint rules (histogram monotonicity, registry
cardinality ceilings) on top.

Grammar follows the text format spec (version 0.0.4) plus the
OpenMetrics constructs our renderer emits: HELP/TYPE comment lines,
sample lines `name[{labels}] value [timestamp] [# exemplar]`, label
values with \\\\ \\" \\n escapes, the `# EOF` terminator, and
suffix-free `# TYPE <family> counter` headers over `<family>_total`
samples. The round-trip contract is `parse(render()) == registry state`.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple

NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
# a label VALUE is any run of chars with \\ \" \n escaped
LABEL_VALUE_RE = re.compile(r'"((?:[^"\\\n]|\\\\|\\"|\\n)*)"')

# sample-name suffixes that roll up into a histogram family
HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")

_TYPE_KINDS = ("counter", "gauge", "histogram", "summary",
               "untyped", "unknown")


class ParseError(ValueError):
    def __init__(self, lineno: int, line: str, why: str):
        super().__init__(f"line {lineno}: {why}: {line[:120]!r}")
        self.lineno = lineno
        self.why = why


class Sample(NamedTuple):
    """One sample line. `labels` is a sorted tuple of (name, value)
    pairs so samples are hashable and comparable; `label_dict()` gives
    the mapping view."""
    name: str
    labels: tuple[tuple[str, str], ...]
    value: float
    timestamp: float | None = None

    def label_dict(self) -> dict[str, str]:
        return dict(self.labels)


class Family:
    """A metric family: the HELP/TYPE header plus every sample that
    rolled up under it (histogram `_bucket`/`_sum`/`_count` samples
    land on their base family)."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help_text: str = ""):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: list[Sample] = []

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Family({self.name!r}, {self.kind!r}, "
                f"{len(self.samples)} samples)")


def unescape_label_value(raw: str) -> str:
    return (raw.replace("\\\\", "\x00").replace('\\"', '"')
            .replace("\\n", "\n").replace("\x00", "\\"))


def parse_labels(lineno: int, line: str, raw: str) -> dict[str, str]:
    """The label block body (between the braces) -> {name: value},
    raising on bad names, bad escaping, duplicates, or junk."""
    labels: dict[str, str] = {}
    pos = 0
    while pos < len(raw):
        m = LABEL_NAME_RE.match(raw, pos)
        if m is None:
            raise ParseError(lineno, line, "bad label name")
        name = m.group(0)
        pos = m.end()
        if raw[pos:pos + 1] != "=":
            raise ParseError(lineno, line, "label missing '='")
        pos += 1
        vm = LABEL_VALUE_RE.match(raw, pos)
        if vm is None:
            raise ParseError(lineno, line,
                             "bad label value escaping/quoting")
        if name in labels:
            raise ParseError(lineno, line, f"duplicate label {name}")
        labels[name] = unescape_label_value(vm.group(1))
        pos = vm.end()
        if raw[pos:pos + 1] == ",":
            pos += 1
        elif pos != len(raw):
            raise ParseError(lineno, line, "junk between labels")
    return labels


def label_block_end(raw: str) -> int:
    """Index of the closing '}' of a label block (raw starts just after
    the opening '{'), honoring quoted values and escapes."""
    in_quotes = False
    escaped = False
    for i, ch in enumerate(raw):
        if escaped:
            escaped = False
        elif ch == "\\":
            escaped = True
        elif ch == '"':
            in_quotes = not in_quotes
        elif ch == "}" and not in_quotes:
            return i
    return -1


def family_of(name: str) -> str:
    for suf in HISTOGRAM_SUFFIXES:
        if name.endswith(suf):
            return name[: -len(suf)]
    return name


def parse_sample_line(lineno: int, line: str) -> Sample:
    """One `name[{labels}] value [timestamp] [# exemplar]` line."""
    m = NAME_RE.match(line)
    if m is None:
        raise ParseError(lineno, line, "bad sample name")
    name = m.group(0)
    rest = line[m.end():]
    labels: dict[str, str] = {}
    if rest.startswith("{"):
        # quote-aware scan for the closing brace: an OpenMetrics
        # exemplar later on the line has its own braces, so rfind
        # would overshoot
        end = label_block_end(rest[1:])
        if end < 0:
            raise ParseError(lineno, line, "unclosed label braces")
        labels = parse_labels(lineno, line, rest[1:1 + end])
        rest = rest[end + 2:]
    toks = rest.split("#", 1)[0].split()
    if not toks:
        raise ParseError(lineno, line, "sample without value")
    try:
        value = float(toks[0])
    except ValueError:
        raise ParseError(lineno, line,
                         f"bad sample value {toks[0]!r}") from None
    if len(toks) > 2:
        raise ParseError(lineno, line, "junk after timestamp")
    ts = None
    if len(toks) == 2:
        try:
            ts = float(toks[1])
        except ValueError:
            raise ParseError(lineno, line,
                             f"bad timestamp {toks[1]!r}") from None
    return Sample(name, tuple(sorted(labels.items())), value, ts)


def parse_exposition(text: str) -> dict[str, Family]:
    """One full scrape body -> {family name: Family}, strict about the
    grammar (first violation raises ParseError). Handles both the plain
    0.0.4 rendering and the OpenMetrics dialect our registry emits
    (exemplars, `# EOF`, suffix-free counter headers over `_total`
    samples)."""
    families: dict[str, Family] = {}
    helps: dict[str, str] = {}
    types: dict[str, str] = {}
    for lineno, line in enumerate(text.split("\n"), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] == "EOF":
                continue  # OpenMetrics terminator
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ParseError(lineno, line, "malformed comment")
            name = parts[2]
            if NAME_RE.fullmatch(name) is None:
                raise ParseError(lineno, line, "bad metric name")
            if parts[1] == "HELP":
                if name in helps:
                    raise ParseError(lineno, line, "duplicate HELP")
                helps[name] = parts[3] if len(parts) > 3 else ""
            else:
                if name in types:
                    raise ParseError(lineno, line, "duplicate TYPE")
                if len(parts) < 4 or parts[3] not in _TYPE_KINDS:
                    raise ParseError(lineno, line, "bad TYPE kind")
                if name not in helps:
                    raise ParseError(lineno, line,
                                     "TYPE without preceding HELP")
                types[name] = parts[3]
                families[name] = Family(name, parts[3], helps[name])
            continue
        sample = parse_sample_line(lineno, line)
        name = sample.name
        family = family_of(name)
        if family not in types and name not in types:
            # OpenMetrics counters: sample `<family>_total` under a
            # suffix-free `# TYPE <family> counter` header
            base = (name[:-len("_total")] if name.endswith("_total")
                    else name)
            if types.get(base) == "counter":
                family = base
            else:
                raise ParseError(lineno, line,
                                 "sample without HELP/TYPE header")
        elif family not in types:
            # the full sample name is itself a declared family (e.g. a
            # gauge whose name happens to end in a histogram suffix)
            family = name
        fam_type = types[family]
        if name != family and fam_type != "histogram" and not (
                fam_type == "counter" and name == f"{family}_total"):
            raise ParseError(lineno, line,
                             f"suffix sample for non-histogram {fam_type}")
        if fam_type == "histogram" and name.endswith("_bucket") \
                and "le" not in dict(sample.labels):
            raise ParseError(lineno, line, "histogram bucket without le")
        families[family].samples.append(sample)
    return families


def histogram_series(family: Family
                     ) -> dict[tuple[tuple[str, str], ...], dict]:
    """Group a histogram family's samples per label set (the labels
    minus `le`): {labels: {"buckets": [(le, cumulative_count), ...],
    "sum": float|None, "count": float|None}}. Bucket order is as
    rendered; `le` is float with +Inf parsed to math.inf. The merge
    and lint layers both consume this shape."""
    out: dict[tuple[tuple[str, str], ...], dict] = {}
    for s in family.samples:
        labels = s.label_dict()
        le = labels.pop("le", None)
        key = tuple(sorted(labels.items()))
        ent = out.setdefault(key, {"buckets": [], "sum": None,
                                   "count": None})
        if s.name.endswith("_bucket"):
            ent["buckets"].append(
                (math.inf if le == "+Inf" else float(le), s.value))
        elif s.name.endswith("_sum"):
            ent["sum"] = s.value
        elif s.name.endswith("_count"):
            ent["count"] = s.value
    return out
