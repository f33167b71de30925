"""TOML configuration tiers (reference util/config.go:37-48); the port's
copy of seaweedfs_tpu/utils/config.py.

`load_config("security")` searches, first hit wins:

    ./security.toml
    ~/.seaweedfs/security.toml
    /usr/local/etc/seaweedfs/security.toml
    /etc/seaweedfs/security.toml

plus an env override SWTPU_CONFIG_DIR prepended to the chain (handy for
tests and containers). Values are plain dicts; `get_dotted` resolves
"jwt.signing.key"-style paths like viper's GetString.
"""

from __future__ import annotations

import os

try:
    import tomllib
except ImportError:  # Python < 3.11: tomli is API-compatible
    try:
        import tomli as tomllib
    except ImportError:  # neither: minimal subset fallback below
        tomllib = None

SEARCH_DIRS = [
    ".",
    os.path.join(os.path.expanduser("~"), ".seaweedfs"),
    "/usr/local/etc/seaweedfs",
    "/etc/seaweedfs",
]


def search_dirs() -> list[str]:
    extra = os.environ.get("SWTPU_CONFIG_DIR")
    return ([extra] if extra else []) + SEARCH_DIRS


def find_config(name: str) -> str | None:
    for d in search_dirs():
        path = os.path.join(d, f"{name}.toml")
        if os.path.isfile(path):
            return path
    return None


def load_config(name: str) -> dict:
    """Parse the first `<name>.toml` on the tier chain ({} if none)."""
    path = find_config(name)
    if path is None:
        return {}
    with open(path, "rb") as f:
        if tomllib is not None:
            return tomllib.load(f)
        return _parse_toml_subset(f.read().decode())


def _parse_toml_subset(text: str) -> dict:
    """Fallback parser for the subset our scaffold templates use
    ([table] / [a.b] headers, `key = value` with strings, numbers,
    booleans, flat arrays, # comments) — tomllib only exists on
    Python >= 3.11 and this container may have neither it nor tomli.
    Anything fancier (multiline strings, inline tables, dates) is out
    of scope; operators on old interpreters get a clear error."""
    import re as _re

    def value_of(raw: str):
        raw = raw.strip()
        if raw.startswith("[") and raw.endswith("]"):
            inner = raw[1:-1].strip()
            if not inner:
                return []
            parts, depth, cur = [], 0, ""
            in_str: str | None = None
            for ch in inner + ",":
                if in_str:
                    if ch == in_str:
                        in_str = None
                    cur += ch
                elif ch in "\"'":
                    in_str = ch
                    cur += ch
                elif ch == "," and depth == 0:
                    parts.append(value_of(cur))
                    cur = ""
                else:
                    depth += ch in "[{"
                    depth -= ch in "]}"
                    cur += ch
            return parts
        if (raw.startswith('"') and raw.endswith('"')) or \
                (raw.startswith("'") and raw.endswith("'")):
            body = raw[1:-1]
            if raw[0] == '"':
                body = body.replace("\\\\", "\x00").replace('\\"', '"') \
                    .replace("\\n", "\n").replace("\\t", "\t") \
                    .replace("\x00", "\\")
            return body
        if raw in ("true", "false"):
            return raw == "true"
        if _re.fullmatch(r"[+-]?\d+", raw):
            return int(raw)
        try:
            return float(raw)
        except ValueError:
            raise ValueError(f"unsupported TOML value {raw!r} "
                             "(install Python>=3.11 or tomli for full TOML)")

    root: dict = {}
    table = root
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        lineno, rawline = i + 1, lines[i]
        i += 1
        # strip comments outside strings
        out, in_str = "", None
        for ch in rawline:
            if in_str:
                if ch == in_str:
                    in_str = None
            elif ch in "\"'":
                in_str = ch
            elif ch == "#":
                break
            out += ch
        line = out.strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            table = root
            for part in line[1:-1].strip().strip('"').split("."):
                table = table.setdefault(part.strip(), {})
            continue
        if "=" not in line:
            raise ValueError(f"toml fallback: can't parse line {lineno}: "
                             f"{line!r}")
        key, _, raw = line.partition("=")
        raw = raw.strip()
        for quotes in ('"""', "'''"):
            if raw.startswith(quotes):
                # basic multiline string: consume until the closing
                # delimiter (scaffold's [master.maintenance] scripts)
                body = raw[len(quotes):]
                while not body.rstrip().endswith(quotes):
                    if i >= len(lines):
                        raise ValueError(
                            f"toml fallback: unterminated {quotes} string "
                            f"starting at line {lineno}")
                    body += "\n" + lines[i]
                    i += 1
                raw = None
                val = body.rstrip()[:-len(quotes)]
                if val.startswith("\n"):
                    val = val[1:]  # TOML trims the newline after '''
                break
        table[key.strip().strip('"')] = (value_of(raw) if raw is not None
                                         else val)
    return root


def get_dotted(conf: dict, key: str, default=None):
    """Resolve 'a.b.c' through nested tables; tolerate flat 'a.b.c' keys
    too (viper accepts both spellings)."""
    if key in conf:
        return conf[key]
    cur = conf
    for part in key.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur
