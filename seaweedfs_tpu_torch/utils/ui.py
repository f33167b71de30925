"""Minimal server-rendered status pages.

Reference: every daemon serves a human-readable status UI
(weed/server/master_ui, volume_server_ui, filer_ui — Go templates).
Same idea here with one tiny renderer and zero dependencies: a header,
key/value facts, and optional tables.

The port's copy of seaweedfs_tpu/utils/ui.py.
"""

from __future__ import annotations

import html

_STYLE = """
body{font-family:system-ui,sans-serif;margin:2em;color:#222}
h1{font-size:1.3em;border-bottom:2px solid #467;padding-bottom:.3em}
h2{font-size:1.05em;margin-top:1.4em}
table{border-collapse:collapse;margin:.5em 0}
td,th{border:1px solid #ccd;padding:.25em .7em;text-align:left;
font-size:.92em}
th{background:#eef2f7}
.kv td:first-child{font-weight:600;background:#f7f9fb}
footer{margin-top:2em;color:#888;font-size:.8em}
"""


def esc(v) -> str:
    return html.escape(str(v))


def render_page(title: str, facts: "dict[str, object]",
                tables: "list[tuple[str, list[str], list[list]]]" = ()
                ) -> str:
    """facts -> key/value table; tables -> (heading, columns, rows)."""
    parts = [f"<!doctype html><html><head><meta charset='utf-8'>"
             f"<title>{esc(title)}</title><style>{_STYLE}</style></head>"
             f"<body><h1>{esc(title)}</h1>"]
    if facts:
        parts.append("<table class='kv'>")
        for k, v in facts.items():
            parts.append(f"<tr><td>{esc(k)}</td><td>{esc(v)}</td></tr>")
        parts.append("</table>")
    for heading, cols, rows in tables or ():
        parts.append(f"<h2>{esc(heading)}</h2><table><tr>")
        parts.extend(f"<th>{esc(c)}</th>" for c in cols)
        parts.append("</tr>")
        for row in rows:
            parts.append("<tr>" + "".join(
                f"<td>{esc(c)}</td>" for c in row) + "</tr>")
        parts.append("</table>")
    parts.append("<footer>seaweedfs_tpu</footer></body></html>")
    return "".join(parts)
