"""Leveled logging (reference: weed/glog). Thin wrapper over stdlib logging
with glog-style V(n) verbosity gates.

`SWTPU_LOG_JSON=1` switches every record to one JSON object per line
(level, ts, logger, msg, plus trace_id/span_id when a tracing span is
active on the emitting thread/task) without changing the default
human-readable format. `set_json_logging()` toggles it at runtime."""

from __future__ import annotations

import json
import logging
import os
import sys

_VERBOSITY = int(os.environ.get("SWTPU_V", "0"))

_HUMAN_FORMATTER = logging.Formatter(
    "%(levelname).1s%(asctime)s.%(msecs)03d %(name)s: %(message)s",
    datefmt="%m%d %H:%M:%S")


class _JsonFormatter(logging.Formatter):
    """One JSON object per line, machine-shippable, trace-correlated."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "level": record.levelname.lower(),
            "ts": round(record.created, 6),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        try:
            from ..tracing import current_ids
            trace_id, span_id = current_ids()
            if trace_id:
                obj["trace_id"] = trace_id
                obj["span_id"] = span_id
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (logging must never raise)
            pass
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, default=str)


_root = logging.getLogger("swtpu_torch")
if not _root.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(_JsonFormatter()
                          if os.environ.get("SWTPU_LOG_JSON") == "1"
                          else _HUMAN_FORMATTER)
    _root.addHandler(_handler)
    _root.setLevel(logging.INFO)
else:  # re-import after a reload: keep the existing handler
    _handler = _root.handlers[0]


def logger(name: str) -> logging.Logger:
    return _root.getChild(name)


def set_json_logging(enabled: bool) -> None:
    """Runtime toggle of the SWTPU_LOG_JSON behavior."""
    _handler.setFormatter(_JsonFormatter() if enabled else _HUMAN_FORMATTER)


def json_logging_enabled() -> bool:
    return isinstance(_handler.formatter, _JsonFormatter)


def v(level: int) -> bool:
    """glog-style verbosity check: if log.v(2): log...  (weed/glog V(n))."""
    return _VERBOSITY >= level


def set_verbosity(level: int) -> None:
    global _VERBOSITY
    _VERBOSITY = level
