"""Free localhost ports below the kernel's ephemeral range (copied from
the repository's chip_smoke.py `_port_range` / `_free_low_port`): no
outgoing connection's source port can take one before its server,
started later in another process, binds it. On the card's machines the
ephemeral range starts at 16,000."""

from __future__ import annotations

import os
import random
import socket

_HANDED: "set[int]" = set()


def _port_range() -> "tuple[int, int]":
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    lo = 10000 if low - 10000 > 11000 else 1024
    hi = min(low - 10000, lo + 10000)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    n = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if worker.startswith("gw") and n > 1:
        k, span = int(worker[2:]) % n, (hi - lo) // n
        lo, hi = lo + k * span, lo + (k + 1) * span
    return lo, hi


def free_port() -> int:
    """A free port never handed out before in this process."""
    lo, hi = _port_range()
    rng = random.Random()
    for _ in range(500 if hi > lo + 100 else 0):
        port = rng.randrange(lo, hi)
        if port in _HANDED:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        _HANDED.add(port)
        return port
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _HANDED:
            _HANDED.add(port)
            return port
    raise RuntimeError("no free port")
