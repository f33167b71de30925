"""Failpoints: deterministic fault injection at named sites (the port's
copy of the JAX package's utils/failpoints.py).

SURVEY.md §5 lists fault injection as ABSENT in the reference — this
facility exceeds it. Production code is sprinkled with cheap guarded
hooks (`failpoints.check("volume.write.torn")`); with no configuration
the hot-path cost is one dict lookup on an (almost always) empty dict.
Tests and operators arm sites by name:

    failpoints.configure("volume.heartbeat", "error")          # raise
    failpoints.configure("store.read", "delay:0.2")            # sleep
    failpoints.configure("volume.write.torn", "torn:10")       # cut bytes
    failpoints.configure("replicate.peer", "times:2:error")    # transient

    with failpoints.inject("ec.shard.read", "error"):          # scoped
        ...

Specs compose as  [times:K:][pct:P:]kind[:arg] :
    off            disarm
    error[:msg]    raise FailpointError(msg) at the site
    delay:S        sleep S seconds, then continue
    torn:N         (write sites) persist only the first N bytes
    corrupt:N      (data sites) flip N random bits in the payload
    pct:P:...      probabilistic: fire the wrapped kind with P% chance
    times:K:...    fire K times, then auto-disarm — transient faults

`pct` models flaky links (every check rolls the dice); `times` models a
node that dies and comes back. They compose: `times:3:pct:50:error` is a
coin-flip fault that disarms after its third actual firing. The dice are
a module RNG seeded via SWTPU_FAILPOINT_SEED (or seed()) so a chaos
schedule replays byte-identically from its printed seed.

Environment: SWTPU_FAILPOINTS="name=spec;name2=spec2" arms sites at
process start (read lazily on first check), so subprocess daemons
(volume servers, mounts) can be faulted from the outside.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager

from .log import logger

log = logger("failpoints")


class FailpointError(RuntimeError):
    """The injected failure (so tests can distinguish it from real bugs)."""


class _Armed:
    __slots__ = ("kind", "arg", "remaining", "pct")

    def __init__(self, kind: str, arg: str, remaining: int = -1,
                 pct: float = 100.0):
        self.kind = kind
        self.arg = arg
        self.remaining = remaining  # -1 = unlimited
        self.pct = pct  # firing probability, 100 = always


_armed: dict[str, _Armed] = {}
_lock = threading.Lock()
_env_loaded = False
_fired: dict[str, int] = {}  # per-site trigger count (observability)

# one seedable RNG for pct rolls AND corrupt bit positions: a chaos run
# that prints its seed replays the exact same fault schedule
_rng = random.Random(os.environ.get("SWTPU_FAILPOINT_SEED") or None)


def seed(n: int) -> None:
    """Re-seed the fault dice (chaos harness reproducibility)."""
    _rng.seed(n)


def _parse(spec: str) -> _Armed | None:
    spec = spec.strip()
    if not spec or spec == "off":
        return None
    remaining = -1
    if spec.startswith("times:"):
        _, k, spec = spec.split(":", 2)
        remaining = int(k)
    pct = 100.0
    if spec.startswith("pct:"):
        _, p, spec = spec.split(":", 2)
        pct = float(p)
        if not 0.0 <= pct <= 100.0:
            raise ValueError(f"pct must be in [0,100], got {p}")
    kind, _, arg = spec.partition(":")
    if kind not in ("error", "delay", "torn", "corrupt"):
        raise ValueError(f"unknown failpoint kind {kind!r}")
    # validate numeric args at CONFIGURE time: a bad arg must be a 400 at
    # the debug endpoint, not a ValueError inside a production read path
    if kind == "delay" and arg:
        float(arg)
    if kind in ("torn", "corrupt"):
        int(arg or 0)
    return _Armed(kind, arg, remaining, pct)


def configure(name: str, spec: str) -> None:
    armed = _parse(spec)
    with _lock:
        if armed is None:
            _armed.pop(name, None)
        else:
            _armed[name] = armed
    log.info("failpoint %s = %s", name, spec or "off")


def clear(name: str) -> None:
    with _lock:
        _armed.pop(name, None)


def clear_all() -> None:
    with _lock:
        _armed.clear()
        _fired.clear()


def fired(name: str) -> int:
    """How many times the site actually triggered."""
    return _fired.get(name, 0)


def fired_counts() -> dict[str, int]:
    """All sites' trigger counts (debug endpoint)."""
    with _lock:
        return dict(_fired)


_env_lock = threading.Lock()


def _load_env() -> None:
    global _env_loaded
    with _env_lock:
        if _env_loaded:
            return
        raw = os.environ.get("SWTPU_FAILPOINTS", "")
        for pair in raw.split(";"):
            if "=" in pair:
                name, _, spec = pair.partition("=")
                try:
                    configure(name.strip(), spec)
                except ValueError as e:
                    log.warning("SWTPU_FAILPOINTS %r: %s", pair, e)
        # flip the flag only AFTER arming: a concurrent first check must
        # not fast-path past env-armed sites
        _env_loaded = True


def _take(name: str) -> _Armed | None:
    if not _env_loaded:
        _load_env()
    with _lock:
        armed = _armed.get(name)
        if armed is None:
            return None
        if armed.remaining == 0:
            _armed.pop(name, None)
            return None
        # pct gates BEFORE the times counter: `times:K:pct:P:...` means
        # K actual firings, however many dice rolls that takes
        if armed.pct < 100.0 and _rng.random() * 100.0 >= armed.pct:
            return None
        if armed.remaining > 0:
            armed.remaining -= 1
            if armed.remaining == 0:
                _armed.pop(name, None)
        _fired[name] = _fired.get(name, 0) + 1
    return armed


def check(name: str) -> None:
    """The standard hook: raises or delays when the site is armed."""
    if not _armed and _env_loaded:  # fast path
        return
    armed = _take(name)
    if armed is None:
        return
    if armed.kind == "delay":
        time.sleep(float(armed.arg or 0.1))
    else:
        # 'error' — and 'torn'/'corrupt' armed at a check-only site also
        # raise rather than silently counting a fault that never injected
        raise FailpointError(armed.arg or f"failpoint {name}")


def _bit_flip(data: bytes, nbits: int) -> bytes:
    buf = bytearray(data)
    for _ in range(nbits):
        i = _rng.randrange(len(buf))
        buf[i] ^= 1 << _rng.randrange(8)
    return bytes(buf)


def data_fault(name: str, data: bytes) -> bytes:
    """Data-site hook: returns the (possibly cut or bit-flipped) bytes.
    Write sites use it to model torn persists; read sites to model disk
    or wire corruption that a CRC check downstream must catch."""
    if not _armed and _env_loaded:
        return data
    armed = _take(name)
    if armed is None:
        return data
    if armed.kind == "torn":
        n = int(armed.arg or 0)
        log.info("failpoint %s: tearing write %d -> %d bytes",
                 name, len(data), n)
        return data[:n]
    if armed.kind == "corrupt":
        if not data:
            return data
        n = int(armed.arg or 1)
        log.info("failpoint %s: flipping %d bit(s) in %d bytes",
                 name, n, len(data))
        return _bit_flip(data, n)
    if armed.kind == "delay":
        time.sleep(float(armed.arg or 0.1))
        return data
    raise FailpointError(armed.arg or f"failpoint {name}")


# site-intent aliases for the shared data hook: `torn` at write sites,
# `corrupt` at read sites — both accept any data-mutating kind
torn = data_fault
corrupt = data_fault


@contextmanager
def inject(name: str, spec: str):
    """Scoped arm; restores whatever was armed before (an env- or
    operator-armed site survives a nested scoped injection)."""
    with _lock:
        prev = _armed.get(name)
    configure(name, spec)
    try:
        yield
    finally:
        with _lock:
            if prev is None:
                _armed.pop(name, None)
            else:
                _armed[name] = prev


def active() -> dict[str, str]:
    """Armed sites (for /debug introspection)."""
    with _lock:
        out = {}
        for n, a in _armed.items():
            spec = f"{a.kind}:{a.arg}"
            if a.pct < 100.0:
                spec = f"pct:{a.pct:g}:{spec}"
            if a.remaining >= 0:
                spec = f"times:{a.remaining}:{spec}"
            out[n] = spec
        return out
