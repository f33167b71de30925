"""SLO policy + multi-window multi-burn-rate evaluation.

An SLO policy doc (JSON, operator-authored, `-sloPolicy` on the
master) declares objectives over the fleet's merged telemetry:

    {
      "slos": [
        {"name": "read-availability", "kind": "availability",
         "class": "interactive", "tenant": "*", "objective": 0.999},
        {"name": "get-latency", "kind": "latency", "verb": "get",
         "threshold_s": 0.1, "objective": 0.99}
      ],
      "windows": [
        {"name": "fast", "long_s": 3600, "short_s": 300, "burn": 14.0},
        {"name": "slow", "long_s": 21600, "short_s": 1800, "burn": 6.0}
      ]
    }

* availability SLOs score the qos admission stream
  (SeaweedFS_qos_requests_total{tenant,class,outcome}): bad = shed.
  `tenant` / `class` select; "*" (default) pools everything.
* latency SLOs score the merged cross-node request histogram
  (SeaweedFS_volumeServer_request_seconds{type}): bad = the fraction
  of requests slower than threshold_s; `verb` selects the type label.

Burn rate is the SRE-workbook quantity: bad_fraction / error_budget
(error_budget = 1 - objective). Burn 1.0 spends the budget exactly at
the sustainable rate; an alert fires only when BOTH windows of a pair
exceed the pair's burn threshold — the long window proves the burn is
sustained, the short window proves it is still happening — which is
what keeps the alert from flapping on blips and from staying latched
after recovery. Each evaluation publishes
SeaweedFS_slo_burn_rate{slo,window} gauges; state *transitions* emit
`slo.burn` / `slo.ok` ops-journal events (trace-correlated like every
other emit), and burning SLOs surface as DEGRADED items through the
health plane's extra-items hook.

The port's copy of seaweedfs_tpu/telemetry/slo.py.
"""

from __future__ import annotations

import json
import math

DEFAULT_WINDOWS = (
    {"name": "fast", "long_s": 3600.0, "short_s": 300.0, "burn": 14.0},
    {"name": "slow", "long_s": 21600.0, "short_s": 1800.0, "burn": 6.0},
)

QOS_FAMILY = "SeaweedFS_qos_requests_total"
LATENCY_FAMILY = "SeaweedFS_volumeServer_request_seconds"


class Slo:
    __slots__ = ("name", "kind", "objective", "threshold_s",
                 "tenant", "class_", "verb")

    def __init__(self, doc: dict):
        self.name = str(doc.get("name") or "").strip()
        if not self.name:
            raise ValueError("slo missing name")
        self.kind = doc.get("kind", "availability")
        if self.kind not in ("availability", "latency"):
            raise ValueError(f"slo {self.name}: bad kind {self.kind!r}")
        self.objective = float(doc.get("objective", 0.999))
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"slo {self.name}: objective must be in (0,1)")
        self.threshold_s = float(doc.get("threshold_s", 0.0))
        if self.kind == "latency" and self.threshold_s <= 0:
            raise ValueError(f"slo {self.name}: latency needs threshold_s")
        self.tenant = str(doc.get("tenant", "*"))
        self.class_ = str(doc.get("class", "*"))
        self.verb = str(doc.get("verb", "*"))

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective

    def describe(self) -> dict:
        d = {"name": self.name, "kind": self.kind,
             "objective": self.objective}
        if self.kind == "latency":
            d["threshold_s"] = self.threshold_s
            d["verb"] = self.verb
        else:
            d["tenant"] = self.tenant
            d["class"] = self.class_
        return d


class BurnWindow:
    __slots__ = ("name", "long_s", "short_s", "burn")

    def __init__(self, doc: dict):
        self.name = str(doc.get("name") or f"{int(doc['long_s'])}s")
        self.long_s = float(doc["long_s"])
        self.short_s = float(doc.get("short_s", self.long_s / 12.0))
        self.burn = float(doc.get("burn", 1.0))
        if self.short_s <= 0 or self.long_s < self.short_s:
            raise ValueError(f"window {self.name}: need "
                             "0 < short_s <= long_s")

    def describe(self) -> dict:
        return {"name": self.name, "long_s": self.long_s,
                "short_s": self.short_s, "burn": self.burn}


class SloPolicy:
    def __init__(self, slos: "list[Slo]", windows: "list[BurnWindow]"):
        self.slos = slos
        self.windows = windows

    def describe(self) -> dict:
        return {"slos": [s.describe() for s in self.slos],
                "windows": [w.describe() for w in self.windows]}


def parse_slo_policy(doc) -> SloPolicy:
    """Parse a policy dict / JSON string / JSON-file contents."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    if not isinstance(doc, dict):
        raise ValueError("slo policy must be a JSON object")
    slos = [Slo(d) for d in doc.get("slos", ())]
    names = [s.name for s in slos]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate slo names: {names}")
    windows = [BurnWindow(d) for d in (doc.get("windows")
                                       or DEFAULT_WINDOWS)]
    return SloPolicy(slos, windows)


class SloEngine:
    """Evaluates a policy against the collector's ring TSDB, carrying
    the per-SLO burning/ok state machine across evaluations."""

    def __init__(self, policy: SloPolicy, tsdb):
        self.policy = policy
        self.tsdb = tsdb
        self._burning: dict[str, dict] = {}  # slo name -> firing info

    # -- data access ---------------------------------------------------
    def _bad_fraction(self, slo: Slo, window_s: float, now: float
                      ) -> "tuple[float, float]":
        """(bad_fraction, total_events) over the window, pooled across
        non-stale nodes. NaN fraction = no traffic (treated as burn 0:
        an idle cluster isn't violating its SLO)."""
        if slo.kind == "availability":
            flt = {}
            if slo.tenant != "*":
                flt["tenant"] = slo.tenant
            if slo.class_ != "*":
                flt["class"] = slo.class_
            total = self.tsdb.sum_window_delta(QOS_FAMILY, window_s, now,
                                               label_filter=flt or None)
            bad_flt = dict(flt)
            bad_flt["outcome"] = "shed"
            bad = self.tsdb.sum_window_delta(QOS_FAMILY, window_s, now,
                                             label_filter=bad_flt)
            if total <= 0:
                return math.nan, 0.0
            return bad / total, total
        # latency: merged windowed bucket deltas across the fleet
        from .merge import fraction_at_most
        flt = {"type": slo.verb} if slo.verb != "*" else None
        buckets = self.tsdb.histogram_window(LATENCY_FAMILY, window_s,
                                             now, label_filter=flt)
        items = sorted(buckets.items())
        total = items[-1][1] if items else 0.0
        if total <= 0:
            return math.nan, 0.0
        good = fraction_at_most(items, slo.threshold_s)
        return 1.0 - good, total

    # -- evaluation ----------------------------------------------------
    def evaluate(self, now: float) -> dict:
        """One pass: burn rates per (slo, window side), gauge publish,
        state transitions -> slo.burn / slo.ok events. Returns the
        /cluster/telemetry "slo" payload."""
        status = []
        for slo in self.policy.slos:
            windows = {}
            firing_pair = None
            worst_burn = 0.0
            for w in self.policy.windows:
                burns = {}
                for side, span in (("long", w.long_s),
                                   ("short", w.short_s)):
                    frac, total = self._bad_fraction(slo, span, now)
                    burn = 0.0 if math.isnan(frac) \
                        else frac / max(slo.error_budget, 1e-9)
                    burns[side] = {"burn": round(burn, 4),
                                   "window_s": span,
                                   "events": total}
                    worst_burn = max(worst_burn, burn)
                    self._publish(slo.name, f"{w.name}_{side}", burn)
                if burns["long"]["burn"] >= w.burn \
                        and burns["short"]["burn"] >= w.burn:
                    firing_pair = w
                windows[w.name] = {"threshold": w.burn, **burns}
            burning = firing_pair is not None
            self._transition(slo, burning, firing_pair, windows)
            status.append({"name": slo.name, **slo.describe(),
                           "burning": burning,
                           "worst_burn": round(worst_burn, 4),
                           "windows": windows})
        return {"policy": self.policy.describe(), "status": status,
                "burning": sorted(self._burning)}

    def _publish(self, slo_name: str, window: str, burn: float) -> None:
        try:
            from ..stats import SLO_BURN_RATE
            SLO_BURN_RATE.set(slo_name, window, value=burn)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break evaluation)
            pass

    def _transition(self, slo: Slo, burning: bool, pair, windows) -> None:
        from ..ops import events
        was = slo.name in self._burning
        if burning and not was:
            info = {"window": pair.name, "threshold": pair.burn,
                    "long_burn": windows[pair.name]["long"]["burn"],
                    "short_burn": windows[pair.name]["short"]["burn"]}
            self._burning[slo.name] = info
            events.emit("slo.burn", severity=events.WARN, slo=slo.name,
                        kind=slo.kind, objective=slo.objective, **info)
        elif not burning and was:
            info = self._burning.pop(slo.name)
            events.emit("slo.ok", slo=slo.name, kind=slo.kind,
                        recovered_from=info)

    # -- health-plane verdict input -------------------------------------
    def health_items(self) -> list[dict]:
        """Burning SLOs as DEGRADED health items (HealthEngine
        extra-items hook): the cluster can be structurally whole while
        failing its users, and the verdict should say so."""
        out = []
        for name, info in sorted(self._burning.items()):
            out.append({"kind": "slo", "id": name, "severity": "DEGRADED",
                        "window": info.get("window"),
                        "long_burn": info.get("long_burn"),
                        "short_burn": info.get("short_burn"),
                        "threshold": info.get("threshold")})
        return out
