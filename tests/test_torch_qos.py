"""The port's QoS plane (seaweedfs_tpu_torch/qos/) against the JAX
package's: the same class plumbing, the same parsed policies and refusals,
and both schedulers driven through the same seeded arrival sequences under
one injected clock — grant order, shed decisions and their Retry-After,
the queued wait, and debug_payload() equal step for step. The seeded
comparison runs the passes by hand, so it excludes the pump's timing: the
port runs the next pass at once after a round-robin deficit stall, where
the reference waits an idle tick; the stall tests at the end hold that.
"""

import dataclasses
import time

import numpy as np
import pytest

from seaweedfs_tpu import qos as ref_qos
from seaweedfs_tpu.qos import policy as ref_policy
from seaweedfs_tpu_torch import qos as port_qos
from seaweedfs_tpu_torch.qos import policy as port_policy

CLASSES = ("interactive", "ingest", "maintenance")


def test_exports_and_constants_match_reference():
    assert sorted(port_qos.__all__) == sorted(ref_qos.__all__)
    for name in ("CLASS_INTERACTIVE", "CLASS_INGEST", "CLASS_MAINTENANCE",
                 "CLASSES", "QOS_HEADER", "OVERFLOW_TENANT"):
        assert getattr(port_qos, name) == getattr(ref_qos, name), name


@pytest.mark.parametrize("default", CLASSES)
def test_class_from_headers_equal(default):
    for tag in ("", "interactive", "ingest", "maintenance", "bogus",
                "INGEST"):
        headers = {port_qos.QOS_HEADER: tag} if tag else {}
        assert port_qos.class_from_headers(headers, default) == \
            ref_qos.class_from_headers(headers, default), (tag, default)
    assert port_qos.class_from_headers(None, default) == \
        ref_qos.class_from_headers(None, default)


def test_tag_and_inject_like_reference():
    for mod in (port_qos, ref_qos):
        assert mod.current_class() == "" and mod.inject({}) == {}
        with mod.tagged(mod.CLASS_MAINTENANCE):
            assert mod.injectable() == "maintenance"
            assert mod.inject({}) == {mod.QOS_HEADER: "maintenance"}
            tok = mod.set_class(mod.CLASS_INGEST)
            assert mod.current_class() == "ingest"
            mod.reset_class(tok)
            assert mod.current_class() == "maintenance"
        assert mod.current_class() == ""


def _policy_doc(rng) -> dict:
    """One seeded policy document over three named tenants."""
    def bucket(scale):
        out = {}
        if rng.random() < 0.7:
            out["rps"] = float(rng.integers(1, 40)) * scale
        if rng.random() < 0.7:
            out["bytes_per_s"] = int(rng.integers(1, 64)) * 1024
        if rng.random() < 0.3:
            out["burst_bytes"] = f"{int(rng.integers(1, 8))}KB"
        if rng.random() < 0.4:
            out["max_inflight"] = int(rng.integers(1, 4))
        return out
    doc = {
        "node": bucket(4) if rng.random() < 0.5 else {},
        "classes": {k: {**bucket(2), "max_wait_s":
                        float(rng.choice([0.2, 0.5, 1.0, 3.0]))}
                    for k in CLASSES if rng.random() < 0.8},
        "default": {**bucket(1), "weight": int(rng.integers(1, 30)),
                    "max_queue": int(rng.integers(2, 10))},
        "tenants": {f"t{i}": {**bucket(1), "weight": int(rng.integers(1, 40)),
                              "max_queue": int(rng.integers(1, 8))}
                    for i in range(3)},
        "max_tenants": int(rng.integers(2, 6)),
        "quantum_bytes": int(rng.choice([512, 4096, 65536])),
    }
    return doc


@pytest.mark.parametrize("seed", range(6))
def test_parse_policy_equal(seed):
    doc = _policy_doc(np.random.default_rng(seed))
    got = dataclasses.asdict(port_policy.parse_policy(doc))
    want = dataclasses.asdict(ref_policy.parse_policy(doc))
    assert got == want
    assert not port_policy.parse_policy(None).enabled
    assert not port_policy.parse_policy({}).enabled


@pytest.mark.parametrize("doc", [
    {"bogus": 1}, {"classes": {"gold": {}}}, {"node": {"rps": -1}},
    {"default": {"weight": 0}}, {"tenants": {"": {}}},
    {"enabled": "yes"}, {"max_tenants": 0}, {"node": {"bytes_per_s": "4XB"}},
    {"classes": {"ingest": {"max_wait_s": True}}}, "not an object"])
def test_policy_refusals_equal(doc):
    errs = []
    for mod in (port_policy, ref_policy):
        with pytest.raises(ValueError) as e:
            mod.parse_policy(doc)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _scheduler(mod, doc, clock, monkeypatch):
    """A scheduler whose pump never starts: the test runs its passes."""
    monkeypatch.setattr(mod.QosScheduler, "_start_pump", lambda self: None)
    return mod.QosScheduler(doc, clock=clock, name="volume-test")


def _arrivals(rng, n=160):
    """(dt, tenant, class, cost) arrivals: bursts and gaps, five tenants
    (past max_tenants the tail shares the overflow tenant)."""
    out = []
    for _ in range(n):
        dt = float(rng.choice([0.0, 0.0, 0.001, 0.01, 0.05, 0.2]))
        tenant = str(rng.choice(["t0", "t1", "t2", "t3", "t4", ""]))
        klass = str(rng.choice(CLASSES))
        cost = int(rng.choice([0, 0, 512, 4096, 20000]))
        out.append((dt, tenant, klass, cost))
    return out


def _drive(mod, doc, arrivals, monkeypatch):
    """The log of one scheduler over `arrivals`: every notification in
    order (fast grants, immediate sheds, pump grants and deadline sheds),
    releases of grants after a hold, and the final debug payload."""
    clock = _Clock()
    sched = _scheduler(mod, doc, clock, monkeypatch)
    log, held = [], []

    def note(i):
        def notify(res):
            if isinstance(res, mod.QosShed):
                log.append(("shed", i, res.reason, res.retry_after_header,
                            round(res.retry_after_s, 9)))
            else:
                log.append(("grant", i, res.tenant, res.klass))
                held.append((clock.t + 0.03, res))
        return notify

    def pump():
        with sched._lock:
            grants, sheds, _ = sched._schedule_locked()
        for w, g in grants:
            w.notify(g)
        for w, s in sheds:
            w.notify(s)

    for i, (dt, tenant, klass, cost) in enumerate(arrivals):
        clock.t += dt
        for due, g in [h for h in held if h[0] <= clock.t]:
            held.remove((due, g))
            g.release()
        sched._submit(tenant, klass, cost, note(i))
        pump()
        if i % 20 == 19:
            post = sched.debug_payload()
            log.append(("state", i, post["totals"], len(post["tenants"])))
    for _ in range(40):  # drain: time passes, queued work is served or shed
        clock.t += 0.1
        for _due, g in list(held):
            g.release()
        held.clear()
        pump()
    payload = sched.debug_payload()
    sched.close()
    return log, payload


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_equal_on_seeded_arrivals(seed, monkeypatch):
    rng = np.random.default_rng(100 + seed)
    doc = _policy_doc(rng)
    arrivals = _arrivals(rng)
    got = _drive(port_qos, doc, arrivals, monkeypatch)
    want = _drive(ref_qos, doc, arrivals, monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    kinds = {e[0] for e in got[0]}
    assert {"grant", "shed"} <= kinds


def test_shed_retry_after_equal(monkeypatch):
    """A tiny ingest bucket: the second write sheds with the bucket's ETA
    as Retry-After, alike in both packages."""
    doc = {"tenants": {"tiny": {"rps": 0.01, "burst": 1}}}
    for mod in (port_qos, ref_qos):
        clock = _Clock()
        sched = _scheduler(mod, doc, clock, monkeypatch)
        sched.admit_sync("tiny", mod.CLASS_INGEST).release()
        clock.t += 0.5
        with pytest.raises(mod.QosShed) as e:
            sched.admit_sync("tiny", mod.CLASS_INGEST)
        assert (e.value.reason, e.value.retry_after_header) == \
            ("rate limited", "100")
        sched.close()


def test_disabled_policy_costs_nothing():
    """No policy, an empty one or enabled:false: every admission is the
    shared inert grant, and no pump thread starts."""
    for doc in (None, {}, {"enabled": False, "default": {"rps": 1}}):
        sched = port_qos.QosScheduler(doc)
        g = sched.admit_sync("x", port_qos.CLASS_INGEST, cost=1 << 30)
        assert g is sched.admit_sync("y", port_qos.CLASS_MAINTENANCE)
        g.charge(10)
        g.release()
        assert sched._pump is None and not sched.enabled
        assert sched.debug_payload()["totals"] == {"admitted": 0, "shed": 0}
        sched.close()


def test_maintenance_yields_to_queued_foreground(monkeypatch):
    """A shared class bucket run dry: queued interactive work is served
    before queued maintenance until the starvation grace, in both."""
    doc = {"node": {"rps": 1, "burst": 1},
           "classes": {"interactive": {"max_wait_s": 5.0},
                       "maintenance": {"max_wait_s": 10.0}}}
    orders = []
    for mod in (port_qos, ref_qos):
        clock = _Clock()
        sched = _scheduler(mod, doc, clock, monkeypatch)
        order = []
        sched.admit_sync("a", mod.CLASS_INGEST).release()  # drains the node
        sched._submit("m", mod.CLASS_MAINTENANCE, 0,
                      lambda r: order.append(("m", type(r).__name__)))
        sched._submit("i", mod.CLASS_INTERACTIVE, 0,
                      lambda r: order.append(("i", type(r).__name__)))
        for _ in range(3):
            clock.t += 1.0
            with sched._lock:
                grants, sheds, _ = sched._schedule_locked()
            for w, g in grants:
                w.notify(g)
                g.release()
            for w, shed in sheds:
                w.notify(shed)
        orders.append(order)
        sched.close()
    assert orders[0] == orders[1] == [("i", "Grant"), ("m", "Grant")]


@pytest.mark.parametrize("cost", [32 << 20, 4 << 20],
                         ids=["rebuild-read-32MiB", "geo-sync-write-4MiB"])
def test_deficit_stall_is_granted_within_a_tick(cost):
    """A lone maintenance tenant's queued head costing many quanta under
    the default 64 KiB quantum, once its in-flight slot frees: the
    reference credits one quantum an idle tick (0.5 s), so it is still
    waiting after 1.5 s (a 32 MiB read ~4 min); the port's pump runs the
    passes back to back and grants within one tick."""
    doc = {"tenants": {"geo": {"max_inflight": 1}},
           "classes": {"maintenance": {"max_wait_s": 600.0}}}
    waited = {}
    for name, mod in (("port", port_qos), ("jax", ref_qos)):
        sched = mod.QosScheduler(doc, name="stall-test")
        try:
            first = sched.admit_sync("geo", mod.CLASS_MAINTENANCE)
            got = []
            sched._submit("geo", mod.CLASS_MAINTENANCE, cost,
                          lambda r: got.append((time.monotonic(), r)))
            assert not got  # queued behind the in-flight slot
            t0 = time.monotonic()
            first.release()
            deadline = t0 + (1.5 if name == "jax" else 5.0)
            while not got and time.monotonic() < deadline:
                time.sleep(0.01)
            waited[name] = got[0][0] - t0 if got else None
            if got:
                assert isinstance(got[0][1], mod.Grant)
                got[0][1].release()
        finally:
            sched.close()
    assert waited["jax"] is None
    assert waited["port"] is not None and waited["port"] < 0.5
