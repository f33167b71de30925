"""Shell verbs for the fleet telemetry & SLO plane (telemetry/).

`cluster.top` is the operator's htop: one fetch of the leader's
/cluster/telemetry snapshot rendered as SLO burn state, cluster-merged
latency percentiles, per-stage hot-path breakdown and heavy hitters.
`-watch N` repaints every N seconds; `-failOn burning` turns it into a
CI/cron tripwire that exits non-zero while any SLO burns (the telemetry
mirror of `cluster.check -failOn`).

`cluster.profile` is its flamegraph sibling: the same snapshot fetched
with ?profile=1, rendering the fleet-merged continuous-profiler view —
per-node sample counts, thread-class CPU/wait attribution, and the top
merged folded stacks (`-raw` emits collapsed-flamegraph lines for
piping into flamegraph.pl / speedscope).

The port's copy of seaweedfs_tpu/shell/telemetry_commands.py.
"""

from __future__ import annotations

import argparse
import time

from .commands import CommandEnv, command


def _fmt_s(v) -> str:
    """Seconds -> human unit (stage times sit in the us..ms range)."""
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.1f}ms"
    return f"{v * 1e6:.0f}us"


def _fmt_n(v) -> str:
    v = float(v)
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if v >= div:
            return f"{v / div:.1f}{unit}"
    return f"{v:.0f}"


def _render(env: CommandEnv, snap: dict, now: float) -> list[str]:
    """Print one snapshot; returns the names of burning SLOs."""
    targets = snap.get("targets", [])
    live = [t for t in targets if not t.get("stale")]
    env.println(f"cluster.top — {snap.get('node', '?')} "
                f"({'leader' if snap.get('leader') else 'FOLLOWER'}), "
                f"cycle {snap.get('cycles', 0)}, "
                f"every {snap.get('interval_s', '?')}s")
    # group by DC when the fleet spans more than one — the geo
    # operator's view: which SITE is live/stale, then which node
    by_dc: dict[str, list] = {}
    for t in targets:
        by_dc.setdefault(t.get("dc") or "", []).append(t)
    multi_dc = len([d for d in by_dc if d]) > 1
    if multi_dc:
        site = ", ".join(
            f"{dc or '-'}:{sum(1 for t in ts if not t.get('stale'))}"
            f"/{len(ts)}" for dc, ts in sorted(by_dc.items()))
        env.println(f"targets: {len(live)}/{len(targets)} live ({site})")
    else:
        env.println(f"targets: {len(live)}/{len(targets)} live")
    for t in targets:
        ago = (f"{now - t['last_scrape_ts']:.1f}s ago"
               if t.get("last_scrape_ts") else "never")
        flag = ("STALE" if t.get("stale") else
                f"fails={t['consecutive_failures']}"
                if t.get("consecutive_failures") else "ok")
        where = f" dc={t['dc']}" if multi_dc and t.get("dc") else ""
        env.println(f"  {t.get('node', '?'):<32} {flag:<10} scraped "
                    f"{ago}{where}")

    burning: list[str] = []
    status = (snap.get("slo") or {}).get("status") or []
    if status:
        env.println("SLOs:")
    for s in status:
        desc = (f"avail>={s.get('objective', 0) * 100:g}%"
                if s.get("kind") == "availability" else
                f"p{s.get('objective', 0) * 100:g}<="
                f"{_fmt_s(s.get('threshold_s'))}")
        if s.get("burning"):
            burning.append(s["name"])
        env.println(f"  {s.get('name', '?'):<24} "
                    f"{'BURNING' if s.get('burning') else 'ok':<8} "
                    f"worst_burn={s.get('worst_burn', 0):.2f}  ({desc})")

    merged = snap.get("merged") or {}
    if merged:
        env.println("cluster latency (merged across nodes):")
    for family, rows in merged.items():
        short = family.replace("SeaweedFS_", "").replace("_seconds", "")
        for label, st in rows.items():
            if not st.get("count"):
                continue
            env.println(
                f"  {short:<28} {label:<34} n={_fmt_n(st['count']):>7} "
                f"mean={_fmt_s(st.get('mean')):>8} "
                f"p50={_fmt_s(st.get('p50')):>8} "
                f"p90={_fmt_s(st.get('p90')):>8} "
                f"p99={_fmt_s(st.get('p99')):>8}")

    top = snap.get("top") or {}
    reqs, byts = top.get("requests") or {}, top.get("bytes") or {}
    if any(reqs.values()) or any(byts.values()):
        env.println("hot keys (space-saving top-k; count-error <= err):")
    for kind in ("volume", "tenant", "method"):
        by_key = {i["key"]: i for i in byts.get(kind, ())}
        row = ", ".join(
            f"{i['key']}:{_fmt_n(i['count'])}req"
            + (f"/{_fmt_n(by_key[i['key']]['count'])}B"
               if i["key"] in by_key else "")
            + (f"(err<={_fmt_n(i['error'])})" if i.get("error") else "")
            for i in reqs.get(kind, ()))
        if row:
            env.println(f"  {kind:<8} {row}")
    return burning


@command("cluster.top",
         "-url http://master:port [-watch N] [-failOn burning]: live "
         "fleet snapshot — SLO burn, merged percentiles, hot keys")
def cmd_cluster_top(env: CommandEnv, args):
    """cluster.top -url http://master:port [-top 10] [-watch seconds]
    [-failOn burning] [-noTrigger]

    Fetches the leader-resident /cluster/telemetry snapshot (following
    421 leader redirects from followers) and renders it. Each fetch
    triggers a fresh scrape/evaluate cycle by default so the paint is
    current, not one interval old; -noTrigger reads whatever the last
    cycle collected (cheaper on large fleets). Raises (non-zero exit in
    `-c` scripts) when -failOn burning and any SLO is burning."""
    from .health_util import fetch_master_json

    p = argparse.ArgumentParser(prog="cluster.top")
    p.add_argument("-url", required=True,
                   help="any master's HTTP base URL (followers redirect)")
    p.add_argument("-top", type=int, default=10,
                   help="heavy-hitter rows per dimension")
    p.add_argument("-watch", type=float, default=0,
                   help="repaint every N seconds until interrupted")
    p.add_argument("-failOn", default="never", choices=["never", "burning"])
    p.add_argument("-noTrigger", action="store_true",
                   help="serve the last collected cycle instead of "
                        "forcing a fresh fleet scrape")
    opt = p.parse_args(args)

    params = {"top": str(opt.top)}
    if not opt.noTrigger:
        params["trigger"] = "1"
    while True:
        snap = fetch_master_json(opt.url, "/cluster/telemetry",
                                 params=params)
        burning = _render(env, snap, time.time())
        if opt.failOn == "burning" and burning:
            # RuntimeError, not SystemExit — same convention as
            # cluster.check: the admin cron survives failing scripts
            raise RuntimeError(f"SLOs burning: {', '.join(burning)}")
        if not opt.watch:
            return
        try:
            time.sleep(opt.watch)
        except KeyboardInterrupt:
            return
        env.println("")


@command("cluster.profile",
         "-url http://master:port [-top N] [-raw]: fleet-merged "
         "continuous-profiler flamegraph — thread classes, hot stacks")
def cmd_cluster_profile(env: CommandEnv, args):
    """cluster.profile -url http://master:port [-top 20] [-raw]
    [-noTrigger]

    Fetches /cluster/telemetry?profile=1 from the leader (421-following)
    and renders the fleet-merged continuous-profiler summary: per-node
    sample counts, on-CPU vs waiting attribution per thread class, and
    the hottest merged folded stacks. Per-class totals are exact — the
    collector rolls truncated stacks into `~other` buckets rather than
    dropping them — so node counts always sum to the cluster count.
    -raw prints collapsed `stack count` lines instead of the table
    (pipe into flamegraph.pl or paste into speedscope)."""
    from .health_util import fetch_master_json

    p = argparse.ArgumentParser(prog="cluster.profile")
    p.add_argument("-url", required=True,
                   help="any master's HTTP base URL (followers redirect)")
    p.add_argument("-top", type=int, default=20,
                   help="merged stack rows to show")
    p.add_argument("-raw", action="store_true",
                   help="emit collapsed-flamegraph lines, no table")
    p.add_argument("-noTrigger", action="store_true",
                   help="serve the last collected cycle instead of "
                        "forcing a fresh fleet scrape")
    opt = p.parse_args(args)

    params = {"profile": "1"}
    if not opt.noTrigger:
        params["trigger"] = "1"
    snap = fetch_master_json(opt.url, "/cluster/telemetry", params=params)
    prof = snap.get("profile") or {}
    nodes = prof.get("nodes") or {}
    stacks = prof.get("stacks") or []

    if opt.raw:
        for it in stacks:
            env.println(f"{it['stack']} {it['count']}")
        return

    env.println(f"cluster.profile — {snap.get('node', '?')} "
                f"({'leader' if snap.get('leader') else 'FOLLOWER'}), "
                f"{len(nodes)} node(s), "
                f"{_fmt_n(prof.get('samples', 0))} samples")
    for node, st in sorted(nodes.items()):
        hz = st.get("hz")
        env.println(f"  {node:<32} samples={_fmt_n(st.get('samples', 0)):>7} "
                    f"hz={hz if hz is not None else '?'}")

    classes = prof.get("classes") or {}
    if classes:
        env.println("thread classes (on-CPU vs waiting):")
    total = sum(c.get("on_cpu", 0) + c.get("waiting", 0)
                for c in classes.values()) or 1
    for cls, st in sorted(classes.items(),
                          key=lambda kv: -(kv[1].get("on_cpu", 0)
                                           + kv[1].get("waiting", 0))):
        on, wa = st.get("on_cpu", 0), st.get("waiting", 0)
        env.println(f"  {cls:<14} on_cpu={_fmt_n(on):>7} "
                    f"waiting={_fmt_n(wa):>7} "
                    f"share={100.0 * (on + wa) / total:5.1f}%")

    if stacks:
        env.println(f"top merged stacks (of {len(stacks)}):")
    for it in stacks[:max(0, opt.top)]:
        stack = it.get("stack", "")
        if len(stack) > 110:
            stack = stack[:107] + "..."
        env.println(f"  {_fmt_n(it.get('count', 0)):>7}  {stack}")
