"""Shell verbs for the tiered-storage lifecycle plane (lifecycle/).

`lifecycle.status` is read-only: the policy + recent transitions from
the master's /debug/lifecycle, plus a live tier census from every
volume server's heat report. `lifecycle.apply` plans and (unless
-dryRun) executes one sweep — the same code path the master's
maintenance cron drives when `-lifecyclePolicy` is configured, exposed
so an operator can run or rehearse a sweep on demand.

The port's copy of seaweedfs_tpu/shell/lifecycle_commands.py.
"""

from __future__ import annotations

import argparse

from .commands import CommandEnv, command


@command("lifecycle.status",
         "[-url http://master:port]: show lifecycle policy, tier census "
         "and recent transitions")
def cmd_lifecycle_status(env: CommandEnv, args):
    from ..lifecycle import fetch_heat
    p = argparse.ArgumentParser(prog="lifecycle.status")
    p.add_argument("-url", default="",
                   help="master HTTP base URL; also prints the master's "
                        "configured policy and recent transition events")
    opt = p.parse_args(args)

    if opt.url:
        from .health_util import fetch_master_json
        try:
            doc = fetch_master_json(opt.url, "/debug/lifecycle", timeout=5)
        except Exception as e:  # noqa: BLE001
            doc = {}
            env.println(f"master lifecycle fetch failed: {e}")
        pol = doc.get("policy")
        if pol:
            env.println(f"policy ({doc.get('source') or 'inline'}): "
                        f"{len(pol.get('rules', []))} rules")
            for rule in pol.get("rules", []):
                env.println(f"  {rule}")
        else:
            env.println("no lifecycle policy configured on the master")
        recent = doc.get("recent", {}).get("events", [])
        if recent:
            env.println(f"recent transitions ({len(recent)}):")
            for e in recent[-10:]:
                a = e.get("attrs", {})
                env.println(
                    f"  {e.get('type')} vid={a.get('vid')} "
                    f"{a.get('from', '?')}->{a.get('to', '?')} "
                    f"{a.get('bytes_moved', 0)} bytes")

    servers = env.collect_volume_servers()
    heat = fetch_heat(env, servers)
    hot = ec_local = offloaded = reaps = 0
    hot_bytes = 0
    for sid, rep in sorted(heat.items()):
        vols = rep.get("volumes", {})
        ecs = rep.get("ec_volumes", {})
        hot += len(vols)
        hot_bytes += sum(v.get("size", 0) for v in vols.values())
        for e in ecs.values():
            if e.get("remote_shards"):
                offloaded += 1
            if e.get("local_shards"):
                ec_local += 1
            if e.get("destroy_time"):
                reaps += 1
        env.println(
            f"  {sid}: {len(vols)} hot volumes, {len(ecs)} ec volumes "
            f"({sum(1 for e in ecs.values() if e.get('remote_shards'))} "
            "with offloaded shards)")
    missing = len(servers) - len(heat)
    env.println(f"tier census: {hot} hot volume copies "
                f"({hot_bytes >> 20} MB), {ec_local} ec holdings local, "
                f"{offloaded} holdings offloaded, {reaps} with a "
                "DestroyTime pending"
                + (f"  ({missing} servers unreachable)" if missing else ""))


@command("lifecycle.apply",
         "-policy FILE [-dryRun] [-maxBytesMB N] [-maxTransitions N] "
         "[-maxConcurrent N]: plan and execute one lifecycle sweep "
         "(hot→EC→remote, promote-on-heat; -dryRun plans with zero "
         "mutating RPCs)", needs_lock=True)
def cmd_lifecycle_apply(env: CommandEnv, args):
    from ..lifecycle import (LifecycleExecutor, build_lifecycle_plan,
                             parse_policy)
    p = argparse.ArgumentParser(prog="lifecycle.apply")
    p.add_argument("-policy", required=True,
                   help="JSON policy file (lifecycle/policy.py doc shape)")
    p.add_argument("-dryRun", action="store_true")
    p.add_argument("-maxBytesMB", type=int, default=10240,
                   help="byte budget per sweep (tier moves admitted "
                        "cheapest-first up to this many MB)")
    p.add_argument("-maxTransitions", type=int, default=16)
    p.add_argument("-maxConcurrent", type=int, default=2)
    opt = p.parse_args(args)
    policy = parse_policy(opt.policy)
    plan = build_lifecycle_plan(env, policy)
    plan.render(env.println)
    # ONE executor per CommandEnv: failure cooldowns and per-volume
    # locks persist across the cron's sweeps (and an operator's shell
    # session), like the repair executor on the AdminCron
    ex = env.option.get("_lifecycle_exec")
    if ex is None or not isinstance(ex, LifecycleExecutor):
        ex = env.option["_lifecycle_exec"] = LifecycleExecutor(env)
    ex.max_concurrent = max(1, opt.maxConcurrent)
    ex.max_transitions = max(1, opt.maxTransitions)
    ex.max_bytes = max(1, opt.maxBytesMB) << 20
    res = ex.execute(plan, dry_run=opt.dryRun)
    if opt.dryRun:
        env.println(f"dry run: {len(plan.transitions)} transitions "
                    "planned, nothing executed")
    else:
        env.println(f"lifecycle: {len(res['done'])} done, "
                    f"{len(res['failed'])} failed, "
                    f"{len(res['skipped'])} skipped; "
                    f"{sum(d['bytes_moved'] for d in res['done'])} "
                    "bytes moved")
    return res
