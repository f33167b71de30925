"""One run of one cell: set up, measure for --seconds, check against the
reference, print one JSON line.

    python -m weedbench --workload <cell> --seed <n> --seconds <s> --trace 0|1

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer ones (each server's torch.profiler capture and /metrics around
the window). For the benchmark's own tests: `--rehearse` runs the same
code with `-device cpu` servers, `--scale` cuts the configuration's data,
`--fault` starts the daemons through weedbench/faults.py to see a broken
program come out not correct. The benchmark's runs use none of them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import cluster as cl
from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "seaweedfs_tpu")


@dataclass
class Run:
    """What a kind's set-up, window and check, and the metric readers,
    share."""
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    root: Path
    workdir: str
    env: dict
    fault: str = ""
    cluster: object = None
    t_start: float = 0.0
    t_end: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    scrape_delta: dict = field(default_factory=dict)
    traces: list = field(default_factory=list)
    device_kind: str = ""
    data: dict = field(default_factory=dict)   # the kind's own results
    t0: float = 0.0
    phases: dict = field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Seconds from the process's start to the end of a set-up phase."""
        self.phases[phase] = round(time.monotonic() - self.t0, 3)


def forbidden_modules() -> "list[str]":
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def child_env(root: Path) -> dict:
    """The daemons' environment: the driver's HOME, XDG_CACHE_HOME and
    TMPDIR as given, every build and kernel cache at a fixed path inside
    the checkout, the checkout on the import path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    env["PYTHONUNBUFFERED"] = "1"
    return env


class MemorySampler:
    """Peak of the card's used memory (all processes on it), sampled."""

    def __init__(self, torch, period: float = 0.1):
        self.torch = torch
        self.peak = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, args=(period,),
                                   daemon=True)

    def sample(self) -> None:
        free, total = self.torch.cuda.mem_get_info(0)
        self.peak = max(self.peak, total - free)

    def _loop(self, period: float) -> None:
        while not self._stop.wait(period):
            self.sample()

    def start(self) -> "MemorySampler":
        self.sample()
        self._t.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        self._t.join(5)
        self.sample()
        return self.peak


def _fmt_checks(checks: dict) -> str:
    return "\n".join(f"check {k}: {v['value']} (limit {v['limit']})"
                     for k, v in checks.items())


def main(argv=None, t0: "float | None" = None) -> int:
    t0 = time.monotonic() if t0 is None else t0
    p = argparse.ArgumentParser(prog="weedbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="CPU servers at a cut size (the benchmark's tests)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="share of the configuration's data to build (the "
                        "benchmark's own tests)")
    p.add_argument("--fault", default="",
                   help="start the daemons through weedbench/faults.py")
    a = p.parse_args(argv)
    # gRPC's core logs channel events to standard error, whose last lines
    # are the checks
    os.environ.setdefault("GRPC_VERBOSITY", "ERROR")
    root = spec.HERE.parent
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, a.workload)
    cfg = spec.config(bench, root, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if a.scale != 1.0:
        cfg = dict(cfg, **{k: max(1, int(cfg[k] * a.scale))
                           for k in cfg.get("scale_keys", [])})
    workdir = tempfile.mkdtemp(prefix="weedbench-")
    run = Run(cell, cfg, traffic, a.seed, a.seconds, bool(a.trace),
              "cpu" if a.rehearse else "cuda", root, workdir,
              child_env(root), fault=a.fault, t0=t0)
    kind = spec.kind(traffic["kind"])
    mem = None
    try:
        # the daemons import torch and start CUDA while this process does
        cl.launch(run)
        import torch
        count = int(cell["chips"])
        if a.rehearse:
            run.device_kind, count = "cpu", 1
        elif not torch.cuda.is_available() or \
                torch.cuda.device_count() < count:
            print(f"weedbench: {a.workload} needs {count} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()} (available: "
                  f"{torch.cuda.is_available()})", file=sys.stderr)
            return 3
        else:
            run.device_kind = torch.cuda.get_device_name(0)
            mem = MemorySampler(torch).start()
        run.mark("checked the card")
        kind.prepare(run)
        setup_s = kind.measure(run, t0)
        peak = mem.stop() if mem is not None else 0
        kind.release(run)
        checks = kind.check(run)
        info = dict(kind.info(run), setup_phases=run.phases)
        found = forbidden_modules()
        if found:
            print(f"weedbench: the run loaded {', '.join(found)}",
                  file=sys.stderr)
            return 4
        if run.trace:
            metrics = {}
            for m in spec.per_layer(bench, a.workload):
                value = spec.reader(m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = dict(kind.end_to_end(run), setup_s=setup_s)
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in spec.end_to_end(bench, a.workload)}
        dev = {"platform": "cpu" if a.rehearse else "gpu",
               "kind": run.device_kind, "count": count,
               "memory_peak_bytes": int(peak)}
        result = {"correct": all(v["value"] <= v["limit"]
                                 for v in checks.values()),
                  "attempted": run.attempted, "failed": run.failed,
                  "metrics": metrics, "device": dev}
        if run.trace:
            from . import traces
            dev["busy_s"] = sum(t.busy_s for t in run.traces) / count
            dev["window_s"] = run.window_s
            result["breakdown"] = traces.breakdown(run.traces)
        result["checks"] = checks
    finally:
        if mem is not None:
            mem.stop()
        if run.cluster is not None:
            run.cluster.close()
        shutil.rmtree(workdir, ignore_errors=True)
    for k, v in info.items():
        print(f"info {k}: {v}", file=sys.stderr)
    print(_fmt_checks(checks), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
