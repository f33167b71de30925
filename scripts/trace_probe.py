"""Which K1 launches a torch.profiler capture holds, with and without the
capture's warm-up kernels, and by the launching thread:

    python3 scripts/trace_probe.py [--launches 64] [--smoke-phases 2,...,15]

Each case starts one capture through utils/profiling.start_device_trace
from another thread, as the volume server's debug route does: with its
warm-up kernels (TRACE_WARMUP_KERNELS), or with none, or with none and a
second's wait before the first launch; makes `--launches` K1 launches at one
stripe ([B, 10, 1096], B = 1 + the launch's index, so the kernel's grid
names the launch), each waited for before the next as a degraded read
waits for its result, in that thread or on a pool thread as the server's
`ec-read` pool makes them; stops the capture and reads the Chrome trace
back. It prints, per case, how many launches the trace holds and which
indices are missing. `--smoke-phases` first runs those phases of
chip_smoke.py in this process, so the captures are made in a process that
has run that much work on the card. Needs the card.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from seaweedfs_tpu_torch.ops import gf8, rs_cuda  # noqa: E402
from seaweedfs_tpu_torch.utils import profiling  # noqa: E402

WIDTH = 1096


def _launch(mat, data, i):
    out = rs_cuda.gf_apply(mat, data[: i + 1].contiguous(), entry="probe")
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return out


def _captured(path: str) -> "list[int]":
    with open(path) as f:
        tev = json.load(f).get("traceEvents", [])
    os.unlink(path)
    got = []
    for e in tev:
        if e.get("ph") == "X" and e.get("cat") == "kernel" and \
                "rs_gf_apply" in e.get("name", ""):
            grid = e.get("args", {}).get("grid", [0, 0, 0])
            got.append(int(grid[1]) - 1)
    return sorted(got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=64)
    ap.add_argument("--smoke-phases", default="",
                    help="chip_smoke.py phases to run first, in-process")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_probe: no card", file=sys.stderr)
        return 1
    if opt.smoke_phases:
        import chip_smoke
        t = time.perf_counter()
        if chip_smoke.main(["--phases", opt.smoke_phases]) != 0:
            return 1
        print(f"trace_probe: chip_smoke phases {opt.smoke_phases} ran in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    n = opt.launches
    rng = np.random.default_rng(0)
    mat = gf8.parity_matrix(10, 4)[:1]
    data = torch.from_numpy(rng.integers(0, 256, (n, 10, WIDTH),
                                         dtype=np.uint8)).cuda()
    _launch(mat, data, 0)  # build and load K1 outside every capture
    torch.cuda.synchronize()
    pool = cf.ThreadPoolExecutor(1, thread_name_prefix="ec-read")
    route = cf.ThreadPoolExecutor(1, thread_name_prefix="route")
    warm = profiling.TRACE_WARMUP_KERNELS

    def run(where: str, mode: str) -> dict:
        profiling.TRACE_WARMUP_KERNELS = warm if mode == "warm-up" else 0
        try:
            route.submit(profiling.start_device_trace, cuda=True).result()
        finally:
            profiling.TRACE_WARMUP_KERNELS = warm
        if mode == "wait 1 s":
            time.sleep(1.0)
        t0 = time.perf_counter()
        for i in range(n):
            if where == "pool":
                pool.submit(_launch, mat, data, i).result()
            else:
                _launch(mat, data, i)
        t1 = time.perf_counter()
        got = _captured(route.submit(profiling.stop_device_trace).result())
        return {"launch_thread": where, "start": mode,
                "captured": len(got), "of": n,
                "missing": sorted(set(range(n)) - set(got)),
                "launch_s": round(t1 - t0, 4)}

    rows = []
    for rep in range(2):
        for mode in ("none", "wait 1 s", "warm-up"):
            for where in ("caller", "pool"):
                row = run(where, mode)
                row["rep"] = rep
                rows.append(row)
                print(json.dumps(row), flush=True)
    pool.shutdown()
    route.shutdown()
    print(json.dumps({"torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0),
                      "smoke_phases": opt.smoke_phases,
                      "cases": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
