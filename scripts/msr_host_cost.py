"""Time the host bookkeeping of the msr codec (seaweedfs_tpu_torch/ops/
product_matrix.py) for one repair window at RS(14,2), with its GF matrix
applies stubbed out, so what is left is the numpy work around them:

    python3 scripts/msr_host_cost.py [--width 16384]

A window is ec/repair._msr_window's: 256 layers x `width` bytes (16 KiB at
the 4 MiB REPAIR_WINDOW). Prints the seconds of encode_subsymbols (the
overlay seal's step), repair_decode of shard 5 (the single-loss rebuild's)
and decode_coupled with shards (0, 14) lost (the general rebuild's), each
with the shapes of the applies it asked for, then interval_decode of a
1,100-byte degraded read in `repair` and `general` mode. Runs on the CPU
only; no card needed. The numbers are host times of the machine it runs
on, not device times.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from seaweedfs_tpu_torch.ops.product_matrix import ProductMatrixCoder  # noqa: E402

SHARD = 78 << 20  # RS(14,2) shard of the phase-9 write set at 1 MiB blocks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    pm = ProductMatrixCoder(14, 2, backend="numpy")
    calls = []

    def stub(mat, rows):
        calls.append((tuple(mat.shape), tuple(rows.shape)))
        return np.zeros((mat.shape[0], rows.shape[-1]), np.uint8)
    pm._apply = stub
    g, w = pm.grid, args.width
    rng = np.random.default_rng(args.seed)

    def timed(what, fn) -> None:
        calls.clear()
        t = time.perf_counter()
        fn()
        print(f"{what}: {time.perf_counter() - t:.3f} s; applies {calls}")

    sub = rng.integers(0, 256, (14, g.alpha, w), dtype=np.uint8)
    timed(f"encode_subsymbols [14, {g.alpha}, {w}]",
          lambda: pm.encode_subsymbols(sub))
    c = np.zeros((g.nbar, g.alpha, w), np.uint8)
    planes = g.repair_planes(5)
    for sid in range(pm.n):
        if sid != 5:
            c[sid, planes] = rng.integers(0, 256, (len(planes), w), np.uint8)
    timed("repair_decode of shard 5", lambda: pm.repair_decode(c, 5))
    c = rng.integers(0, 256, (g.nbar, g.alpha, w), dtype=np.uint8)
    used = tuple(i for i in range(pm.n) if i not in (0, 14))
    timed("decode_coupled with (0, 14) lost", lambda: pm.decode_coupled(c, used))
    for mode, f, present in (
            ("repair", 5, tuple(i for i in range(pm.n) if i != 5)),
            ("general", 0, tuple(i for i in range(pm.n) if i not in (0, 14)))):
        plan = pm.interval_plan(present, f, 123456789 % SHARD, 1100, SHARD)
        width = plan.inner[1] - plan.inner[0]
        fetched = {sid: rng.bytes(len(v) * width) for sid, v in plan.fetch.items()}
        calls.clear()
        t = time.perf_counter()
        for _ in range(10):
            pm.interval_decode(plan, fetched)
        print(f"interval_decode {plan.mode} of 1100 B: "
              f"{(time.perf_counter() - t) / 10 * 1e3:.3f} ms, "
              f"{plan.bytes_total()} B fetched, {len(calls) // 10} applies")
    return 0


if __name__ == "__main__":
    sys.exit(main())
