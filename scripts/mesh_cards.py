"""Run the multi-device EC step across n launched ranks, one card each, and
time it: the collectives between ranks that chip_smoke.py's one-card
phase 12 cannot show.

    python3 scripts/mesh_cards.py [--ranks 4] [--device cuda] [--batch 32]
                                  [--width 1048576]

For each mesh of n ranks (2x2 and 1x4 for 4 ranks, the reference's
build_mesh(4, shard_axis=2) and build_mesh(4); 1x1 for one), every rank
(parallel/launch.launch: NCCL, one card per rank) builds the mesh and:

* runs ECPipeline.step at RS(10,4) on the global [batch, 10, width]
  stripe batch (made on the host from --seed; each rank puts its
  data-axis rows on its card) with shards (0, 5, 10, 13) lost: the
  mismatch over the mesh must be 0;
* times the step by CUDA events over 10 steps (each rank; the line gives
  the slowest rank), beside what one card does for the rank's data block
  without a mesh: K1's encode, then its reconstruct of all 14 rows;
* encodes the global batch through MeshCoder and holds it, byte for byte,
  against K1 on one card (every rank must hold the whole parity);
* counts exactly the damaged needles of 16 [4096, 2048] scrub batches
  through ECPipeline.scrub's mesh reduction.

Then entry.dryrun_multichip(n). Prints one line per mesh with the card's
name and power limit, and a JSON summary last. --device cpu runs the same
on gloo ranks (a rehearsal; its times are host times, not the card's).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LOST = (0, 5, 10, 13)
SCRUB_BATCHES, SCRUB_SHAPE, DAMAGED = 16, (4096, 2048), 17


def _rank(n: int, shard_axis, device: str, batch: int, width: int,
          seed: int) -> dict:
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.models.ec_pipeline import ECPipeline
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.coder import host_result
    from seaweedfs_tpu_torch.parallel import pipeline as pp
    from seaweedfs_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(n, shard_axis=shard_axis, device=device)
    dev = mesh.device
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (batch, 10, width), dtype=np.uint8)
    pipe = ECPipeline(d=10, p=4, mesh=mesh)
    out = pipe.step(data, LOST)
    mismatch = int(out["rebuild_mismatch_bytes"].item())

    local = pp.shard_put(mesh, data, ("data", None, None))
    use = tuple(i for i in range(14) if i not in LOST)[:10]

    def plain():
        full = torch.cat([local, rs_cuda.encode(local, 10, 4)], 1)
        return rs_cuda.reconstruct(full[:, list(use)].contiguous(), use,
                                   tuple(range(14)), 10, 4)

    def step():
        return pipe.step(local, LOST)

    times = {}  # one card, the mesh step, one card again (in turns)
    for name, fn in (("plain_ms", plain), ("step_ms", step), ("plain_ms2", plain)):
        for _ in range(3):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            end.synchronize()
            times[name] = start.elapsed_time(end) / 10
        else:
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            times[name] = (time.perf_counter() - t0) * 100
    parity = host_result(pp.MeshCoder(mesh, 10, 4).encode(data))
    whole = rs_cuda.encode(torch.from_numpy(data).to(dev), 10, 4).cpu().numpy()
    scrub = ECPipeline(mesh=mesh)
    rows, cols = SCRUB_SHAPE
    hits = 0
    for b in range(SCRUB_BATCHES):
        sizes = 1024 + rng.integers(0, 64, rows)
        blk = rng.integers(0, 256, (rows, cols), dtype=np.uint8)
        blk[np.arange(cols)[None, :] < (cols - sizes)[:, None]] = 0
        # damage what the pipeline's scrub can see: rot in a needle's pad
        for r in rng.choice(rows, DAMAGED if b == 0 else 0, replace=False):
            blk[r, cols - sizes[r] - 1] = 0x5A
        hits += scrub.scrub(blk, sizes)
    return {"rank": mesh.rank, "coords": (mesh.axis_index("data"),
                                          mesh.axis_index("shard")),
            "mesh": dict(mesh.shape), "device": str(dev),
            "mismatch": mismatch, "parity_equal": bool(np.array_equal(parity, whole)),
            "scrub_hits": hits,
            "step_ms": times["step_ms"],
            "plain_ms": min(times["plain_ms"], times["plain_ms2"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--width", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from seaweedfs_tpu_torch.entry import dryrun_multichip
    from seaweedfs_tpu_torch.parallel.launch import launch
    from seaweedfs_tpu_torch.parallel.mesh import default_shard_axis

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("mesh_cards: CUDA is not available", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().replace("\n", " | ")
    else:
        card = "gloo ranks on the host CPU (host times)"
    n = args.ranks
    axes = sorted({default_shard_axis(n), 2 if n % 2 == 0 else 1}, reverse=True)
    summary = []
    for shard_axis in axes:
        t0 = time.perf_counter()
        res = launch(_rank, n, args=(n, shard_axis, args.device, args.batch,
                                     args.width, args.seed),
                     device=args.device, timeout=600)
        wall = time.perf_counter() - t0
        bad = [r for r in res if r["mismatch"] or not r["parity_equal"]
               or r["scrub_hits"] != DAMAGED]
        if bad:
            print(json.dumps(res), file=sys.stderr)
            raise SystemExit(f"mesh {res[0]['mesh']}: a rank disagrees")
        step = max(r["step_ms"] for r in res)
        plain = max(r["plain_ms"] for r in res)
        line = {"mesh": res[0]["mesh"], "ranks": n,
                "shape": [args.batch, 10, args.width], "step_ms": step,
                "one_card_ms": plain, "launch_wall_s": wall}
        summary.append(line)
        print(f"[mesh_cards] {res[0]['mesh']} over {n} ranks "
              f"({', '.join(r['device'] for r in res)}): step RS(10,4) "
              f"{[args.batch, 10, args.width]} mismatch 0 on every rank, "
              f"{step:.4f} ms (slowest rank); one card's K1 encode + "
              f"reconstruct of all 14 rows of a rank's data block "
              f"{plain:.4f} ms; MeshCoder "
              f"parity == one-card K1 on every rank; scrub {DAMAGED} of "
              f"{DAMAGED}; launch wall {wall:.1f} s [{card}]", flush=True)
    t0 = time.perf_counter()
    dryrun_multichip(n, device=args.device)
    print(f"[mesh_cards] dryrun_multichip({n}) in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    print(json.dumps({"card": card, "meshes": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
