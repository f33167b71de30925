"""Build kernel K3 (seaweedfs_tpu_torch/csrc/crc32c.cu) with other table
field widths and load-queue depths, hold each build against the plain
version on the card, and time them in turns at the shapes chip_smoke.py
times K3 (how K3's widths and queue depth were chosen, PERF.md §6):

    python3 scripts/k3_variants.py [VARIANT ...]

A variant is ``lane,step,fold,queue``: the field widths of the lane,
chunk-step and fold tables (the kernel's kLaneBits, kStepBits, kFoldBits)
and the chunks of loads in flight per lane (kQueue). Its source is
crc32c.cu with those four constants replaced, written to build/k3_variants/
and built with the package's nvcc flags; its tables are built here at its
widths. Each variant is timed twice, in the order given and then reversed;
the line per variant gives the lesser time of each shape, then the device
time of each of its kernels at the split shape [64, 1 MiB]
(torch.profiler). Needs a CUDA card and nvcc; exits 2 without a card.
The package itself builds and runs only the widths its sources define.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DEFAULT = ("5,5,4,2", "4,4,4,4", "4,4,4,2", "6,5,4,2", "5,5,4,4")
SHAPES = ((4096, 2048), (16384, 4096), (64, 1 << 20))
CHECK_SHAPES = ((3, 2048), (4225, 2048), (1, 1 << 20), (7, 65536))
CONSTANTS = ("kLaneBits", "kStepBits", "kFoldBits", "kQueue")


def variant_source(text: str, values) -> str:
    """crc32c.cu's text with the four constants set to `values`."""
    for name, v in zip(CONSTANTS, values):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};", text)
        if n != 1:
            raise RuntimeError(f"{name} is not defined once in crc32c.cu")
    return text


def variant_tables(lane: int, step: int, fold: int):
    """The compact table image of crc_cuda.kernel_tables at these widths."""
    import numpy as np
    from seaweedfs_tpu_torch.ops import crc_cuda as cc
    folds = np.stack([cc.field_tables(cc.bit_images(cc.pow_matrix(cc.LANE_BYTES * (cc.LANES - 1 - l))),
                                      fold) for l in range(cc.LANES)], axis=-1)
    return np.concatenate([cc.field_tables(cc.lane_bit_images(), lane),
                           cc.field_tables(cc.bit_images(cc.pow_matrix(cc.CHUNK)), step),
                           folds.ravel()]).astype(np.uint32)


def build(values):
    """Build one variant; returns (name, library, ptxas summary)."""
    from seaweedfs_tpu_torch.ops import _build
    name = "crc32c_" + "_".join(map(str, values))
    out_dir = ROOT / "build" / "k3_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(variant_source((_build.CSRC / "crc32c.cu").read_text(), values))
    so = out_dir / f"{name}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.crc32c_states.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.crc32c_states.restype = ctypes.c_int
    for fn in (lib.crc32c_table_words, lib.crc32c_shared_bytes):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    ptxas = "; ".join(line.split(":", 1)[-1].strip()
                      for line in (proc.stdout + proc.stderr).splitlines()
                      if "Used" in line or "spill" in line)
    return name, lib, ptxas


class Variant:
    """One built variant, launched as crc_cuda.crc_states launches K3."""

    def __init__(self, torch, values, dev):
        from seaweedfs_tpu_torch.ops import crc_cuda
        self.torch, self.cc, self.dev = torch, crc_cuda, dev
        self.name, self.lib, self.ptxas = build(values)
        tab = variant_tables(*values[:3])
        if self.lib.crc32c_table_words() != tab.size:
            raise RuntimeError(f"{self.name} reads {self.lib.crc32c_table_words()} table "
                               f"words, not {tab.size}")
        self.tables = torch.from_numpy(tab.view("int32").copy()).to(dev)
        self.target = crc_cuda.target_tasks(dev)
        self.shift = {}

    def __call__(self, x):
        torch, cc = self.torch, self.cc
        b, length = x.shape
        out = torch.empty(b, dtype=torch.int64, device=self.dev)
        chunks = length // cc.CHUNK
        s = cc.segments(b, chunks, self.target)
        seg = shift = out
        if s > 1:
            q = chunks // s
            seg = torch.empty(b * s, dtype=torch.int32, device=self.dev)
            if q not in self.shift:
                self.shift[q] = torch.from_numpy(
                    cc.shift_tables(cc.CHUNK * q).view("int32").copy()).to(self.dev)
            shift = self.shift[q]
        rc = self.lib.crc32c_states(x.data_ptr(), out.data_ptr(), seg.data_ptr(),
                                    self.tables.data_ptr(), shift.data_ptr(), b, length, s,
                                    torch.cuda.current_stream(self.dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")
        return out


def queued_ms(torch, fn, inputs, iters: int) -> float:
    """Device ms per call, the calls queued back to back behind a sleeping
    kernel, each on the next input."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(DEFAULT),
                    help="lane,step,fold,queue (default: %(default)s)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k3_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from seaweedfs_tpu_torch.ops import crc_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    runs = {}
    for spec in args.variants:
        v = Variant(torch, tuple(int(x) for x in spec.split(",")), dev)
        runs[v.name] = v
        print(f"[{v.name}] ptxas: {v.ptxas}; shared memory {v.lib.crc32c_shared_bytes()} B",
              flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for b, length in CHECK_SHAPES:
        x = torch.randint(0, 256, (b, length), dtype=torch.uint8, device=dev, generator=gen)
        want = crc_torch.crc_states(x)
        for name, run in runs.items():
            if not torch.equal(run(x), want):
                raise AssertionError(f"{name} differs from the plain version at [{b}, {length}]")
    print(f"all variants == plain version at {list(CHECK_SHAPES)}", flush=True)
    sets = {}
    for b, length in SHAPES:  # distinct inputs adding up to >= 256 MiB, five times the L2
        n = max(4, -(-(256 << 20) // (b * length)))
        sets[(b, length)] = [torch.randint(0, 256, (b, length), dtype=torch.uint8, device=dev,
                                           generator=gen) for _ in range(n)]
    times = {(name, shape): [] for name in runs for shape in SHAPES}
    for name in list(runs) + list(reversed(runs)):
        for shape, xs in sets.items():
            iters = 200 if shape[0] * shape[1] < (64 << 20) else 50
            times[(name, shape)].append(queued_ms(torch, runs[name], xs, iters))
    for name, run in runs.items():
        xs = sets[SHAPES[-1]]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(20):
                run(xs[i % len(xs)])
            torch.cuda.synchronize()
        kernels = {a.key.split("::")[-1].split("(")[0]: getattr(
            a, "self_device_time_total", getattr(a, "self_cuda_time_total", 0)) / 20
            for a in prof.key_averages() if "crc_" in a.key}
        print(f"[{name}] " + "; ".join(
            f"[{b}, {length}] {min(times[(name, (b, length))]) * 1e3:.2f} us"
            for b, length in SHAPES) + "; at " + str(list(SHAPES[-1])) + " per call: "
            + ", ".join(f"{k} {us:.2f} us" for k, us in kernels.items()) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
