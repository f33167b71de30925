"""Launch a torch.distributed world of n rank processes on one host.

The JAX package runs its mesh inside one process over virtual devices; the
port runs one process per device. ``launch(fn, n, args, device)`` spawns n
fresh interpreters (``spawn``: nothing of the caller's state is inherited,
so a caller that has imported JAX hands none of it to its ranks), joins
them into one world (NCCL over one card per rank on "cuda", gloo on "cpu")
through a file store in a private temporary directory, calls
``fn(*args)`` on every rank and returns the ranks' results in rank order.
`fn` must be importable by name (a module-level function).

Every wait is bounded: a rank that raises, dies or outlives `timeout`
fails the launch, and every rank still alive is then killed — a world with
a dead rank would otherwise hang in its next collective.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback


#: after a rank fails, how long the others get to report before the launch
#: gives up on them
_GRACE_S = 2.0


class LaunchError(RuntimeError):
    """A rank raised, died or ran over its time."""


def launch(fn, n: int, args: tuple = (), device: str = "cuda",
           timeout: float = 300.0) -> list:
    """Run fn(*args) on every rank of a fresh n-rank world; returns the
    results in rank order."""
    if n < 1:
        raise ValueError(f"a world needs at least one rank, got {n}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: a world on 'cuda' needs NVIDIA "
                "cards; pass device='cpu' explicitly for gloo ranks")
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"{n} ranks need {n} cards, "
                               f"{torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="swtpu_torch_world_")
    results: dict = {}
    errors: "dict[int, str]" = {}
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         name=f"swtpu-torch-rank-{r}",
                         args=(r, n, f"file://{tmp}/store", device, fn, args,
                               out))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results
                        and r not in errors and p.exitcode is not None]
                for r in dead:
                    errors[r] = (f"exited with code {procs[r].exitcode} "
                                 f"before it reported")
                continue
            if ok:
                results[rank] = value
            else:
                errors[rank] = value
                # the ranks it leaves in a collective fail soon after (or
                # hang): gather what they say for a moment, then stop
                deadline = min(deadline, time.monotonic() + _GRACE_S)
        if errors:
            raise LaunchError("\n".join(
                f"rank {r} of {n} failed:\n{errors[r]}" for r in sorted(errors)))
        if len(results) < n:
            raise LaunchError(f"{n - len(results)} of {n} ranks still "
                              f"running after {timeout:.0f} s")
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(10)
        out.close()
        out.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n)]


def _rank_main(rank: int, n: int, init_method: str, device: str, fn,
               args: tuple, out) -> None:
    """One rank: join the world, run fn(*args), report (rank, ok, value)."""
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        import torch
        import torch.distributed as dist

        from .mesh import COLLECTIVE_TIMEOUT
        kwargs = dict(init_method=init_method, rank=rank, world_size=n,
                      timeout=COLLECTIVE_TIMEOUT)
        if device == "cuda":
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", device_id=dev, **kwargs)
        else:
            # n CPU ranks on one host share its cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
            dist.init_process_group("gloo", **kwargs)
        try:
            value = fn(*args)
            if device == "cuda":
                torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        out.put((rank, True, value))
    except Exception:  # noqa: BLE001 — reported to the launcher, which raises
        out.put((rank, False, traceback.format_exc()))
