"""Entry points of the port, mirroring the JAX package's __graft_entry__:

* ``entry`` — the forward step of the flagship pipeline, RS(10,4)
  stripe-batch encode (the ec.encode hot path), with its example input,
  made with numpy from a fixed seed;
* ``dryrun_multichip`` — the full distributed EC step over an n-device
  ('data', 'shard') mesh. The reference runs it over n virtual devices in
  one process; the port launches n rank processes (parallel/launch.py),
  NCCL over one card each, or gloo on the CPU when asked.
"""

from __future__ import annotations

import numpy as np


def entry(device="cuda"):
    """(fn, example_args): ECPipeline(10, 4).forward and a [8, 10, 65536]
    uint8 stripe batch. Runs on the card unless device="cpu" is asked for."""
    from .models.ec_pipeline import ECPipeline

    pipe = ECPipeline(d=10, p=4, device=device)
    data = np.random.default_rng(0).integers(
        0, 256, size=(8, 10, 64 * 1024), dtype=np.uint8)
    return pipe.forward, (data,)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 600.0) -> "list[dict]":
    """Run the FULL distributed EC step on n launched ranks — encode
    (shard-parallel parity through K1), shard layout, all_gather rebuild
    along the shard axis, mismatch all_reduce — plus a mesh-wide CRC scrub
    (K3) and three .dat files streamed through MeshCoder, each rank's
    shard files bit-exact against NumpyCoder. Raises if any rank fails;
    returns each rank's report."""
    from .parallel.launch import launch

    reports = launch(_dryrun_rank, n_devices, args=(n_devices, device),
                     device=device, timeout=timeout)
    print(f"dryrun_multichip({n_devices}): mesh {reports[0]['mesh']} on "
          f"{device} ok — rebuild exact, scrub clean, from-disk sharded "
          f"encode bit-exact on every rank")
    return reports


def _dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of dryrun_multichip (the reference's steps, in its order
    and from its seed)."""
    import shutil
    import tempfile

    import torch

    from .ec import encoder as ec_encoder
    from .ec import stream
    from .ec.locate import EcGeometry
    from .models.ec_pipeline import ECPipeline
    from .ops.coder import NumpyCoder
    from .parallel.mesh import build_mesh
    from .parallel.pipeline import MeshCoder

    mesh = build_mesh(n_devices, device=device)
    pipe = ECPipeline(d=10, p=4, mesh=mesh)

    rng = np.random.default_rng(1)
    b, l = mesh.shape["data"] * 2, 512
    data = rng.integers(0, 256, size=(b, 10, l), dtype=np.uint8)
    out = pipe.step(data, (0, 5, 10, 13))  # 2 data + 2 parity shards
    mism = int(out["rebuild_mismatch_bytes"].item())
    if mism:
        raise AssertionError(f"rebuild mismatch bytes: {mism}")

    # mesh-wide CRC scrub on a small needle batch
    nb = n_devices * 2
    lengths = rng.integers(1, 200, nb)
    blocks = np.zeros((nb, 256), dtype=np.uint8)
    for i, ln in enumerate(lengths):
        blocks[i, 256 - ln:] = rng.integers(0, 256, ln, dtype=np.uint8)
    bad = pipe.scrub(blocks, lengths)
    if bad:
        raise AssertionError(f"scrub false positives: {bad}")

    # host feed -> mesh: stream .dat files through the sharded coder and
    # hold this rank's shard files against the NumpyCoder oracle
    geo = EcGeometry(d=10, p=4, large_block=8192, small_block=1024)
    tmp = tempfile.mkdtemp(prefix=f"swtpu_torch_dryrun_{mesh.rank}_")
    try:
        jobs = []
        for i in range(3):
            dat = f"{tmp}/{i}.dat"
            with open(dat, "wb") as f:
                f.write(rng.integers(0, 256, 30_000 + 7_000 * i,
                                     dtype=np.uint8).tobytes())
            jobs.append((dat, f"{tmp}/mesh{i}", None))
        stream.encode_volumes(jobs, geo, MeshCoder(mesh, 10, 4),
                              batch=mesh.shape["data"] * 2)
        for i, (dat, out_base, _) in enumerate(jobs):
            oracle_base = f"{tmp}/oracle{i}"
            ec_encoder.encode_volume(dat, oracle_base, geo, NumpyCoder(10, 4))
            for s in range(geo.n):
                ext = f".ec{s:02d}"
                with open(out_base + ext, "rb") as fa, \
                        open(oracle_base + ext, "rb") as fb:
                    if fa.read() != fb.read():
                        raise AssertionError(
                            f"mesh-encoded shard {s} of vol {i} diverges "
                            f"on rank {mesh.rank}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if device == "cuda":
        torch.cuda.synchronize()
    return {"rank": mesh.rank, "mesh": dict(mesh.shape),
            "device": str(mesh.device),
            "rebuild_mismatch_bytes": mism,
            "bytes_encoded": int(out["bytes_encoded"].item()),
            "scrub_bad": bad, "volumes": len(jobs)}
