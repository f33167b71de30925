"""Inputs and rank programs of the port's multi-device tests
(tests/test_torch_mesh.py on gloo CPU ranks, tests/test_torch_gpu.py on
the card).

The rank programs run on every rank of a world that
parallel/launch.launch spawned, so this module imports only the port and
numpy (never JAX, which the test process holds): `sharded_results` builds
the mesh, runs the port's sharded steps on inputs made here with numpy
(`make_cases`) and returns the global results, which every rank must
agree on.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

GEOMETRIES = [(10, 4), (14, 2)]
# all four kinds of loss, parity-only and data-only included
LOSSES = {(10, 4): [(0, 5, 10, 13), (10, 13), (1, 2, 3, 4)],
          (14, 2): [(0, 5), (14, 15), (0, 1)]}
STEP_LOST = {(10, 4): (0, 5, 10, 13), (14, 2): (0, 5)}
LARGE, SMALL = 8192, 1024


def _ceil_to(x, m):
    return (x + m - 1) // m * m


def _scrub_case(rng):
    """16 left-padded needles with their raw states, and the same batch
    with 3 of them damaged (tests/test_parallel.py's scrub case)."""
    from seaweedfs_tpu_torch.ops import crc32c
    nb, width = 16, 256
    lengths = rng.integers(1, 200, nb)
    blocks = np.zeros((nb, width), dtype=np.uint8)
    for i, ln in enumerate(lengths):
        blocks[i, width - ln:] = rng.integers(0, 256, ln, dtype=np.uint8)
    states = np.zeros(nb, dtype=np.uint32)
    for i, ln in enumerate(lengths):
        true = crc32c.crc32c(blocks[i, width - ln:].tobytes())
        corr = crc32c.zero_prefix_correction(np.array([ln]))[0]
        states[i] = np.uint32(true) ^ corr ^ np.uint32(0xFFFFFFFF)
    damaged = blocks.copy()
    damaged[1, -1] ^= 0xFF
    damaged[7, width - 1] ^= 1
    damaged[12, width - 5] ^= 0x10
    # what ECPipeline.scrub can see: its expected states come from the
    # blocks themselves, so only rot in the left pad shows
    rotted = blocks.copy()
    for i in (2, 9, 14):
        rotted[i, width - lengths[i] - 1] = 7
    return {"blocks": blocks, "damaged": damaged, "rotted": rotted,
            "lengths": lengths, "states": states.astype(np.int64)}


def make_cases(n_shard: int, n_data: int, tmp) -> dict:
    """Every input of sharded_results for a mesh of n_data x n_shard, from
    numpy seeds; two .dat files are written under `tmp`."""
    from seaweedfs_tpu_torch.ops.coder import NumpyCoder
    rng = np.random.default_rng(20 + n_shard)
    dats = []
    for i, size in enumerate((30_000, 37_017)):
        path = Path(tmp) / f"src{i}.dat"
        path.write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        dats.append(str(path))
    geos = {}
    for d, p in GEOMETRIES:
        n, n_pad = d + p, _ceil_to(d + p, n_shard)
        shards = np.zeros((2, n_pad, 64), dtype=np.uint8)
        shards[:, :d] = rng.integers(0, 256, (2, d, 64), dtype=np.uint8)
        shards[:, d:n] = NumpyCoder(d, p).encode(shards[:, :d])
        wiped = {}
        for lost in LOSSES[(d, p)]:
            w = shards.copy()  # lost rows and the padding hold garbage
            w[:, list(lost)] = rng.integers(0, 256, (2, len(lost), 64),
                                            dtype=np.uint8)
            w[:, n:] = 0xA5
            wiped[lost] = w
        present = tuple(i for i in range(n) if i not in (1, n - 1))[:d]
        odd = rng.integers(0, 256, (3, d, 64), dtype=np.uint8)
        full = np.concatenate([odd, NumpyCoder(d, p).encode(odd)], 1)
        geos[(d, p)] = {
            "data": rng.integers(0, 256, (4, d, 128), dtype=np.uint8),
            "shards": shards, "wiped": wiped,
            "step_data": rng.integers(0, 256, (4, d, 256), dtype=np.uint8),
            "step_lost": STEP_LOST[(d, p)],
            "odd": odd, "survivors": full[:, list(present)],
            "present": present, "wanted": (1, n - 1), "full": full}
    return {"geometries": geos, "dats": dats, "large_block": LARGE,
            "small_block": SMALL, "scrub": _scrub_case(rng),
            "batch": n_data * 2}


def sharded_results(n: int, shard_axis: "int | None", cases: dict,
                    workdir: str, device: str) -> dict:
    """The port's global outputs for every case of `cases` on a mesh of n
    ranks on `device`, with the kernel launches they made."""
    from seaweedfs_tpu_torch.ec import stream
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.models.ec_pipeline import ECPipeline
    from seaweedfs_tpu_torch.ops import crc_cuda, rs_cuda
    from seaweedfs_tpu_torch.ops.coder import host_result
    from seaweedfs_tpu_torch.parallel import pipeline as pp
    from seaweedfs_tpu_torch.parallel.mesh import AXES, build_mesh

    def cpu(t):
        return t.cpu().numpy()

    rs_cuda.reset_launches()
    crc_cuda.reset_launches()
    mesh = build_mesh(n, shard_axis=shard_axis, device=device)
    out = {"mesh": dict(mesh.shape), "rank": mesh.rank,
           "coords": (mesh.axis_index("data"), mesh.axis_index("shard"))}
    for (d, p), case in cases["geometries"].items():
        res = out[(d, p)] = {}
        local = pp.shard_put(mesh, case["data"], ("data", None, None))
        parity = pp.encode_sharded(mesh, local, d, p)
        res["parity_local_shape"] = tuple(parity.shape)
        res["parity"] = cpu(pp.gather(mesh, parity, ("data", "shard", None)))
        res["rebuilt"] = {}
        for lost, wiped in case["wiped"].items():
            present = tuple(i for i in range(d + p) if i not in lost)
            rebuilt = pp.rebuild_sharded(
                mesh, pp.shard_put(mesh, wiped, ("data", "shard", None)),
                present, d, p)
            res["rebuilt"][lost] = cpu(pp.gather(mesh, rebuilt,
                                                 ("data", "shard", None)))
        pipe = ECPipeline(d=d, p=p, mesh=mesh)
        step = pipe.step(case["step_data"], case["step_lost"])
        res["step"] = {k: int(v.item()) for k, v in step.items()}
        res["step_n_pad"] = pipe.n_pad()
        geo = EcGeometry(d=d, p=p, large_block=cases["large_block"],
                         small_block=cases["small_block"])
        base = os.path.join(workdir, f"{device}{mesh.rank}_{d}_{p}")
        jobs = [(dat, f"{base}_{i}", None)
                for i, dat in enumerate(cases["dats"])]
        stats = {}
        coder = pp.MeshCoder(mesh, d, p)
        stream.encode_volumes(jobs, geo, coder, batch=cases["batch"],
                              stats=stats)
        res["stream_mode"] = stats["mode"]
        res["shards"] = [[Path(f"{b}.ec{s:02d}").read_bytes()
                          for s in range(d + p)] for _, b, _ in jobs]
        res["encode_odd"] = host_result(coder.encode(case["odd"]))
        res["reconstruct"] = host_result(coder.reconstruct(
            case["survivors"], case["present"], case["wanted"]))
    scrub = cases["scrub"]
    pipe = ECPipeline(mesh=mesh)
    for key in ("blocks", "damaged"):
        out[f"scrub_{key}"] = int(pp.scrub_sharded(
            mesh, pp.shard_put(mesh, scrub[key], (AXES, None)),
            pp.shard_put(mesh, scrub["states"], (AXES,))).item())
    out["pipeline_scrub"] = pipe.scrub(scrub["rotted"], scrub["lengths"])
    out["launches"] = {"k1": dict(rs_cuda.launches_by_entry),
                       "k3": crc_cuda.launches}
    return out


def fail_on_rank(bad_rank: int) -> int:
    """Rank `bad_rank` raises; the others block in a collective that can
    never complete, as a world with a dead rank would."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    x = torch.zeros(1)
    dist.all_reduce(x)
    return dist.get_rank()
