"""Kernels K1 (seaweedfs_tpu_torch/csrc/rs_gf.cu) and K3 (csrc/crc32c.cu) on
the card, against their plain PyTorch versions, the port's NumpyCoder, the
scrub's host loop and a Store on the CPU (all held to the JAX package by the
CPU tests). CUDA kernels have no interpret mode, so every
test here is marked `gpu` and skips where there is no card. Imports only
the port, so it also runs where jax is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import concurrent.futures as cf
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks

from seaweedfs_tpu_torch.ec import encoder, files, stream
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.entry import dryrun_multichip
from seaweedfs_tpu_torch.models.ec_pipeline import ECPipeline
from seaweedfs_tpu_torch.ops import crc32c, crc_cuda, crc_torch, rs_cuda, rs_torch
from seaweedfs_tpu_torch.ops.coder import NumpyCoder, TorchCoder, get_coder
from seaweedfs_tpu_torch.parallel import launch
from seaweedfs_tpu_torch.parallel.mesh import build_mesh
from seaweedfs_tpu_torch.server.volume_server import make_shard_reader
from seaweedfs_tpu_torch.storage import scrub
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume

GEO = EcGeometry(d=4, p=2, large_block=4096, small_block=512)
SIZES = [0, 77, GEO.small_block * GEO.d, GEO.large_block * GEO.d + 1,
         GEO.large_block * GEO.d * 2 + GEO.small_block * 3 + 123,
         GEO.small_block - 1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K1 and K3 are CUDA-only; no "
                    "interpret mode)")
    return torch.device("cuda")


def _data(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def _lost(d, p, seed):
    rng = np.random.default_rng(seed)
    return tuple(sorted(rng.choice(d + p, size=p, replace=False).tolist()))


@pytest.mark.gpu
@pytest.mark.parametrize("d,p", [(10, 4), (14, 2), (5, 3), (4, 2)])
def test_k1_matches_plain_on_card(cuda, d, p):
    before = rs_cuda.launches
    for C in (100, 384, 65536):
        data = torch.from_numpy(_data((3, d, C), C + d)).to(cuda)
        want = rs_torch.encode(data, d, p)
        np.testing.assert_array_equal(rs_cuda.encode(data, d, p).cpu().numpy(),
                                      want.cpu().numpy())
        shards = torch.cat([data, want], dim=1)
        for seed in (0, 1, 2):
            lost = _lost(d, p, seed)
            present = tuple(i for i in range(d + p) if i not in lost)
            surv = shards[:, sorted(present)[:d]].contiguous()
            got = rs_cuda.reconstruct(surv, present, lost, d, p)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          shards[:, list(lost)].cpu().numpy())
        got = rs_cuda.encode_seeded(data, 77, d, p)
        np.testing.assert_array_equal(
            got.cpu().numpy(), rs_torch.encode(data ^ 77, d, p).cpu().numpy())
        np.testing.assert_array_equal(
            rs_cuda.encode(data[0].contiguous(), d, p).cpu().numpy(),
            want[0].cpu().numpy())
    torch.cuda.synchronize()
    assert rs_cuda.launches > before


@pytest.mark.gpu
def test_k1_rejects_non_contiguous_on_card(cuda):
    data = torch.zeros((2, 4, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        rs_cuda.encode(data[:, :, ::2], 4, 2)


def _outputs(base, n):
    exts = [files.shard_ext(s) for s in range(n)] + [".ecx", ".vif"]
    return {e: open(base + e, "rb").read() for e in exts
            if os.path.exists(base + e)}


@pytest.mark.gpu
def test_encode_rebuild_through_k1_on_card(cuda, tmp_path):
    rng = np.random.default_rng(7)
    jobs_np, jobs_k1 = [], []
    for i, size in enumerate(SIZES):
        dat = tmp_path / f"{i}.dat"
        dat.write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        jobs_np.append((str(dat), str(tmp_path / f"np{i}"), None))
        jobs_k1.append((str(dat), str(tmp_path / f"k1{i}"), None))
    stream.encode_volumes(jobs_np, GEO, NumpyCoder(4, 2), chunk=256, batch=3)
    before = rs_cuda.launches
    stream.encode_volumes(jobs_k1, GEO, TorchCoder(4, 2), chunk=256, batch=3)
    assert rs_cuda.launches > before
    for (_, want, _), (_, got, _) in zip(jobs_np, jobs_k1):
        assert _outputs(got, GEO.n) == _outputs(want, GEO.n)
    base = jobs_k1[4][1]
    orig = _outputs(base, GEO.n)
    for s in (1, 4):
        os.unlink(base + files.shard_ext(s))
    assert encoder.rebuild_shards(base, GEO, TorchCoder(4, 2), chunk=256,
                                  batch=3) == [1, 4]
    assert _outputs(base, GEO.n) == orig


@pytest.mark.gpu
@pytest.mark.parametrize("rows,length", [(1, 512), (3, 2048), (4096, 2048),
                                         (3, 65536), (2, 1 << 20), (5, 0),
                                         (4225, 2048), (1, 1 << 20)])
def test_k3_matches_plain_on_card(cuda, rows, length):
    before = crc_cuda.launches
    x = torch.from_numpy(_data((rows, length), rows + length)).to(cuda)
    got = crc_cuda.crc_states(x)
    assert got.dtype == torch.int64 and got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  crc_torch.crc_states(x).cpu().numpy())
    torch.cuda.synchronize()
    assert crc_cuda.launches == before + (1 if length else 0)


@pytest.mark.gpu
def test_k3_rejects_non_contiguous_on_card(cuda):
    x = torch.zeros((4, 1024), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        crc_cuda.crc_states(x[:, :512])


@pytest.mark.gpu
def test_k3_finalized_needles_on_card(cuda):
    lengths = [0, 1, 511, 512, 513, 1087, 9000]
    rng = np.random.default_rng(5)
    msgs = [rng.integers(0, 256, n, dtype=np.uint8) for n in lengths]
    blocks = np.zeros((len(msgs), 16384), dtype=np.uint8)
    for i, m in enumerate(msgs):
        blocks[i, 16384 - m.size:] = m
    raw = crc_cuda.crc_states(torch.from_numpy(blocks).to(cuda))
    vals = crc32c.finalize(raw.cpu().numpy().astype(np.uint32), np.array(lengths))
    assert [int(v) for v in vals] == [crc32c.crc32c(m.tobytes()) for m in msgs]


@pytest.mark.gpu
def test_scrub_through_k3_on_card(cuda, tmp_path):
    v = Volume(str(tmp_path), "", 1)
    rng = np.random.default_rng(3)
    for i in range(1, 301):
        v.write_needle(Needle(id=i, cookie=1, data=rng.bytes(int(rng.integers(0, 3000)))))
    nv = v.nm.get(17)
    with open(v.dat_path, "r+b") as f:
        f.seek(nv.offset + 16 + nv.size)
        f.write(b"\x00\x00\x00\x00" if nv.size > 5 else b"\x01")
    before = crc_cuda.launches
    got = scrub.scrub_volume(v, device="cuda", batch=64)
    assert crc_cuda.launches > before and got.mode == "device"
    want = scrub.scrub_volume(v, device="off", batch=64)
    assert (got.scanned, got.corrupt, got.bytes_checked, got.error) == (
        want.scanned, want.corrupt, want.bytes_checked, want.error)
    assert got.corrupt == [17]
    v.close()


@pytest.mark.gpu
def test_pipeline_scrub_on_card(cuda):
    rng = np.random.default_rng(4)
    lengths = rng.integers(1, 768, 16)
    blocks = np.zeros((16, 768), dtype=np.uint8)
    for i, n in enumerate(lengths):
        blocks[i, 768 - n:] = rng.integers(0, 256, n, dtype=np.uint8)
    blocks[2, 768 - lengths[2] - 1] = 1
    counts = []
    for device in ("cuda", "cpu"):  # an NCCL world of one, then a gloo one
        pipe = ECPipeline(device=device)
        try:
            counts.append(pipe.scrub(blocks, lengths))
        finally:
            pipe.close()
    assert counts == [1, 1]


@pytest.mark.gpu
def test_store_degraded_read_through_k1_on_card(cuda, tmp_path):
    geo = EcGeometry(d=10, p=4, large_block=8192, small_block=1024)
    card = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "card"))],
                 ec_geometry=geo)
    rng = np.random.default_rng(6)
    card.add_volume(1)
    want = {i: rng.bytes(int(rng.integers(0, 3000))) for i in range(1, 81)}
    card.write_needles_bulk(1, [Needle(id=i, cookie=9, data=d)
                                for i, d in want.items()])
    before = dict(rs_cuda.launches_by_entry)
    base = card.generate_ec_shards(1)
    assert rs_cuda.launches_by_entry.get("encode", 0) > before.get("encode", 0)
    card.delete_volume(1)
    os.makedirs(tmp_path / "cpu")
    for ext in [files.shard_ext(s) for s in range(1, 14)] + [".ecx", ".vif"]:
        shutil.copy(base + ext, str(tmp_path / "cpu" / "1") + ext)
    os.unlink(base + files.shard_ext(0))
    card.mount_ec_shards(1)
    cpu = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "cpu"))],
                ec_geometry=geo, device="cpu")
    with cf.ThreadPoolExecutor(2) as pool:
        stats = {}
        on_card = make_shard_reader(card, 1, lambda *a: None, pool, stats)
        on_cpu = make_shard_reader(cpu, 1, lambda *a: None, pool)
        before = rs_cuda.launches_by_entry.get("reconstruct", 0)
        for i, data in want.items():
            got = card.read_needle(1, i, cookie=9, shard_reader=on_card)
            assert got.data == data == cpu.read_needle(1, i, shard_reader=on_cpu).data
        assert on_card(0, 100, 3000) == on_cpu(0, 100, 3000)
    assert stats["reconstructs"] > 0
    assert rs_cuda.launches_by_entry["reconstruct"] >= before + stats["reconstructs"]
    card.close()
    cpu.close()


@pytest.mark.gpu
def test_offload_degraded_read_promote_on_card(cuda, tmp_path):
    """EC shards offloaded to a tier and served from it: intervals on a lost
    shard are reconstructed through K1 from survivors read off the tier,
    equal to the plain version's; then the shards are promoted back."""
    geo = EcGeometry(d=14, p=2, large_block=8192, small_block=1024)
    card = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "card"))],
                 ec_geometry=geo)
    rng = np.random.default_rng(8)
    card.add_volume(1)
    want = {i: rng.bytes(int(rng.integers(0, 3000))) for i in range(1, 81)}
    card.write_needles_bulk(1, [Needle(id=i, cookie=3, data=d)
                                for i, d in want.items()])
    base = card.generate_ec_shards(1)
    card.delete_volume(1)
    card.mount_ec_shards(1)
    hashes = {s: open(base + files.shard_ext(s), "rb").read() for s in range(16)}
    for s in (0, 5):
        os.unlink(base + files.shard_ext(s))
    card.unmount_ec_shards(1, [0, 5])
    spec = f"local:{tmp_path / 'tier'}"
    assert card.offload_ec_shards(1, spec) > 0
    assert card.find_ec_volume(1).remote_shard_ids() == \
        [s for s in range(16) if s not in (0, 5)]
    with cf.ThreadPoolExecutor(2) as pool:
        stats = {}
        on_card = make_shard_reader(card, 1, lambda *a: None, pool, stats)
        before = rs_cuda.launches_by_entry.get("reconstruct", 0)
        for i, data in want.items():
            assert card.read_needle(1, i, cookie=3, shard_reader=on_card).data == data
        assert on_card(0, 100, 900) == hashes[0][100:1000]
    assert stats["reconstructs"] > 0
    assert rs_cuda.launches_by_entry["reconstruct"] >= before + stats["reconstructs"]
    held = card.find_ec_volume(1)
    assert card.rebuild_ec_shards(
        1, shard_reader=lambda sid, off, ln: held.shards[sid].read_at(off, ln),
        remote_shards=held.remote_shard_ids(), wanted=[0, 5]) == [0, 5]
    assert card.promote_ec_shards(1) > 0
    assert {s: open(base + files.shard_ext(s), "rb").read() for s in range(16)} == hashes
    assert card.find_ec_volume(1).remote_shard_ids() == []
    card.close()


@pytest.mark.gpu
@pytest.mark.parametrize("d,p", [(10, 4), (14, 2)])
def test_layered_codecs_on_card_match_cpu(cuda, d, p):
    """ProductMatrixCoder and PiggybackCoder on the card (GF applies through
    K1's apply, encode and reconstruct entries) against their CPU selves."""
    from seaweedfs_tpu_torch.ops.piggyback import PiggybackCoder
    from seaweedfs_tpu_torch.ops.product_matrix import ProductMatrixCoder
    pm, pm_cpu = ProductMatrixCoder(d, p), ProductMatrixCoder(d, p, device="cpu")
    data = _data((2, d, pm.alpha * 6), d)
    before = rs_cuda.launches_by_entry.get("apply", 0)
    par = pm.encode(data)
    assert rs_cuda.launches_by_entry["apply"] > before
    np.testing.assert_array_equal(par, pm_cpu.encode(data))
    shards = np.concatenate([data, par], axis=1)
    for lost in [(0, d), (d, d + p - 1), (1,)]:
        present = tuple(i for i in range(d + p) if i not in lost)
        surv = shards[:, sorted(present)[:d]]
        np.testing.assert_array_equal(pm.reconstruct(surv, present, lost),
                                      shards[:, list(lost)])
    g, s = pm.grid, 6
    row = shards[0]
    planes = g.repair_planes(3)
    c = np.zeros((g.nbar, g.alpha, s), np.uint8)
    for sid in range(d + p):
        if sid != 3:
            c[sid, planes] = row[sid].reshape(g.alpha, s)[planes]
    np.testing.assert_array_equal(pm.repair_decode(c, 3).reshape(-1), row[3])
    plan = pm.interval_plan(tuple(i for i in range(d + p) if i != 3), 3, 5, 40,
                            g.alpha * s)
    fetched = {sid: b"".join(row[sid][o:o + k].tobytes()
                             for o, k in plan.byte_ranges(sid)) for sid in plan.fetch}
    assert pm.interval_decode(plan, fetched) == row[3][5:45].tobytes()
    pb, pb_cpu = PiggybackCoder(d, p), PiggybackCoder(d, p, device="cpu")
    data = _data((3, d, 1000), d + 1)
    par = pb.encode(data)
    np.testing.assert_array_equal(par, pb_cpu.encode(data))
    shards = np.concatenate([data, par], axis=1)
    present = tuple(i for i in range(d + p) if i not in (1, d + 1))
    surv = shards[:, sorted(present)[:d]]
    np.testing.assert_array_equal(pb.reconstruct(surv, present, (1, d + 1)),
                                  shards[:, [1, d + 1]])


@pytest.mark.gpu
def test_msr_apply_raises_when_kernel_fails_to_load(cuda, monkeypatch):
    from seaweedfs_tpu_torch.ops.product_matrix import ProductMatrixCoder
    pm = ProductMatrixCoder(4, 2)
    monkeypatch.setattr(rs_cuda, "_LIB", None)

    def broken():
        raise OSError("libswtpu_rs_gf.so: cannot open shared object file")
    monkeypatch.setattr(rs_cuda, "load", broken)
    with pytest.raises(OSError, match="cannot open"):
        pm.encode(_data((4, pm.alpha * 2), 1))


def _same(a, b, path="") -> None:
    """a == b, recursively, arrays byte for byte."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.gpu
def test_mesh_step_on_one_card_matches_cpu_plain_run(cuda, tmp_path):
    """The sharded encode, rebuild, scrub, ECPipeline.step and MeshCoder
    stream on a 1x1 NCCL mesh (K1 and K3 on the card) against the same
    program on a 1x1 gloo mesh (the plain versions), byte for byte."""
    cases = torch_mesh_ranks.make_cases(1, 1, tmp_path)
    card, plain = (launch.launch(torch_mesh_ranks.sharded_results, 1,
                                 args=(1, None, cases, str(tmp_path), dev),
                                 device=dev, timeout=300)[0]
                   for dev in ("cuda", "cpu"))
    launches = card.pop("launches"), plain.pop("launches")
    _same(card, plain)
    assert card[(10, 4)]["step"]["rebuild_mismatch_bytes"] == 0
    assert card["scrub_damaged"] == 3 and card["pipeline_scrub"] == 3
    k1, k3 = launches[0]["k1"], launches[0]["k3"]
    assert k1.get("encode", 0) > 0 and k1.get("reconstruct", 0) > 0 and k3 > 0
    assert launches[1] == {"k1": {}, "k3": 0}


@pytest.mark.gpu
def test_mesh_coder_raises_when_k1_fails_to_load(cuda, monkeypatch):
    coder = get_coder("mesh", 10, 4)  # an NCCL world of one, in-process
    try:
        assert str(dist.get_backend()) == "nccl"
        assert coder.device.type == "cuda"
        monkeypatch.setattr(rs_cuda, "_LIB", None)

        def broken():
            raise OSError("libswtpu_rs_gf.so: cannot open shared object file")
        monkeypatch.setattr(rs_cuda, "load", broken)
        for call in (lambda: coder.encode(_data((2, 10, 100), 1)),
                     lambda: coder.reconstruct(_data((2, 10, 100), 2),
                                               tuple(range(10)), (10,))):
            with pytest.raises(OSError, match="cannot open"):
                call()
    finally:
        coder.mesh.close()
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_build_mesh_on_cuda_without_cuda_raises(cuda, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_mesh(device="cuda")
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_dryrun_multichip_on_card(cuda):
    reports = dryrun_multichip(1)
    assert reports == [{"rank": 0, "mesh": {"data": 1, "shard": 1},
                        "device": "cuda:0", "rebuild_mismatch_bytes": 0,
                        "bytes_encoded": 2 * 10 * 512, "scrub_bad": 0,
                        "volumes": 3}]


@pytest.mark.gpu
def test_device_trace_records_kernels_on_card(cuda, tmp_path):
    """utils/profiling's capture sees K1's launches on the card."""
    from seaweedfs_tpu_torch.utils import profiling
    x = torch.from_numpy(_data((4, 10, 4096), 9)).to(cuda)
    profiling.start_device_trace(out_dir=str(tmp_path))
    try:
        for _ in range(3):
            rs_cuda.encode(x, 10, 4)
        torch.cuda.synchronize()
    finally:
        path = profiling.stop_device_trace()
    import json
    with open(path) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]
                 if ev.get("cat") == "kernel"}
    assert any("rs_gf" in n for n in names), sorted(names)[:20]


@pytest.mark.gpu
def test_degraded_http_read_on_card_launches_k1(cuda, tmp_path):
    """One degraded needle read over the volume server's HTTP plane on the
    card: the lost interval reconstructed through K1 at one stripe."""
    import requests

    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.types import file_id
    store = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path))],
                  ec_geometry=GEO, coder_name="torch", device="cuda")
    vs = VolumeServer(store, "127.0.0.1", 18431)
    vs.start()
    try:
        body = _data(3000, 41).tobytes()
        fid = file_id(1, 7, 0xC0FFEE)
        vs.allocate_volume(1)
        assert requests.post(f"http://{vs.url}/{fid}", data=body,
                             timeout=10).status_code == 201
        vs.volume_mark_readonly(1)
        vs.volume_ec_shards_generate(1)
        vs.volume_ec_shards_mount(1)
        vs.volume_delete(1)
        ev = store.find_ec_volume(1)
        off, _ = ev.find_needle(7)
        first = off // GEO.small_block % GEO.d  # the shard of its head
        vs.volume_ec_shards_delete(1, shard_ids=[first])
        rs_cuda.reset_launches()
        r = requests.get(f"http://{vs.url}/{fid}", timeout=60)
        torch.cuda.synchronize()
        assert (r.status_code, r.content) == (200, body)
        assert rs_cuda.launches_by_entry.get("reconstruct", 0) >= 1
        assert vs.read_stats["reconstructs"] >= 1
    finally:
        vs.stop()


@pytest.mark.gpu
def test_cluster_of_the_port_on_card(cuda, tmp_path):
    """A small cluster of the port on the card (tests/torch_cluster.py):
    the master, four volume servers in racks r1-r4 and the shell run
    ec.encode (K1 encode), lose rack r1, read degraded (K1 reconstruct),
    repair through the admin cron, scrub (K3) and decode."""
    import torch_cluster as tc

    c = tc.start(tmp_path, device="cuda")
    try:
        rs_cuda.reset_launches()
        crc_cuda.reset_launches()
        tc.write_and_encode(c)
        tc.lose_rack_and_repair(c)
        tc.scrub(c)
        tc.decode(c)
        torch.cuda.synchronize()
        k1 = dict(rs_cuda.launches_by_entry)
        # one generate batch encodes both volumes through one stream
        assert k1.get("encode", 0) >= 1, k1
        assert k1.get("reconstruct", 0) >= 1, k1
        assert crc_cuda.launches >= 1
    finally:
        tc.stop(c)


@pytest.mark.gpu
def test_crashsim_ec_seal_on_card(cuda):
    """crashsim's ec-seal scenario with its coder on the card: the
    streaming encode runs through K1, and every crash state of its seal
    recovers clean."""
    from seaweedfs_tpu_torch.devtools import crashsim
    sc = next(s for s in crashsim.scenarios("cuda") if s.name == "ec-seal")
    before = rs_cuda.launches_by_entry.get("encode", 0)
    rep = crashsim.run_scenario(sc, seed=0, max_states=2000)
    assert rs_cuda.launches_by_entry.get("encode", 0) > before
    assert rep["violations"] == [] and rep["states"] >= 500
