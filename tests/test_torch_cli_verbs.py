"""The port's verbs of the client and the volume tools, run as
``python -m seaweedfs_tpu_torch <verb>``: upload and download round-trip
files byte for byte through a cluster of the port alone
(tests/torch_cluster.py, device="cpu"); benchmark writes and reads a small
set; fix's .idx, export's files and compact's .dat/.idx equal what the JAX
package's verbs make of a copy of the same volume; version prints the
reference's version after the port's name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu import __main__ as ref_main
from seaweedfs_tpu import __version__ as ref_version
from seaweedfs_tpu.storage.volume import rebuild_idx_from_dat as ref_fix
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VID = 5


def _verb(*args, timeout=120):
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=REPO)
    assert r.returncode == 0, (args, r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture
def volume_pair(tmp_path):
    """One port volume with named, plain and deleted needles, and a copy
    of its files: (port dir, reference dir)."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(21)
    v = Volume(str(src), "", VID)
    for k in range(1, 41):
        v.write_needle(Needle(
            id=k, cookie=int(rng.integers(1, 1 << 32)),
            data=rng.bytes(int(rng.integers(1, 3000))),
            name=f"file-{k}.bin".encode() if k % 3 else b""))
    for k in (4, 9, 17, 33):
        v.delete_needle(k)
    v.sync()
    v.close()
    dirs = tmp_path / "port", tmp_path / "ref"
    for d in dirs:
        shutil.copytree(src, d)
    return dirs


def test_version_prints_the_references_version():
    assert _verb("version").strip() == f"seaweedfs-tpu-torch {ref_version}"
    from seaweedfs_tpu_torch import __version__
    assert __version__ == ref_version


def test_usage_lists_the_new_verbs():
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch"],
                       capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode == 2
    for verb in ("upload", "download", "benchmark", "backup",
                 "master.follow", "export", "compact", "version", "fix"):
        assert verb in r.stderr


def test_fix_rebuilds_the_idx_like_reference(volume_pair):
    port_dir, ref_dir = volume_pair
    for d in volume_pair:
        os.unlink(str(d / f"{VID}.idx"))
    out = _verb("fix", str(port_dir / f"{VID}.dat"))
    n = ref_fix(str(ref_dir / f"{VID}.dat"), str(ref_dir / f"{VID}.idx"))
    assert out.strip() == f"wrote {n} entries to {port_dir / f'{VID}.idx'}"
    assert _sha(str(port_dir / f"{VID}.idx")) == \
        _sha(str(ref_dir / f"{VID}.idx"))
    v = Volume(str(port_dir), "", VID, create_if_missing=False)
    try:
        assert v.read_needle(2, cookie=None).name == b"file-2.bin"
        with pytest.raises(KeyError):
            v.read_needle(4, cookie=None)
    finally:
        v.close()


def test_export_writes_the_references_files(volume_pair, tmp_path,
                                            capsys):
    port_dir, ref_dir = volume_pair
    outs = tmp_path / "out_port", tmp_path / "out_ref"
    said = _verb("export", "-dir", str(port_dir), "-volumeId", str(VID),
                 "-o", str(outs[0]))
    ref_main.run_export(["-dir", str(ref_dir), "-volumeId", str(VID),
                         "-o", str(outs[1])])
    assert said.strip() == capsys.readouterr().out.strip().replace(
        str(outs[1]), str(outs[0]))
    files = [{f: _sha(str(o / f)) for f in sorted(os.listdir(o))}
             for o in outs]
    assert files[0] == files[1] and len(files[0]) == 36


def test_compact_equals_reference(volume_pair, capsys):
    port_dir, ref_dir = volume_pair
    said = _verb("compact", "-dir", str(port_dir), "-volumeId", str(VID))
    ref_main.run_compact(["-dir", str(ref_dir), "-volumeId", str(VID)])
    assert said == capsys.readouterr().out
    for ext in (".dat", ".idx"):
        assert _sha(str(port_dir / f"{VID}{ext}")) == \
            _sha(str(ref_dir / f"{VID}{ext}")), ext


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("cli"), device="cpu")
    try:
        yield c
    finally:
        tc.stop(c)


def test_upload_then_download_round_trip(cluster, tmp_path):
    rng = np.random.default_rng(22)
    paths = []
    for i, ext in enumerate((".bin", ".txt", ".json")):
        p = tmp_path / f"in{i}{ext}"
        p.write_bytes(rng.bytes(int(rng.integers(100, 20000))))
        paths.append(p)
    master = cluster["master"].address
    lines = _verb("upload", "-master", master, "-collection", "cli",
                  *map(str, paths)).splitlines()
    docs = [json.loads(x) for x in lines]
    assert [d["file"] for d in docs] == [str(p) for p in paths]
    assert [d["size"] for d in docs] == [p.stat().st_size for p in paths]
    for d, p in zip(docs, paths):
        out = tmp_path / f"got-{p.name}"
        said = _verb("download", "-master", master, "-o", str(out),
                     d["fid"])
        assert said.strip() == f"{d['fid']} -> {out} ({p.stat().st_size} bytes)"
        assert out.read_bytes() == p.read_bytes()


def test_benchmark_writes_and_reads(cluster):
    out = _verb("benchmark", "-master", cluster["master"].address,
                "-n", "64", "-size", "256", "-c", "4")
    assert "writing 64 x 256B files, concurrency 4, per-needle" in out
    assert "write:" in out and "read:" in out and "errors 0" in out
    for line in out.splitlines():
        if line.strip().startswith(("write:", "read:")):
            assert float(line.split()[1]) > 0


def test_client_verbs_of_chip_smoke_on_cpu(cluster, tmp_path):
    """Phase 17(h)-(j) of chip_smoke.py on the CPU cluster at a small
    size: upload/download round trips, backup of the damaged regular
    volume sha256-equal to its holder's files, benchmark -n 64."""
    import chip_smoke
    res = chip_smoke.client_verbs(np, str(tmp_path), 5, "cpu",
                                  cluster["master"].address,
                                  cluster["dirs"]["r4"], tc.SCRUB_VID,
                                  "scrub", 64)
    assert res["bench_write"][0] > 0 and res["bench_read"][0] > 0
