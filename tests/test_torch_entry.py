"""The port's entry point and pipeline forward against the JAX package's,
its import hygiene (no jax, nothing of seaweedfs_tpu), and its refusal to
fall back to the CPU on its own."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from seaweedfs_tpu.models.ec_pipeline import ECPipeline as RefPipeline
from seaweedfs_tpu_torch import entry as port_entry
from seaweedfs_tpu_torch.models.ec_pipeline import ECPipeline
from seaweedfs_tpu_torch.ops import coder


def test_entry_forward_matches_jax_entry():
    ref_fn, (ref_data,) = __graft_entry__.entry()
    fn, (data,) = port_entry.entry(device="cpu")
    np.testing.assert_array_equal(data, ref_data)
    got = fn(data)
    assert got.device.type == "cpu" and tuple(got.shape) == (8, 4, 65536)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_fn(ref_data)))


@pytest.mark.parametrize("d,p", [(14, 2), (5, 3)])
def test_pipeline_forward_matches_jax(d, p):
    data = np.random.default_rng(d).integers(0, 256, (2, d, 384), np.uint8)
    want = np.asarray(RefPipeline(d=d, p=p).forward(data))
    got = ECPipeline(d=d, p=p, device="cpu").forward(torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want)


_HYGIENE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import seaweedfs_tpu_torch
for m in pkgutil.walk_packages(seaweedfs_tpu_torch.__path__, "seaweedfs_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "seaweedfs_tpu" or n.startswith("seaweedfs_tpu.")
             or (n.startswith("jax") and sys.modules[n] is not None)
             or n.split(".")[0] == "aiohttp")
print("LOADED", len([n for n in sys.modules if n.startswith("seaweedfs_tpu_torch")]))
print("TIER", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                  for m in ("storage.backend", "storage.vacuum", "s3.auth",
                            "storage.bulk", "client.http_util",
                            "security.jwt", "security.guard")))
print("MESH", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                  for m in ("parallel.mesh", "parallel.pipeline",
                            "parallel.launch", "ops.native", "stats.metrics",
                            "stats.parse", "stats.expo_lint", "tracing.trace",
                            "utils.profiling")))
from seaweedfs_tpu_torch.ops import coder
print("MAINT", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                   for m in ("qos", "qos.policy", "qos.scheduler", "query",
                             "query.json_query", "query.csv_query",
                             "utils.config")))
print("REST", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                  for m in ("profiling", "profiling.flight", "profiling.lag",
                            "profiling.sampler", "telemetry",
                            "telemetry.topk", "telemetry.hot",
                            "utils.locktrack", "utils.ui", "images",
                            "images.resize", "remote", "remote.azure",
                            "remote.gcs", "utils.mini_azure",
                            "utils.mini_gcs", "storage.ref_format")))
print("CODERS", sorted(n for n in ("mesh", "native") if coder._resolve(n)))
print("BAD", bad)
"""


def test_import_hygiene_no_jax_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _HYGIENE], capture_output=True,
                         text=True, timeout=120, cwd=str(_repo_root()))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "TIER True" in out.stdout, out.stdout
    assert "MESH True" in out.stdout, out.stdout
    assert "MAINT True" in out.stdout, out.stdout
    assert "REST True" in out.stdout, out.stdout
    assert "CODERS ['mesh', 'native']" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED ")[1].split()[0]) >= 15


def _repo_root():
    from pathlib import Path
    return Path(__file__).resolve().parent.parent


def test_dryrun_multichip_on_four_cpu_ranks():
    """The port's dryrun_multichip launches 4 gloo ranks (a 1x4 mesh, the
    reference's build_mesh(4)): the step rebuilds exactly, the mesh scrub
    is clean and every rank's MeshCoder shard files equal NumpyCoder's.
    Its inputs are the reference dryrun's, from the same seed; the step's
    byte count is the JAX step's on them."""
    reports = port_entry.dryrun_multichip(4, device="cpu", timeout=240)
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    for r in reports:
        assert r["mesh"] == {"data": 1, "shard": 4} and r["device"] == "cpu"
        assert (r["rebuild_mismatch_bytes"], r["scrub_bad"], r["volumes"]) == (0, 0, 3)
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax
    from seaweedfs_tpu.parallel.mesh import build_mesh
    mesh = build_mesh(4)
    data = np.random.default_rng(1).integers(0, 256, (2, 10, 512), np.uint8)
    out = jax.jit(RefPipeline(d=10, p=4, mesh=mesh).step, static_argnums=(1,))(
        jax.device_put(data, NamedSharding(mesh, P("data", None, None))),
        (0, 5, 10, 13))
    assert int(np.asarray(out["bytes_encoded"])) == reports[0]["bytes_encoded"]


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: coder.TorchCoder(10, 4),
                 lambda: coder.get_coder("torch", 10, 4),
                 lambda: ECPipeline(),
                 lambda: port_entry.entry(),
                 lambda: port_entry.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # the explicit CPU device is the only way to the plain version
    c = coder.TorchCoder(10, 4, device="cpu")
    assert c.device.type == "cpu" and c.async_dispatch


_CORE_HYGIENE = r"""
import sys
import seaweedfs_tpu_torch.server.volume_server
import seaweedfs_tpu_torch.utils.retry, seaweedfs_tpu_torch.utils.fastweb
import seaweedfs_tpu_torch.ops.events, seaweedfs_tpu_torch.storage.bulk
import seaweedfs_tpu_torch.client.http_util, seaweedfs_tpu_torch.security
import seaweedfs_tpu_torch.qos, seaweedfs_tpu_torch.query
import seaweedfs_tpu_torch.utils.config
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("grpc", "jax", "seaweedfs_tpu", "aiohttp")
             or n.startswith("google.protobuf"))
print("BAD", bad)
"""


def test_volume_server_core_loads_no_grpc_protobuf_jax_or_reference():
    """The server core, and the retry, fastweb, events, bulk-frame,
    http_util, security, qos, query and config copies it uses, run where
    there is no grpcio or protobuf: only the gRPC binding (server/grpc_service.py),
    utils/rpc.py and pb/ import them. None imports aiohttp."""
    out = subprocess.run([sys.executable, "-c", _CORE_HYGIENE],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(_repo_root()))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


_NO_CARD_CLI = r"""
import sys, torch
torch.cuda.is_available = lambda: False
from seaweedfs_tpu_torch.__main__ import main
sys.exit(main(sys.argv[1:]))
"""


@pytest.mark.parametrize("flags,refused", [
    ([], "CUDA is not available"),
    (["-device", "auto"], "invalid choice"),
    (["-coder", "numpy"], "invalid choice")])
def test_volume_verb_refuses_without_a_card(tmp_path, flags, refused):
    """`python -m seaweedfs_tpu_torch volume` runs on the card unless
    `-device cpu` is asked for: with no card it exits non-zero before
    serving; -device and -coder take no automatic choice."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_CARD_CLI, "volume", "-dir", str(tmp_path),
         "-port", "1", "-mserver", "127.0.0.1:1", *flags],
        capture_output=True, text=True, timeout=120, cwd=str(_repo_root()))
    assert out.returncode != 0
    assert refused in out.stderr, out.stderr


def test_volume_verb_takes_the_index_flag(tmp_path):
    """`python -m seaweedfs_tpu_torch volume -index sorted_file` hands the
    needle-map kind to its DiskLocation, as the reference's -index does: a
    volume written beforehand loads through a sorted-file map (its .sdx
    sidecar appears) and serves its needles."""
    import os
    import time

    import requests

    from conftest import free_port_pair
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.types import file_id
    store = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path))],
                  coder_name="torch", device="cpu")
    store.add_volume(6)
    body = b"read through a sorted-file needle map" * 30
    store.find_volume(6).write_needle(Needle(id=9, cookie=0xC0DE, data=body))
    store.close()
    assert not os.path.exists(tmp_path / "6.sdx")
    port = free_port_pair()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume", "-dir",
         str(tmp_path), "-port", str(port), "-mserver",
         f"127.0.0.1:{free_port_pair()}", "-device", "cpu",
         "-index", "sorted_file"],
        cwd=str(_repo_root()), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                r = requests.get(f"http://127.0.0.1:{port}/"
                                 f"{file_id(6, 9, 0xC0DE)}", timeout=5)
                break
            except requests.ConnectionError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert (r.status_code, r.content) == (200, body)
        assert os.path.getsize(tmp_path / "6.sdx") > 0
    finally:
        proc.terminate()
        proc.wait(timeout=15)
