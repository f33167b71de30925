"""The port's entry point and pipeline forward against the JAX package's,
its import hygiene (no jax, nothing of seaweedfs_tpu, no aiohttp; the
filer server without torch), its refusal to fall back to the CPU on its
own, and its command line: the volume, master, server (with -filer) and
shell verbs."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from seaweedfs_tpu.models.ec_pipeline import ECPipeline as RefPipeline
from seaweedfs_tpu_torch import entry as port_entry
from seaweedfs_tpu_torch.devtools import crashsim
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
print("CONTROL", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                     for m in ("master.sequencer", "master.topology",
                               "master.volume_layout", "master.volume_growth",
                               "master.lease", "master.health",
                               "master.admin_cron", "master.master_server",
                               "geo.policy", "placement", "placement.engine",
                               "placement.plan", "placement.executor",
                               "maintenance", "maintenance.planner",
                               "maintenance.executor", "client.master_client",
                               "shell.commands", "shell.health_util",
                               "shell.ec_commands", "shell.volume_commands")))
print("PLANES", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                    for m in ("master.raft", "master.follower",
                              "telemetry.tsdb", "telemetry.merge",
                              "telemetry.slo", "telemetry.collector",
                              "lifecycle", "lifecycle.policy",
                              "lifecycle.planner", "lifecycle.executor",
                              "shell.lifecycle_commands",
                              "shell.telemetry_commands",
                              "shell.qos_commands")))
print("DATA", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                  for m in ("client.operation", "client.backup", "bench_tool",
                            "utils.fstrack", "devtools", "devtools.crashsim",
                            "devtools.swtpu_lint")))
print("FILER", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                   for m in ("filer", "filer.chunks", "filer.store",
                             "filer.sql_store", "filer.meta_log",
                             "filer.filer", "filer.filer_conf",
                             "filer.chunk_cache", "filer.meta_aggregator",
                             "filer.filer_server", "client.filer_client",
                             "shell.fs_commands", "security.cipher",
                             "pb.filer_pb2", "pb.mq_pb2")))
print("S3", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                for m in ("s3", "s3.auth", "s3.chunked", "s3.circuit_breaker",
                          "s3.s3_server", "iam", "iam.iam_server",
                          "pb.s3_pb2", "pb.iam_pb2")))
print("MOUNTS", all(f"seaweedfs_tpu_torch.{m}" in sys.modules
                    for m in ("mount", "mount.control", "mount.fuse_binding",
                              "mount.inode_map", "mount.meta_cache",
                              "mount.page_writer", "mount.weedfs", "ftpd",
                              "ftpd.ftp_server", "remote.remote_mount",
                              "shell.remote_commands", "utils.scaffold",
                              "pb.build", "pb.mount_pb2", "pb.remote_pb2")))
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
    assert "CONTROL True" in out.stdout, out.stdout
    assert "PLANES True" in out.stdout, out.stdout
    assert "DATA True" in out.stdout, out.stdout
    assert "FILER True" in out.stdout, out.stdout
    assert "S3 True" in out.stdout, out.stdout
    assert "MOUNTS True" in out.stdout, out.stdout
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
                 lambda: port_entry.dryrun_multichip(1),
                 lambda: crashsim.run_matrix(["ec-seal"], max_states=10)):
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


_FILER_HYGIENE = r"""
import sys
sys.modules["jax"] = None
import seaweedfs_tpu_torch.filer.filer_server
import seaweedfs_tpu_torch.client.filer_client
import seaweedfs_tpu_torch.shell.fs_commands
import seaweedfs_tpu_torch.security.cipher
import seaweedfs_tpu_torch.__main__
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("torch", "seaweedfs_tpu", "aiohttp",
                                    "cryptography")
             or (n.startswith("jax") and sys.modules[n] is not None))
print("BAD", bad)
"""


def test_filer_server_loads_no_torch():
    """The filer does no device work: its server, client, fs commands,
    cipher and the CLI load no torch (nor jax, the JAX package, aiohttp,
    or cryptography before a chunk is sealed), so `filer` starts without
    loading CUDA, as the `upload`/`download` verbs do."""
    out = subprocess.run([sys.executable, "-c", _FILER_HYGIENE],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(_repo_root()))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


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


def _cli(*args, timeout=120):
    return subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(_repo_root()))


def test_master_verb_help_lists_the_reference_flags():
    out = _cli("master", "-h")
    assert out.returncode == 0, out.stderr
    for flag in ("-httpPort", "-volumeSizeLimitMB", "-peers",
                 "-maintenanceScripts", "-maintenanceIntervalS",
                 "-maintenanceHealthDriven", "-ecParityShards", "-ecShards",
                 "-lifecyclePolicy", "-sloPolicy", "-telemetryIntervalS",
                 "-linkCosts", "-jwtSigningKey", "-whiteList"):
        assert flag in out.stdout, flag


def test_shell_help_lists_exactly_the_ported_commands():
    """`shell -c help` lists the reference's lock, volume.*, ec.*, fs.*
    (fs.meta.notify included), s3.*, lifecycle.*, mq.*, qos.*, remote.*,
    mount.configure, cluster.check and cluster.top/profile commands (those
    of its commands, ec_commands, volume_commands, fs_commands,
    lifecycle_commands, mq_commands, qos_commands, remote_commands and
    telemetry_commands modules): every command of the reference's shell."""
    from seaweedfs_tpu.shell import commands as ref_commands
    from seaweedfs_tpu.shell import (ec_commands, fs_commands,  # noqa: F401
                                     lifecycle_commands, mq_commands,
                                     qos_commands, remote_commands,
                                     telemetry_commands, volume_commands)
    ported = {"seaweedfs_tpu.shell.commands", "seaweedfs_tpu.shell.ec_commands",
              "seaweedfs_tpu.shell.volume_commands",
              "seaweedfs_tpu.shell.fs_commands",
              "seaweedfs_tpu.shell.lifecycle_commands",
              "seaweedfs_tpu.shell.mq_commands",
              "seaweedfs_tpu.shell.qos_commands",
              "seaweedfs_tpu.shell.remote_commands",
              "seaweedfs_tpu.shell.telemetry_commands"}
    want = sorted(name for name, c in ref_commands.COMMANDS.items()
                  if c.fn.__module__ in ported)
    out = _cli("shell", "-master", "127.0.0.1:1", "-c", "help")
    assert out.returncode == 0, out.stderr
    got = [line.split()[0] for line in out.stdout.splitlines()
           if line.startswith("  ")]
    assert got == want
    assert {"lock", "unlock", "ec.encode", "ec.rebuild", "ec.decode",
            "volume.scrub", "lifecycle.apply", "lifecycle.status",
            "qos.status", "cluster.top", "cluster.profile", "cluster.check",
            "fs.ls", "fs.verify", "volume.fsck", "s3.bucket.list",
            "s3.bucket.quota.check", "s3.configure",
            "s3.circuitbreaker", "fs.meta.notify", "mq.topic.list",
            "mq.topic.desc", "mq.topic.describe", "mq.topic.configure",
            "mq.balance", "remote.mount", "remote.unmount", "remote.cache",
            "remote.uncache", "remote.configure", "remote.meta.sync",
            "remote.mount.buckets", "mount.configure"} <= set(got)
    assert set(got) == {name for name, c in ref_commands.COMMANDS.items()
                        if c.fn.__module__.startswith(
                            "seaweedfs_tpu.shell.")}


@pytest.mark.parametrize("flag,waits", [
    ("-s3", "ROADMAP Queue 1 item 4, S3 and IAM"),
    ("-webdav", "ROADMAP Queue 1 item 5, WebDAV"),
    ("-iam", "ROADMAP Queue 1 item 4, S3 and IAM")])
def test_server_verb_refuses_the_gateways(tmp_path, flag, waits):
    """`server` runs a filer with -filer; the gateways (the slices `waits`
    names, now ported) start with the filer they imply and serve: the S3
    gateway answers ListBuckets, the IAM API ListUsers, WebDAV a PROPFIND
    of the root; the process stops on SIGTERM with rc 0. None refuses
    any more."""
    import time

    from seaweedfs_tpu_torch.client import http_util

    from torch_cluster import free_port_pair
    assert "S3 and IAM" in waits or "WebDAV" in waits
    port, vport, fport, gport = (free_port_pair() for _ in range(4))
    port_flag = {"-s3": "-s3Port", "-iam": "-iamPort",
                 "-webdav": "-webdavPort"}[flag]
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-device",
         "cpu", "-dir", str(tmp_path), "-port", str(port), "-volumePort",
         str(vport), "-filerPort", str(fport), flag, port_flag, str(gport)],
        cwd=str(_repo_root()), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                if flag == "-s3":
                    r = http_util.request("GET", f"http://127.0.0.1:{gport}/",
                                          max_attempts=1)
                elif flag == "-webdav":
                    r = http_util.request(
                        "PROPFIND", f"http://127.0.0.1:{gport}/",
                        headers={"Depth": "0"}, max_attempts=1)
                    if r.status == 207:
                        break
                else:
                    r = http_util.request(
                        "POST", f"http://127.0.0.1:{gport}/",
                        body=b"Action=ListUsers", max_attempts=1,
                        headers={"Content-Type":
                                 "application/x-www-form-urlencoded"})
                if r.status == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "no gateway answer in 90 s"
            time.sleep(0.3)
        want = {"-s3": b"ListAllMyBucketsResult", "-iam": b"ListUsersResponse",
                "-webdav": b"<D:collection />"}[flag]
        assert want in r.content
        r = http_util.get(f"http://127.0.0.1:{fport}/__status__")
        assert r.status == 200
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0].decode()
    assert proc.returncode == 0, out
    assert f"{flag[1:]} 127.0.0.1:{gport}" in out


_S3_HYGIENE = r"""
import sys
sys.modules["jax"] = None
import seaweedfs_tpu_torch.s3, seaweedfs_tpu_torch.s3.s3_server
import seaweedfs_tpu_torch.s3.chunked, seaweedfs_tpu_torch.s3.circuit_breaker
import seaweedfs_tpu_torch.iam, seaweedfs_tpu_torch.iam.iam_server
print("LOADED", sorted(n for n in sys.modules
                       if n.split(".")[0] in ("torch", "jax", "seaweedfs_tpu",
                                              "aiohttp")
                       and sys.modules[n] is not None))
"""


def test_s3_and_iam_import_no_torch_no_jax_no_reference():
    """Importing the port's S3 gateway and IAM API (and what they import:
    the filer, fastweb, qos) loads no torch, no jax, no aiohttp and
    nothing of the JAX package."""
    out = subprocess.run([sys.executable, "-c", _S3_HYGIENE],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(_repo_root()))
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_server_verb_runs_a_filer(tmp_path):
    """`server -filer -device cpu`: a master, a volume server and a filer
    in one process; a file PUT through the filer reads back, and the
    filer keeps its sqlite store and meta log under -dir/filer."""
    import os
    import time

    from seaweedfs_tpu_torch.client import http_util

    from torch_cluster import free_port_pair
    port, vport, fport = free_port_pair(), free_port_pair(), free_port_pair()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-device",
         "cpu", "-dir", str(tmp_path), "-port", str(port), "-volumePort",
         str(vport), "-filer", "-filerPort", str(fport)],
        cwd=str(_repo_root()), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    body = np.random.default_rng(8).bytes(300_000)
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                r = http_util.request(
                    "PUT", f"http://127.0.0.1:{fport}/s/one.bin", body=body,
                    max_attempts=1)
                if r.status == 201:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "no filer write in 90 s"
            time.sleep(0.3)
        r = http_util.get(f"http://127.0.0.1:{fport}/s/one.bin")
        assert (r.status, r.content) == (200, body)
        assert os.path.exists(tmp_path / "filer" / "filer.db")
        assert os.path.getsize(tmp_path / "filer" / "meta.log") > 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == 0


@pytest.mark.parametrize("flags,needs", [
    (["-peers", "127.0.0.1:9333,127.0.0.1:9334"], "master/raft.py"),
    (["-sloPolicy", '{"objectives": []}'], "telemetry/"),
    (["-lifecyclePolicy", "policy.json"], "lifecycle/")])
def test_master_verb_refuses_unported_options(tmp_path, flags, needs):
    """The verb takes the options it once refused: the master starts,
    reports each through its HTTP API (the raft role, /cluster/telemetry,
    /debug/lifecycle) and stops on SIGTERM with rc 0. The quorum of two
    unreachable peers elects no one."""
    import json
    import time
    import urllib.error
    import urllib.request

    from conftest import free_port_pair
    port, hport = free_port_pair(), free_port_pair()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "master", "-port",
         str(port), "-httpPort", str(hport), "-raftDir", str(tmp_path),
         *flags], cwd=str(_repo_root()), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{hport}{path}",
                                        timeout=5) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                status, st = get("/cluster/status")
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.2)
        if needs == "master/raft.py":
            time.sleep(1.0)  # past two election timeouts
            status, st = get("/cluster/status")
            assert (status, st["IsLeader"], st["leader"]) == (200, False, "")
            assert st["Peers"] == flags[1].split(",")
            assert get("/cluster/telemetry")[0] == 421
            assert (tmp_path / f"raft-{port}.json").exists()
        elif needs == "telemetry/":
            status, snap = get("/cluster/telemetry?trigger=1")
            assert status == 200 and snap["leader"] and snap["cycles"] >= 1
        else:
            status, doc = get("/debug/lifecycle")
            assert status == 200 and doc["source"] == "policy.json"
            assert "policy.json" in doc["policy_error"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == 0, proc.stdout.read().decode()


def test_server_verb_and_shell_make_a_cluster_of_the_port(tmp_path):
    """`server -device cpu` starts a master and a volume server in one
    process; the port's shell, another process, sees the server in
    volume.list and takes and gives back the admin lock."""
    import time

    from conftest import free_port_pair
    mport, vport = free_port_pair(), free_port_pair()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-port",
         str(mport), "-volumePort", str(vport), "-dir", str(tmp_path),
         "-device", "cpu"], cwd=str(_repo_root()), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            out = _cli("shell", "-master", f"127.0.0.1:{mport}", "-c",
                       "lock; volume.list; unlock")
            if f"DataNode 127.0.0.1:{vport}" in out.stdout:
                break
            assert time.monotonic() < deadline, (out.stdout, out.stderr)
            time.sleep(0.5)
        assert out.returncode == 0, out.stderr
    finally:
        proc.terminate()
        proc.wait(timeout=15)


_REPLICATION_HYGIENE = r"""
import sys
sys.modules["jax"] = None
import seaweedfs_tpu_torch.webdav, seaweedfs_tpu_torch.webdav.webdav_server
import seaweedfs_tpu_torch.replication, seaweedfs_tpu_torch.geo.replication
import seaweedfs_tpu_torch.replication.sink
import seaweedfs_tpu_torch.filer.redis_store, seaweedfs_tpu_torch.filer.mongo_store
import seaweedfs_tpu_torch.filer.etcd_store
import seaweedfs_tpu_torch.utils.mini_redis, seaweedfs_tpu_torch.utils.mini_mongo
import seaweedfs_tpu_torch.utils.mini_etcd, seaweedfs_tpu_torch.utils.bson_lite
from seaweedfs_tpu_torch.remote.azure import AzureSink
from seaweedfs_tpu_torch.remote.gcs import GcsSink
print("LOADED", sorted(n for n in sys.modules
                       if n.split(".")[0] in ("torch", "jax", "seaweedfs_tpu",
                                              "aiohttp", "requests")
                       and sys.modules[n] is not None))
"""


def test_webdav_replication_and_stores_import_no_torch_no_jax_no_reference():
    """Importing the port's WebDAV gateway, the replication plane with
    GeoSync and the cloud sinks, the redis, mongo and etcd stores and
    their stand-ins loads no torch, no jax, no aiohttp, no requests and
    nothing of the JAX package."""
    out = subprocess.run([sys.executable, "-c", _REPLICATION_HYGIENE],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(_repo_root()))
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


_QUEUE_HYGIENE = r"""
import sys
sys.modules["jax"] = None
import seaweedfs_tpu_torch.mq, seaweedfs_tpu_torch.mq.broker
import seaweedfs_tpu_torch.mq.client, seaweedfs_tpu_torch.mq.consumer
import seaweedfs_tpu_torch.mq.schema, seaweedfs_tpu_torch.mq.sub_coordinator
import seaweedfs_tpu_torch.mq.topic, seaweedfs_tpu_torch.pb.mq_schema_pb2
import seaweedfs_tpu_torch.notification.queues
import seaweedfs_tpu_torch.notification.kafka
import seaweedfs_tpu_torch.utils.mini_kafka
import seaweedfs_tpu_torch.shell.mq_commands
import seaweedfs_tpu_torch.shell.fs_commands
from seaweedfs_tpu_torch.__main__ import run_filer_replicate, run_mq_broker
print("LOADED", sorted(n for n in sys.modules
                       if n.split(".")[0] in ("torch", "jax", "seaweedfs_tpu",
                                              "aiohttp", "requests")
                       and sys.modules[n] is not None))
"""


def test_mq_and_notification_import_no_torch_no_jax_no_reference():
    """Importing the port's message queue (broker, clients, consumer
    groups, schema, mq_schema_pb2, the mq.* commands), its notification
    queues with the Kafka wire and MiniKafka, and the verbs mq.broker and
    filer.replicate loads no torch, no jax, no aiohttp, no requests and
    nothing of the JAX package."""
    out = subprocess.run([sys.executable, "-c", _QUEUE_HYGIENE],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(_repo_root()))
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_mq_schema_pb2_is_the_references_descriptor():
    """pb/mq_schema.proto and its pb2 are byte-equal copies: the same
    serialized file descriptor, so records cross packages as bytes."""
    from seaweedfs_tpu.pb import mq_schema_pb2 as ref_spb
    from seaweedfs_tpu_torch.pb import mq_schema_pb2 as spb
    assert spb.DESCRIPTOR.serialized_pb == ref_spb.DESCRIPTOR.serialized_pb
    root = _repo_root()
    for name in ("mq_schema.proto", "mq_schema_pb2.py"):
        assert (root / "seaweedfs_tpu_torch/pb" / name).read_bytes() == \
            (root / "seaweedfs_tpu/pb" / name).read_bytes()


@pytest.mark.parametrize("verb", ["webdav", "filer.backup", "filer.sync",
                                  "geo.sync"])
def test_replication_verbs_take_the_references_flags(verb):
    """Each new verb's flags are the reference's (its -h lists them)."""
    flags = {"webdav": ("-filer", "-ip", "-port"),
             "filer.backup": ("-filer", "-dir", "-path"),
             "filer.sync": ("-a", "-b", "-isActivePassive", "-path"),
             "geo.sync": ("-a", "-b", "-isActivePassive", "-path", "-peerA",
                          "-peerB", "-linkCosts", "-lagBound")}[verb]
    out = _cli(verb, "-h")
    assert out.returncode == 0, out.stderr
    for flag in flags:
        assert flag in out.stdout
