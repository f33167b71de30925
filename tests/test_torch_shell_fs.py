"""The port's fs.* commands, volume.fsck and cluster.check
(seaweedfs_tpu_torch/shell/fs_commands.py, volume_commands.py) against the
JAX package's: each line runs through the JAX shell and then through the
port's shell against the same port filer over a cluster of the port on the
CPU, and both print the same once fids, timestamps and timings are masked.
Lines that change the namespace come in sequences that put it back, so
both shells start each sequence from the same state."""

import io
import re

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu.client.master_client import MasterClient as RefMC
from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu.shell import fs_commands as ref_fs  # noqa: F401
from seaweedfs_tpu.shell import volume_commands as ref_vol  # noqa: F401
from seaweedfs_tpu_torch.client import http_util
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.shell import commands as port_commands
from seaweedfs_tpu_torch.shell import fs_commands  # noqa: F401
from seaweedfs_tpu_torch.shell import volume_commands  # noqa: F401

MiB = 1 << 20


@pytest.fixture(scope="module")
def shells(tmp_path_factory):
    root = tmp_path_factory.mktemp("shell-fs")
    c = tc.start(root, volume_size_limit_mb=64)
    fs = FilerServer(c["master"].address, store_spec="memory",
                     port=tc.free_port_pair(), chunk_size_mb=1,
                     meta_log_path=str(root / "meta.log")).start()
    ref_mc = RefMC(c["master"].address).start()
    ref_mc.wait_connected(10)
    envs = {"ref": ref_commands.CommandEnv(c["master"].address, mc=ref_mc,
                                           out=io.StringIO()),
            "port": port_commands.CommandEnv(c["master"].address, mc=c["mc"],
                                             out=io.StringIO())}
    for env in envs.values():
        env.option["filer"] = fs.url
    rng = np.random.default_rng(31)
    base = f"http://{fs.url}"
    for path, data in (("/t/a.txt", b"some text\n" * 40),
                       ("/t/b.bin", rng.bytes(2 * MiB + 5)),
                       ("/t/e.json", b'{"k": 2}'),
                       ("/t/d/x.bin", rng.bytes(5000)),
                       ("/t/d/y.bin", rng.bytes(MiB)),
                       ("/u/z.bin", rng.bytes(100))):
        r = http_util.request("PUT", base + path, body=data)
        assert r.status == 201, r.content
    for served in c["served"].values():
        served.vs.heartbeat_flush()
    yield {"envs": envs, "fs": fs, "c": c, "root": root}
    ref_mc.stop()
    fs.stop()
    tc.stop(c)


_MASKS = ((re.compile(r"\b\d+,[0-9a-f]{9,}\b"), "<fid>"),
          (re.compile(r"\b1[0-9]{18}\b"), "<ts>"),
          (re.compile(r"\b1[0-9]{9}\b"), "<secs>"),
          (re.compile(r"in [0-9.]+s"), "in <t>s"),
          (re.compile(r"[0-9,]+ needles/s"), "<rate> needles/s"),
          (re.compile(r'file_id: "[^"]*"'), 'file_id: "<fid>"'),
          (re.compile(r"(cookie|fid_cookie|signatures): \d+"), r"\1: <n>"))


def _mask(text: str) -> str:
    for pat, sub in _MASKS:
        text = pat.sub(sub, text)
    return text


def _run(env, lines) -> str:
    env.out = io.StringIO()
    mod = (port_commands if isinstance(env, port_commands.CommandEnv)
           else ref_commands)
    for line in lines:
        try:
            mod.run_command(env, line)
        except Exception as e:  # noqa: BLE001 — an error is output too
            env.println(f"error: {type(e).__name__}")
    return env.out.getvalue()


@pytest.mark.parametrize("lines", [
    ["fs.ls /t"],
    ["fs.ls -l /t", "fs.ls -l /t/d"],
    ["fs.cat /t/a.txt", "fs.cat /t/nope"],
    ["fs.du /t", "fs.du /"],
    ["fs.tree /", "fs.tree /t/d"],
    ["fs.meta.cat /t/b.bin", "fs.meta.cat /t/d"],
    ["fs.cd /t", "fs.pwd", "fs.ls", "fs.cat a.txt", "fs.cd d", "fs.ls -l",
     "fs.cd ..", "fs.cd a.txt", "fs.cd /", "fs.pwd"],
    ["fs.verify /t", "fs.verify"],
    ["fs.verify -scrub -device off /u"],
    ["volume.fsck", "volume.fsck -findOrphanData"],
    ["fs.mkdir /m", "fs.ls /", "fs.mkdir /m", "fs.rm /m", "fs.ls /"],
    ["fs.mv /t/a.txt /t/a2.txt", "fs.ls /t", "fs.mv /t/a2.txt /t/a.txt"],
    ["fs.mkdir /t/sub", "fs.mv /t/e.json /t/sub", "fs.tree /t",
     "fs.mv /t/sub/e.json /t", "fs.rm -r /t/sub", "fs.rm /t/sub"],
    ["fs.configure -locationPrefix /hot/ -collection hot -replication 001",
     "fs.configure -locationPrefix /hot/ -collection hot -fsync -apply",
     "fs.configure -locationPrefix /hot/ -delete -apply"],
    ["fs.merge.volumes -dir /t",
     "fs.meta.changeVolumeId -dir /t -fromVolumeId 999 -toVolumeId 998"],
    ["fs.log -limit 5 -pathPrefix /t", "fs.log -limit 3"],
    ["fs.log.purge -daysAgo 365"],
    ["cluster.check -failOn never"],
], ids=lambda lines: lines[0].split()[0] + f"-{len(lines)}")
def test_fs_commands_print_as_the_reference(shells, lines):
    out = {k: _run(shells["envs"][k], lines) for k in ("ref", "port")}
    assert _mask(out["port"]) == _mask(out["ref"])
    assert "unknown command" not in out["port"]
    assert "Traceback" not in out["port"]


def test_meta_save_and_load_equal_the_reference(shells, tmp_path):
    """fs.meta.save writes the same snapshot bytes through either shell,
    and fs.meta.load of it into the filer prints the same."""
    saved = {}
    for k in ("ref", "port"):
        out = _run(shells["envs"][k],
                   [f"fs.meta.save -o {tmp_path}/{k}.bin /t"])
        assert re.match(r"saved \d+ entries", out), out
        saved[k] = (tmp_path / f"{k}.bin").read_bytes()
    assert saved["port"] == saved["ref"] and saved["port"]
    loads = {k: _run(shells["envs"][k],
                     [f"fs.meta.load -i {tmp_path}/port.bin"])
             for k in ("ref", "port")}
    assert loads["port"].replace("port.bin", "X") == \
        loads["ref"].replace("port.bin", "X")


def test_cluster_check_pings_the_filer(shells):
    """cluster.check lists the filer the master knows and pings it over
    its advertised gRPC port, in both shells."""
    for k in ("ref", "port"):
        out = _run(shells["envs"][k], ["cluster.check -failOn never"])
        assert f"filer {shells['fs'].url}: ok" in out, out
        assert "4 volume servers healthy" in out
