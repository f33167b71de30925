"""The port's FTP gateway (seaweedfs_tpu_torch/ftpd/) driven by the
stdlib ftplib client, on the CPU.

The reference's cases (tests/test_ftp.py, 7), rewired to the port: its
FtpServer over a port FilerClient of a port filer on a cluster of the port
(tests/torch_cluster.py, device="cpu"). Then one seeded session through
the reference's gateway and the port's, each over its own package's filer:
every reply code and line, every listing (dates masked) and every byte
RETR returns equal. Exact comparisons; no tolerance applies.
"""

import ftplib
import io
import re

import numpy as np
import pytest

import torch_cluster as tc


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("ftp-cluster"),
                 volume_size_limit_mb=64)
    yield c
    tc.stop(c)


def _stack(cluster, filer_cls, client_cls, ftp_cls):
    fport = tc.free_port_pair()
    fs = filer_cls(cluster["master"].address, store_spec="memory",
                   port=fport, chunk_size_mb=1).start()
    fs.write_file("/pub/hello.txt", b"hello ftp world")
    fs.write_file("/pub/sub/inner.bin", b"\x01\x02" * 100)
    fc = client_cls(fs.url)
    return fs, fc, ftp_cls(fc, port=tc.free_port_pair()).start()


@pytest.fixture(scope="module")
def ftp_stack(cluster):
    """The reference cases' fixture: the port's gateway and filer."""
    from seaweedfs_tpu_torch.client.filer_client import FilerClient
    from seaweedfs_tpu_torch.filer.filer_server import FilerServer
    from seaweedfs_tpu_torch.ftpd import FtpServer
    fs, fc, ftp = _stack(cluster, FilerServer, FilerClient, FtpServer)
    yield {"ftp": ftp, "fs": fs}
    ftp.stop()
    fc.close()
    fs.stop()


def _client(ftp_stack) -> ftplib.FTP:
    c = ftplib.FTP()
    c.connect("127.0.0.1", ftp_stack["ftp"].port, timeout=10)
    c.login()  # anonymous
    return c


def test_login_pwd_cwd(ftp_stack):
    c = _client(ftp_stack)
    assert c.pwd() == "/"
    c.cwd("/pub")
    assert c.pwd() == "/pub"
    c.cwd("..")
    assert c.pwd() == "/"
    with pytest.raises(ftplib.error_perm):
        c.cwd("/does-not-exist")
    c.quit()


def test_list_and_nlst(ftp_stack):
    c = _client(ftp_stack)
    lines = []
    c.retrlines("LIST /pub", lines.append)
    assert any("hello.txt" in l for l in lines)
    assert any(l.startswith("d") and "sub" in l for l in lines)
    names = c.nlst("/pub")
    assert "hello.txt" in names and "sub" in names
    c.quit()


def test_retr_stor_roundtrip(ftp_stack):
    c = _client(ftp_stack)
    buf = io.BytesIO()
    c.retrbinary("RETR /pub/hello.txt", buf.write)
    assert buf.getvalue() == b"hello ftp world"
    payload = bytes(range(256)) * 10
    c.storbinary("STOR /pub/uploaded.bin", io.BytesIO(payload))
    buf = io.BytesIO()
    c.retrbinary("RETR /pub/uploaded.bin", buf.write)
    assert buf.getvalue() == payload
    # visible through the filer too (same namespace)
    fs = ftp_stack["fs"]
    e = fs.filer.find_entry("/pub", "uploaded.bin")
    assert e is not None and e.attributes.file_size == len(payload)
    assert c.size("/pub/uploaded.bin") == len(payload)
    c.quit()


def test_mkd_rmd_dele_rename(ftp_stack):
    c = _client(ftp_stack)
    c.mkd("/pub/newdir")
    assert "newdir" in c.nlst("/pub")
    c.storbinary("STOR /pub/newdir/f.txt", io.BytesIO(b"move me"))
    c.rename("/pub/newdir/f.txt", "/pub/newdir/g.txt")
    assert "g.txt" in c.nlst("/pub/newdir")
    c.delete("/pub/newdir/g.txt")
    assert "g.txt" not in c.nlst("/pub/newdir")
    c.rmd("/pub/newdir")
    assert "newdir" not in c.nlst("/pub")
    c.quit()


def test_auth_required(ftp_stack, tmp_path):
    from seaweedfs_tpu_torch.client.filer_client import FilerClient
    from seaweedfs_tpu_torch.ftpd import FtpServer

    fs = ftp_stack["fs"]
    srv = FtpServer(FilerClient(fs.url), port=tc.free_port_pair(),
                    users={"alice": "secret"}).start()
    try:
        c = ftplib.FTP()
        c.connect("127.0.0.1", srv.port, timeout=10)
        with pytest.raises(ftplib.error_perm):
            c.login()  # anonymous refused
        c2 = ftplib.FTP()
        c2.connect("127.0.0.1", srv.port, timeout=10)
        with pytest.raises(ftplib.error_perm):
            c2.login("alice", "wrong")
        c3 = ftplib.FTP()
        c3.connect("127.0.0.1", srv.port, timeout=10)
        c3.login("alice", "secret")
        assert c3.pwd() == "/"
        c3.quit()
    finally:
        srv.stop()


def test_root_jail(ftp_stack):
    """-root confines the session to a filer subtree."""
    from seaweedfs_tpu_torch.client.filer_client import FilerClient
    from seaweedfs_tpu_torch.ftpd import FtpServer

    fs = ftp_stack["fs"]
    srv = FtpServer(FilerClient(fs.url), port=tc.free_port_pair(),
                    root="/pub").start()
    try:
        c = ftplib.FTP()
        c.connect("127.0.0.1", srv.port, timeout=10)
        c.login()
        assert "hello.txt" in c.nlst("/")
        c.cwd("/..")  # normalizes back to the jail root
        assert c.pwd() == "/"
        buf = io.BytesIO()
        c.retrbinary("RETR /hello.txt", buf.write)
        assert buf.getvalue() == b"hello ftp world"
        c.quit()
    finally:
        srv.stop()


def test_dele_refuses_directories_and_root(ftp_stack):
    """RFC 959: DELE removes files only; a typo'd DELE must never
    recursively destroy a subtree, and '/' is untouchable."""
    c = _client(ftp_stack)
    with pytest.raises(ftplib.error_perm, match="directory"):
        c.delete("/pub/sub")
    with pytest.raises(ftplib.error_perm):
        c.delete("/")
    with pytest.raises(ftplib.error_perm):
        c.rmd("/")
    # subtree intact
    assert "inner.bin" in c.nlst("/pub/sub")
    c.quit()


def test_all_reference_cases_are_present():
    assert sum(1 for n in globals() if n.startswith("test_")) == 7 + 2


_DATE = re.compile(r"[A-Z][a-z]{2} [ \d]\d \d\d:\d\d")


def _session(port: int, rng) -> list:
    """One client's seeded session; every reply and every byte back."""
    out = []
    c = ftplib.FTP()
    c.connect("127.0.0.1", port, timeout=30)
    out.append(c.login())
    files = {f"/s/f{i}.bin": rng.bytes(int(rng.integers(0, 3 << 20)))
             for i in range(4)}
    out.append(c.mkd("/s"))
    for p, data in files.items():
        out.append(c.storbinary(f"STOR {p}", io.BytesIO(data)))
    for p, data in files.items():
        buf = io.BytesIO()
        out.append(c.retrbinary(f"RETR {p}", buf.write))
        assert buf.getvalue() == data
        out.append((c.size(p), c.sendcmd(f"MDTM {p}")[:3]))
    lines = []
    out.append(c.retrlines("LIST /s", lines.append))
    out.append([_DATE.sub("DATE", ln) for ln in lines])
    out.append(sorted(c.nlst("/s")))
    out.append(c.rename("/s/f0.bin", "/s/g0.bin"))
    out.append(c.delete("/s/f1.bin"))
    out.append(sorted(c.nlst("/s")))
    for cmd in ("RETR /s/none", "CWD /none", "DELE /s", "RMD /s",
                "SIZE /none"):
        try:
            c.sendcmd(cmd)
            out.append((cmd, "ok"))
        except ftplib.error_perm as e:
            out.append((cmd, str(e)))
    out.append(c.sendcmd("PWD"))
    out.append(c.sendcmd("SYST"))
    out.append(c.sendcmd("FEAT"))
    out.append(c.quit())
    return out


def test_session_equals_reference(cluster, ftp_stack):
    from seaweedfs_tpu.client.filer_client import FilerClient as RefClient
    from seaweedfs_tpu.filer.filer_server import FilerServer as RefFiler
    from seaweedfs_tpu.ftpd import FtpServer as RefFtp
    fs, fc, ftp = _stack(cluster, RefFiler, RefClient, RefFtp)
    try:
        ref = _session(ftp.port, np.random.default_rng(21))
    finally:
        ftp.stop()
        fc.close()
        fs.stop()
    assert _session(ftp_stack["ftp"].port, np.random.default_rng(21)) == ref
