"""The port's security package (seaweedfs_tpu_torch/security/) against the
JAX package's: tokens minted byte for byte alike at a fixed clock, the same
decode and range verdicts, and the same (ok, why) from both Guards over a
table of requests."""

import base64
import time

import pytest

from seaweedfs_tpu import security as ref_sec
from seaweedfs_tpu.security import jwt as ref_jwt
from seaweedfs_tpu_torch import security as port_sec
from seaweedfs_tpu_torch.security import jwt as port_jwt

NOW = 1_760_000_000.0
KEY, READ_KEY = "sekrit-signing-key", "read-key"


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


def _both(fn, *args, **kw):
    got = getattr(port_jwt, fn)(*args, **kw)
    want = getattr(ref_jwt, fn)(*args, **kw)
    assert got == want, fn
    return got


def test_exports_match_reference():
    assert sorted(port_sec.__all__) == sorted(ref_sec.__all__)


@pytest.mark.parametrize("key", [KEY, b"bytes-key", ""])
def test_minted_tokens_equal_reference(fixed_clock, key):
    for exp in (0, 10, 3600):
        _both("gen_jwt_for_volume_server", key, exp, "3,01637037d6")
        _both("gen_jwt_for_fid_range", key, exp, 7, 0x1000, 256, 0xDEADBEEF)
        _both("gen_jwt_for_filer_server", key, exp)
    if key:
        _both("encode", {"fid": "9,ab", "exp": 5, "z": [1, 2]}, key)
    if isinstance(key, str):
        _both("derive_cluster_key", key)


def _claims(token, key, now=None):
    out = []
    for mod in (port_jwt, ref_jwt):
        try:
            out.append(("ok", mod.decode_jwt(token, key, now=now)))
        except mod.JwtError as e:
            out.append(("err", str(e)))
    return out


@pytest.mark.parametrize("case", ["valid", "expired", "wrong_key", "not_yet",
                                  "malformed", "bad_alg"])
def test_decode_verdicts_equal_reference(fixed_clock, case):
    tok = port_jwt.gen_jwt_for_volume_server(KEY, 10, "3,01637037d6")
    key, now = KEY, None
    if case == "expired":
        now = NOW + 11
    elif case == "wrong_key":
        key = "other"
    elif case == "not_yet":
        tok = port_jwt.encode({"nbf": NOW + 5}, KEY)
    elif case == "malformed":
        tok = "a.b"
    elif case == "bad_alg":
        head = base64.urlsafe_b64encode(
            b'{"alg":"none","typ":"JWT"}').rstrip(b"=").decode()
        tok = head + tok[tok.index("."):]
    got, want = _claims(tok, key, now)  # the port's verdict, the JAX one's
    assert got == want
    if case == "valid":
        assert got == ("ok", {"fid": "3,01637037d6", "exp": int(NOW) + 10})
    else:
        assert got[0] == "err"


@pytest.mark.parametrize("fid", ["7,1000deadbeef", "7,10ffdeadbeef",
                                 "7,1100deadbeef", "7,0fffdeadbeef",
                                 "8,1000deadbeef", "7,1000deadbeee",
                                 "not-a-fid", "7,zz"])
def test_range_claims_equal_reference(fixed_clock, fid):
    tok = port_jwt.gen_jwt_for_fid_range(KEY, 30, 7, 0x1000, 256, 0xDEADBEEF)
    claims = port_jwt.decode_jwt(tok, KEY)
    assert port_jwt.parse_range_claim(claims) == \
        ref_jwt.parse_range_claim(claims) == (7, 0x1000, 256, 0xDEADBEEF)
    assert port_jwt.range_covers_fid(claims, fid) == \
        ref_jwt.range_covers_fid(claims, fid)
    for bad in ({}, {"rng": "1,2"}, {"rng": "a,b,c,d"}):
        assert port_jwt.parse_range_claim(bad) == \
            ref_jwt.parse_range_claim(bad) is None


def _basic(user, pw):
    return "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode()


FID = "3,01637037d6"
GUARDS = {
    "open": {},
    "write": {"signing_key": KEY},
    "white_list": {"white_list": ["10.0.0.7", "192.168.0.0/16", "bogus"]},
    "basic": {"signing_key": KEY, "username": "u", "password": "p"},
    "read": {"signing_key": KEY, "read_signing_key": READ_KEY,
             "white_list": ["10.1.0.0/16"]},
}


def _requests():
    wtok = port_jwt.gen_jwt_for_volume_server(KEY, 10, FID)
    other = port_jwt.gen_jwt_for_volume_server(KEY, 10, "3,02637037d6")
    filer = port_jwt.gen_jwt_for_filer_server(KEY, 10)
    rtok = port_jwt.gen_jwt_for_volume_server(READ_KEY, 10, FID)
    rng = port_jwt.gen_jwt_for_fid_range(KEY, 10, 3, 0x01, 16, 0x637037d6)
    return [
        ("no token", "1.2.3.4", {}, {}, FID),
        ("query token", "1.2.3.4", {"jwt": wtok}, {}, FID),
        ("bearer token", "1.2.3.4", {}, {"Authorization": f"Bearer {wtok}"},
         FID),
        ("cookie token", "1.2.3.4", {}, {"Cookie": f"a=b; jwt={wtok}"}, FID),
        ("wrong fid", "1.2.3.4", {"jwt": other}, {}, FID),
        ("filer token on a fid", "1.2.3.4", {"jwt": filer}, {}, FID),
        ("filer token, no fid", "1.2.3.4", {"jwt": filer}, {}, ""),
        ("read token", "1.2.3.4", {"jwt": rtok}, {}, FID),
        ("range token in range", "1.2.3.4", {"jwt": rng}, {}, FID),
        ("range token out of range", "1.2.3.4", {"jwt": rng}, {},
         "3,41637037d6"),
        ("white-listed ip", "10.0.0.7", {}, {}, FID),
        ("white-listed cidr", "192.168.4.5", {}, {}, FID),
        ("read cidr", "10.1.2.3", {}, {}, FID),
        ("bad ip", "not-an-ip", {}, {}, FID),
        ("basic auth", "1.2.3.4", {}, {"Authorization": _basic("u", "p")},
         FID),
        ("basic auth wrong", "1.2.3.4", {}, {"Authorization": _basic("u", "x")},
         FID),
        ("basic auth garbage", "1.2.3.4", {}, {"Authorization": "Basic !!"},
         FID),
    ]


@pytest.mark.parametrize("guard", sorted(GUARDS))
@pytest.mark.parametrize("i", range(17))
def test_guard_decisions_equal_reference(fixed_clock, guard, i):
    name, ip, query, headers, fid = _requests()[i]
    port_g = port_sec.Guard(**GUARDS[guard])
    ref_g = ref_sec.Guard(**GUARDS[guard])
    for check in ("check_write", "check_read"):
        got = getattr(port_g, check)(ip, query, headers, fid)
        assert got == getattr(ref_g, check)(ip, query, headers, fid), \
            (name, check)
    assert port_g.check_ip(ip) == ref_g.check_ip(ip)
    for keys, cookie in (([1, 5, 16], 0x637037d6), ([0x11], 0x637037d6),
                         ([1], 0x1), ([1, 2], 0x637037d6)):
        for vid in (3, 4):
            assert port_g.check_bulk(ip, query, headers, vid, keys, cookie) \
                == ref_g.check_bulk(ip, query, headers, vid, keys, cookie), \
                (name, vid, keys, cookie)


# -- gRPC mTLS (utils/rpc.py TlsConfig) against the JAX package -------------

def _make_certs(tmp_path):
    """A CA and one cluster certificate (CN=swtpu) made with openssl."""
    import subprocess
    ca_key, ca_crt = tmp_path / "ca.key", tmp_path / "ca.crt"
    key, csr, crt = (tmp_path / "node.key", tmp_path / "node.csr",
                     tmp_path / "node.crt")
    for cmd in (["req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
                 ca_key, "-out", ca_crt, "-days", "1", "-subj", "/CN=swtpu-ca"],
                ["req", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
                 "-out", csr, "-subj", "/CN=swtpu"],
                ["x509", "-req", "-in", csr, "-CA", ca_crt, "-CAkey", ca_key,
                 "-CAcreateserial", "-out", crt, "-days", "1"]):
        subprocess.run(["openssl", *map(str, cmd)], check=True,
                       capture_output=True)
    return str(ca_crt), str(crt), str(key)


@pytest.fixture
def both_tls(tmp_path):
    """Both packages' process-wide mTLS set from one cluster certificate;
    both cleared after."""
    from seaweedfs_tpu.utils import rpc as ref_rpc
    from seaweedfs_tpu_torch.utils import rpc as port_rpc
    certs = _make_certs(tmp_path)
    port_rpc.set_tls_config(port_rpc.TlsConfig(*certs))
    ref_rpc.set_tls_config(ref_rpc.TlsConfig(*certs))
    try:
        yield certs
    finally:
        port_rpc.set_tls_config(None)
        ref_rpc.set_tls_config(None)


def _plaintext_refused(address, service, req, resp_cls):
    import grpc
    ch = grpc.insecure_channel(address)
    try:
        fn = ch.unary_unary(f"/{service}/Ping",
                            request_serializer=type(req).SerializeToString,
                            response_deserializer=resp_cls.FromString)
        with pytest.raises(grpc.RpcError):
            fn(req, timeout=3)
    finally:
        ch.close()


def test_port_server_under_mtls_with_a_jax_stub(tmp_path, both_tls):
    """A port volume server served under mTLS answers the JAX package's
    Stub (which presents the cluster certificate); a plaintext client and
    a TLS client without a certificate are refused."""
    import grpc

    from conftest import free_port_pair
    from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb
    from seaweedfs_tpu.utils.rpc import VOLUME_SERVICE, Stub as RefStub
    from seaweedfs_tpu_torch.server.grpc_service import serve_volume
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.store import Store
    port = free_port_pair()
    store = Store("127.0.0.1", port, f"127.0.0.1:{port}",
                  [DiskLocation(str(tmp_path / "vs"))], device="cpu")
    served = serve_volume(VolumeServer(store, "127.0.0.1", port))
    addr = f"127.0.0.1:{port + 10000}"
    try:
        stub = RefStub(addr, VOLUME_SERVICE)
        stub.call("AllocateVolume", ref_vpb.AllocateVolumeRequest(volume_id=4),
                  ref_vpb.AllocateVolumeResponse, timeout=10)
        st = stub.call("VolumeStatus", ref_vpb.VolumeStatusRequest(volume_id=4),
                       ref_vpb.VolumeStatusResponse, timeout=10)
        assert (st.is_read_only, st.file_count) == (False, 0)
        assert stub.call("Ping", ref_vpb.PingRequest(), ref_vpb.PingResponse,
                         timeout=10).remote_time_ns > 0
        _plaintext_refused(addr, VOLUME_SERVICE, ref_vpb.PingRequest(),
                           ref_vpb.PingResponse)
        ca = both_tls[0]
        with open(ca, "rb") as f:
            creds = grpc.ssl_channel_credentials(root_certificates=f.read())
        ch = grpc.secure_channel(
            addr, creds, options=[("grpc.ssl_target_name_override", "swtpu")])
        try:
            with pytest.raises(grpc.RpcError):
                ch.unary_unary(
                    f"/{VOLUME_SERVICE}/Ping",
                    request_serializer=ref_vpb.PingRequest.SerializeToString,
                    response_deserializer=ref_vpb.PingResponse.FromString)(
                    ref_vpb.PingRequest(), timeout=3)
        finally:
            ch.close()
    finally:
        served.stop()


def test_jax_server_under_mtls_with_a_port_stub(both_tls):
    """The JAX package's master served under mTLS answers the port's Stub;
    a plaintext client is refused."""
    from conftest import free_port_pair
    from seaweedfs_tpu.master.master_server import MasterServer
    from seaweedfs_tpu_torch.pb import master_pb2 as mpb
    from seaweedfs_tpu_torch.utils.rpc import MASTER_SERVICE, Stub
    ms = MasterServer(port=free_port_pair(), pulse_seconds=0.5,
                      maintenance_scripts=[])
    ms.start()
    try:
        got = Stub(ms.address, MASTER_SERVICE).call(
            "Ping", mpb.PingRequest(), mpb.PingResponse, timeout=10)
        assert got.start_time_ns > 0
        _plaintext_refused(ms.address, MASTER_SERVICE, mpb.PingRequest(),
                           mpb.PingResponse)
    finally:
        ms.stop()


@pytest.mark.parametrize("section", ["none", "partial", "all"])
def test_tls_from_security_toml_like_reference(tmp_path, monkeypatch,
                                               section):
    """[grpc] on the config chain: absent gives plaintext, a partial section
    raises (fail closed), a whole one gives the same TlsConfig."""
    from seaweedfs_tpu.utils import rpc as ref_rpc
    from seaweedfs_tpu_torch.utils import rpc as port_rpc
    ca, crt, key = _make_certs(tmp_path)
    etc = tmp_path / "etc"
    etc.mkdir()
    monkeypatch.chdir(etc)
    monkeypatch.setenv("SWTPU_CONFIG_DIR", str(etc))
    body = {"none": "[jwt.signing]\nkey = \"k\"\n",
            "partial": f"[grpc]\nca = \"{ca}\"\ncert = \"{crt}\"\n",
            "all": f"[grpc]\nca = \"{ca}\"\ncert = \"{crt}\"\n"
                   f"key = \"{key}\"\nserver_name = \"swtpu\"\n"}[section]
    (etc / "security.toml").write_text(body)
    if section == "partial":
        for mod in (port_rpc, ref_rpc):
            with pytest.raises(ValueError, match="ca/cert/key"):
                mod.load_tls_from_security_toml()
        return
    got = port_rpc.load_tls_from_security_toml()
    want = ref_rpc.load_tls_from_security_toml()
    if section == "none":
        assert got is None and want is None
        return
    assert (got.server_name, got.ca, got.cert, got.key) == \
        (want.server_name, want.ca, want.cert, want.key)


def test_volume_verb_refuses_a_partial_grpc_section(tmp_path):
    """The verb installs mTLS from security.toml before any server starts;
    a partial [grpc] section exits non-zero instead of serving plaintext."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    etc = tmp_path / "etc"
    etc.mkdir()
    (etc / "security.toml").write_text("[grpc]\nca = \"/no/ca.crt\"\n")
    out = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume", "-dir",
         str(tmp_path / "d"), "-port", "1", "-mserver", "127.0.0.1:1",
         "-device", "cpu"],
        capture_output=True, text=True, timeout=120,
        cwd=str(Path(__file__).resolve().parent.parent),
        env={**os.environ, "SWTPU_CONFIG_DIR": str(etc)})
    assert out.returncode == 1
    assert "mTLS configured but unusable" in out.stderr, out.stderr
