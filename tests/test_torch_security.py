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
