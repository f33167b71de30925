"""The port's IAM API (seaweedfs_tpu_torch/iam, on the port's fastweb)
against the JAX package's (aiohttp), each over its own package's filer,
both filers over one cluster of the port on the CPU.

The same signed sequence of IAM actions goes to both: their answers (status
and XML, request ids and the generated access keys masked) are equal, and
so are the identity documents each persists at /etc/iam/identity.json. The
document written by either package loads in the other package's S3
gateway, where the key it holds signs a request."""

import http.client
import json
import re
import urllib.parse

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu.filer.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.iam import IamApiServer as RefIamApiServer
from seaweedfs_tpu.s3.auth import IdentityAccessManagement as RefIAM
from seaweedfs_tpu.s3.s3_server import S3Gateway as RefS3Gateway
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.iam import IamApiServer
from seaweedfs_tpu_torch.s3 import auth
from seaweedfs_tpu_torch.s3.auth import IdentityAccessManagement
from seaweedfs_tpu_torch.s3.s3_server import S3Gateway

AK, SK = "AKIDEXAMPLE", "sEcReT"
ADMIN = {"identities": [{"name": "admin", "credentials": [
    {"accessKey": AK, "secretKey": SK}], "actions": ["Admin"]}]}
POLICY = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:Get*", "s3:List*"],
     "Resource": ["arn:aws:s3:::photos/*"]},
    {"Effect": "Allow", "Action": "s3:Put*",
     "Resource": "arn:aws:s3:::photos"}]})


@pytest.fixture(scope="module")
def iams(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("iam-cluster"),
                 volume_size_limit_mb=64)
    kw = dict(store_spec="memory", chunk_size_mb=1)
    fs = {"port": FilerServer(c["master"].address, port=tc.free_port_pair(),
                              **kw).start(),
          "ref": RefFilerServer(c["master"].address,
                                port=tc.free_port_pair(), **kw).start()}
    srv = {"port": IamApiServer(IdentityAccessManagement(ADMIN),
                                filer_server=fs["port"],
                                port=tc.free_port_pair()).start(),
           "ref": RefIamApiServer(RefIAM(ADMIN), filer_server=fs["ref"],
                                  port=tc.free_port_pair()).start()}
    yield {"c": c, "fs": fs, "srv": srv}
    for s in srv.values():
        s.stop()
    for f in fs.values():
        f.stop()
    tc.stop(c)


def _iam(url: str, params: dict, key=(AK, SK), sign: bool = True):
    body = urllib.parse.urlencode({**params, "Version": "2010-05-08"}
                                  ).encode()
    headers = {"Content-Type": "application/x-www-form-urlencoded"}
    if sign:
        headers = auth.sign_request_v4("POST", f"http://{url}/", headers,
                                       body, key[0], key[1], service="iam")
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("POST", "/", body=body, headers=headers)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


_MASKS = ((re.compile(rb"<RequestId>[^<]*</RequestId>"), b"<RequestId/>"),
          (re.compile(rb"<AccessKeyId>AKIA[A-Z0-9]{16}</AccessKeyId>"),
           b"<AccessKeyId/>"),
          (re.compile(rb"<SecretAccessKey>[^<]{40}</SecretAccessKey>"),
           b"<SecretAccessKey/>"))


def _mask(body: bytes) -> bytes:
    for pat, sub in _MASKS:
        body = pat.sub(sub, body)
    return body


def _identity_doc(fs) -> dict:
    entry = fs.filer.find_entry("/etc/iam", "identity.json")
    return json.loads(fs.read_entry_bytes(entry))


def _sequence():
    return [
        {"Action": "ListUsers"},
        {"Action": "CreateUser", "UserName": "alice"},
        {"Action": "CreateUser", "UserName": "alice"},
        {"Action": "CreateUser"},
        {"Action": "GetUser", "UserName": "alice"},
        {"Action": "GetUser", "UserName": "nobody"},
        {"Action": "CreateAccessKey", "UserName": "alice"},
        {"Action": "ListAccessKeys", "UserName": "alice"},
        {"Action": "PutUserPolicy", "UserName": "alice",
         "PolicyName": "p1", "PolicyDocument": POLICY},
        {"Action": "GetUserPolicy", "UserName": "alice",
         "PolicyName": "p1"},
        {"Action": "PutUserPolicy", "UserName": "alice",
         "PolicyName": "bad", "PolicyDocument": "{not json"},
        {"Action": "CreatePolicy", "PolicyName": "readers",
         "PolicyDocument": POLICY},
        {"Action": "CreateUser", "UserName": "bob"},
        {"Action": "UpdateUser", "UserName": "bob", "NewUserName": "alice"},
        {"Action": "UpdateUser", "UserName": "bob", "NewUserName": "carol"},
        {"Action": "ListUsers"},
        {"Action": "DeleteUserPolicy", "UserName": "alice",
         "PolicyName": "p1"},
        {"Action": "GetUserPolicy", "UserName": "alice",
         "PolicyName": "p1"},
        {"Action": "DeleteUser", "UserName": "carol"},
        {"Action": "Frobnicate"},
        {"Action": "ListUsers"},
    ]


def test_iam_answers_equal_the_reference(iams):
    out = {}
    for side, srv in iams["srv"].items():
        rows = [(st, _mask(body))
                for st, body in (_iam(srv.url, p) for p in _sequence())]
        rows.append(_iam(srv.url, {"Action": "ListUsers"}, sign=False)[0])
        rows.append(_iam(srv.url, {"Action": "ListUsers"},
                         key=(AK, "wrong"))[0])
        out[side] = rows
    assert out["port"] == out["ref"]
    assert [r[0] for r in out["port"][:3]] == [200, 200, 409]
    assert out["port"][-2:] == [403, 403]
    docs = {side: _identity_doc(fs) for side, fs in iams["fs"].items()}

    def masked(doc):
        for ident in doc["identities"]:
            for cred in ident["credentials"]:
                if cred["accessKey"] != AK:
                    cred["accessKey"] = cred["secretKey"] = "<generated>"
        return doc
    assert masked(docs["port"]) == masked(docs["ref"])


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_identity_json_loads_in_the_other_gateway(iams, writer, reader):
    """A user and key made through one package's IAM API: the identity
    document its filer holds loads in the other package's gateway, where
    that key signs a PUT and a GET of the bucket its policy names, and is
    refused elsewhere."""
    user = f"u{writer}{np.random.default_rng(len(writer)).integers(1e6)}"
    url = iams["srv"][writer].url
    assert _iam(url, {"Action": "CreateUser", "UserName": user})[0] == 200
    st, body = _iam(url, {"Action": "CreateAccessKey", "UserName": user})
    assert st == 200
    ak = re.search(rb"<AccessKeyId>([^<]*)<", body).group(1).decode()
    sk = re.search(rb"<SecretAccessKey>([^<]*)<", body).group(1).decode()
    policy = json.dumps({"Statement": [
        {"Effect": "Allow", "Action": ["s3:Get*", "s3:List*", "s3:Put*"],
         "Resource": ["arn:aws:s3:::photos/*"]}]})
    assert _iam(url, {"Action": "PutUserPolicy", "UserName": user,
                      "PolicyName": "p", "PolicyDocument": policy})[0] == 200
    fsw = iams["fs"][writer]
    raw = fsw.read_entry_bytes(fsw.filer.find_entry("/etc/iam",
                                                    "identity.json"))
    fs = iams["fs"][reader]
    cls = S3Gateway if reader == "port" else RefS3Gateway
    gw = cls(fs, port=tc.free_port_pair(), iam_config=json.loads(raw)).start()
    try:
        def call(method, path, body=b"", key=(ak, sk)):
            hdrs = auth.sign_request_v4(method, f"http://{gw.url}{path}", {},
                                        body, key[0], key[1])
            conn = http.client.HTTPConnection(*gw.url.split(":"), timeout=60)
            conn.request(method, path, body=body or None, headers=hdrs)
            r = conn.getresponse()
            r.read()
            conn.close()
            return r.status
        assert call("PUT", "/photos", key=(AK, SK)) == 200
        assert call("PUT", "/photos/a.jpg", b"jpeg") == 200
        assert call("GET", "/photos/a.jpg") == 200
        assert call("PUT", "/other", key=(AK, SK)) == 200
        assert call("PUT", "/other/a.jpg", b"jpeg") == 403
        assert call("GET", "/photos/a.jpg", key=(ak, "wrong")) == 403
    finally:
        gw.stop()
    # the other package's IAM API accepts the document as its own
    other_iam = (IdentityAccessManagement if reader == "port" else RefIAM)()
    other_cls = IamApiServer if reader == "port" else RefIamApiServer
    other_cls._to_proto(json.loads(raw))
    other_iam.load(json.loads(raw))
    assert other_iam.lookup(ak)[0].name == user
