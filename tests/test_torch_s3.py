"""The port's S3 gateway (seaweedfs_tpu_torch/s3, its HTTP plane on the
port's fastweb) against the JAX package's (aiohttp), each over its own
package's filer, both filers over one cluster of the port on the CPU
(tests/torch_cluster.py).

* A differential sequence of signed requests goes to both gateways:
  buckets, PUT (small, and streamed past the 1 MiB chunk), Range,
  ListObjects v1/v2 with prefix, delimiter, markers and paging, multipart
  with UploadPartCopy, CopyObject, tagging, ACLs, lifecycle, quota, a
  browser post policy, DeleteObjects, refusals. Status codes, XML bodies
  (dates and upload ids masked), the headers a client reads and the bytes
  are equal. The one step where they differ on purpose is a PUT under a
  lifecycle Expiration rule: the reference's filer sends the rule's TTL as
  "<seconds>s", which the volume side refuses; the port's succeeds.
* Both packages' IdentityAccessManagement give the same verdict and error
  code on the same seeded requests: SigV4 in the header, presigned and
  streaming, the V2 header and query schemes; good, tampered, expired,
  wrong key. The aws-chunked framing decodes byte-equal, and the circuit
  breakers decide alike on a seeded sequence.
* Keys with spaces, '+', '%', '%2F' and non-ASCII characters sign, store,
  list and read back alike through both gateways.
* A 64 MiB signed streamed PUT and GET through the port's gateway hold the
  filer's stream bounds; a body whose sha256 does not match its signed
  digest leaves no entry and no needle.
* A port gateway over a JAX filer (FilerClient, as the `s3` verb runs)
  and a JAX gateway over the port's filer each write what the other
  package's gateway reads back.
"""

import base64
import datetime
import hashlib
import hmac
import http.client
import io
import json
import re
import socket
import time
import urllib.parse

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu.client.master_client import MasterClient as RefMC
from seaweedfs_tpu.filer.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.s3 import auth as ref_auth
from seaweedfs_tpu.s3 import chunked as ref_chunked
from seaweedfs_tpu.s3.circuit_breaker import CircuitBreaker as RefBreaker
from seaweedfs_tpu.s3.s3_server import S3Gateway as RefS3Gateway
from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu.shell import fs_commands as ref_fs_commands  # noqa: F401
from seaweedfs_tpu_torch.client.filer_client import FilerClient
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.s3 import auth
from seaweedfs_tpu_torch.s3 import chunked
from seaweedfs_tpu_torch.s3.circuit_breaker import CircuitBreaker
from seaweedfs_tpu_torch.s3.s3_server import S3Gateway
from seaweedfs_tpu_torch.shell import commands as port_commands
from seaweedfs_tpu_torch.shell import fs_commands  # noqa: F401
from seaweedfs_tpu_torch.storage.types import parse_file_id
from seaweedfs_tpu_torch.utils import fastweb

MiB = 1 << 20
AK, SK = "AKIDEXAMPLE", "sEcReT"
IAM_CONFIG = {"identities": [
    {"name": "admin", "credentials": [{"accessKey": AK, "secretKey": SK}],
     "actions": ["Admin"]},
    {"name": "reader",
     "credentials": [{"accessKey": "READONLY", "secretKey": "rdsecret"}],
     "actions": ["Read", "List"]},
]}


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    root = tmp_path_factory.mktemp("s3-diff")
    c = tc.start(root, volume_size_limit_mb=64)
    kw = dict(store_spec="memory", chunk_size_mb=1)
    fs = {"port": FilerServer(c["master"].address, port=tc.free_port_pair(),
                              **kw).start(),
          "ref": RefFilerServer(c["master"].address,
                                port=tc.free_port_pair(), **kw).start()}
    gw = {"port": S3Gateway(fs["port"], port=tc.free_port_pair(),
                            iam_config=IAM_CONFIG).start(),
          "ref": RefS3Gateway(fs["ref"], port=tc.free_port_pair(),
                              iam_config=IAM_CONFIG).start()}
    ref_mc = RefMC(c["master"].address).start()
    ref_mc.wait_connected(10)
    envs = {"port": port_commands.CommandEnv(c["master"].address, mc=c["mc"],
                                             out=io.StringIO()),
            "ref": ref_commands.CommandEnv(c["master"].address, mc=ref_mc,
                                           out=io.StringIO())}
    for side in envs:
        envs[side].option["filer"] = fs[side].url
    yield {"c": c, "fs": fs, "gw": gw, "envs": envs}
    for g in gw.values():
        g.stop()
    ref_mc.stop()
    for f in fs.values():
        f.stop()
    tc.stop(c)


def _call(url: str, method: str, target: str, body: bytes = b"",
          headers: "dict | None" = None, sign: bool = True,
          key: "tuple[str, str]" = (AK, SK), sign_path: "str | None" = None):
    """One request over http.client; signed with the port's SigV4 signer
    over `sign_path` (the decoded path an SDK signs; default: `target`'s
    path). Returns (status, lower-cased headers, body)."""
    headers = dict(headers or {})
    if sign:
        path, _, query = target.partition("?")
        signed_url = f"http://{url}{sign_path or path}" + (
            f"?{query}" if query else "")
        headers = auth.sign_request_v4(method, signed_url, headers, body,
                                       key[0], key[1])
    host, port = url.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request(method, target, body=body or None, headers=headers)
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


_DATES = re.compile(rb"<(LastModified|CreationDate|Initiated)>[^<]*</\1>")
_HEADERS = ("etag", "content-range", "accept-ranges", "location",
            "x-amz-meta-color", "retry-after")


def _norm(resp, upload_ids=()):
    status, headers, body = resp
    body = _DATES.sub(rb"<\1/>", body)
    for u in upload_ids:
        body = body.replace(u.encode(), b"<upload>")
    keep = {h: headers.get(h) for h in _HEADERS}
    if status in (200, 206) and body and not body.startswith(b"<?xml"):
        keep["content-type"] = headers.get("content-type")
        keep["content-length"] = headers.get("content-length")
    return status, keep, body


def _xml_text(body: bytes, tag: str) -> str:
    m = re.search(rb"<" + tag.encode() + rb">([^<]*)<", body)
    return m.group(1).decode() if m else ""


def _post_policy_form(bucket: str, key: str, data: bytes):
    date = time.strftime("%Y%m%d", time.gmtime())
    exp = (datetime.datetime.now(datetime.timezone.utc)
           + datetime.timedelta(minutes=10)).strftime("%Y-%m-%dT%H:%M:%SZ")
    policy = base64.b64encode(json.dumps({
        "expiration": exp,
        "conditions": [{"bucket": bucket}, ["starts-with", "$key", "up/"]],
    }).encode()).decode()
    signing_key = auth.IdentityAccessManagement._signing_key(
        SK, date, "us-east-1", "s3")
    sig = hmac.new(signing_key, policy.encode(), hashlib.sha256).hexdigest()
    fields = {"key": key, "policy": policy,
              "x-amz-credential": f"{AK}/{date}/us-east-1/s3/aws4_request",
              "x-amz-signature": sig, "x-amz-meta-color": "green"}
    b = "s3diffboundary"
    out = b""
    for k, v in fields.items():
        out += (f"--{b}\r\nContent-Disposition: form-data; name=\"{k}\""
                f"\r\n\r\n{v}\r\n").encode()
    out += (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"form.txt\"\r\nContent-Type: text/plain\r\n\r\n"
            ).encode() + data + f"\r\n--{b}--\r\n".encode()
    return out, f"multipart/form-data; boundary={b}"


def _sequence(seed: int):
    """The differential sequence: (label, method, target, body, headers,
    options) with {upload}/{etag1}... filled in from earlier answers."""
    rng = np.random.default_rng(seed)
    small = b"hello, s3\n" * 30
    big = rng.bytes(2 * MiB + 12345)
    part1 = rng.bytes(MiB + MiB // 2)
    part3 = b"tail of the multipart object"
    b = "diffb"
    tagging = (b"<Tagging><TagSet><Tag><Key>k1</Key><Value>v1</Value></Tag>"
               b"<Tag><Key>k2</Key><Value>v2</Value></Tag></TagSet>"
               b"</Tagging>")
    lifecycle = (b"<LifecycleConfiguration><Rule><ID>r</ID><Filter><Prefix>"
                 b"logs/</Prefix></Filter><Status>Enabled</Status>"
                 b"<Expiration><Days>7</Days></Expiration></Rule>"
                 b"</LifecycleConfiguration>")
    delete = (b"<Delete><Object><Key>a.txt</Key></Object><Object><Key>e.txt"
              b"</Key></Object><Object><Key>nosuch</Key></Object></Delete>")
    form, form_ct = _post_policy_form(b, "up/${filename}", b"posted bytes")
    s = []

    def step(label, method, target, body=b"", headers=None, **opt):
        s.append((label, method, target, body, headers or {}, opt))

    step("put-bucket", "PUT", f"/{b}")
    step("put-bucket-again", "PUT", f"/{b}")
    step("head-bucket", "HEAD", f"/{b}")
    step("head-missing-bucket", "HEAD", "/nosuchbucket")
    step("list-buckets", "GET", "/")
    step("put-small", "PUT", f"/{b}/a.txt", small,
         {"Content-Type": "text/plain", "x-amz-meta-color": "blue"})
    step("put-big-streamed", "PUT", f"/{b}/big.bin", big)
    for k in ("dir/b.txt", "dir/c.txt", "dir/sub/d.txt", "e.txt"):
        step(f"put-{k}", "PUT", f"/{b}/{k}", k.encode() * 3)
    step("put-missing-bucket", "PUT", "/nosuchbucket/x", b"x")
    step("get-small", "GET", f"/{b}/a.txt")
    step("head-small", "HEAD", f"/{b}/a.txt")
    step("get-big", "GET", f"/{b}/big.bin")
    step("range-across-chunks", "GET", f"/{b}/big.bin", b"",
         {"Range": "bytes=1000-1049575"})
    step("range-suffix", "GET", f"/{b}/big.bin", b"", {"Range": "bytes=-100"})
    step("range-past-end", "GET", f"/{b}/a.txt", b"",
         {"Range": "bytes=99999-"})
    step("get-missing-key", "GET", f"/{b}/ghost")
    step("if-none-match", "GET", f"/{b}/a.txt", b"",
         {"If-None-Match": '"' + hashlib.md5(small).hexdigest() + '"'})
    step("list-v1-prefix", "GET", f"/{b}?prefix=dir/")
    step("list-v1-delimiter", "GET", f"/{b}?delimiter=/")
    step("list-v1-marker", "GET", f"/{b}?marker=dir/b.txt")
    step("list-v1-max-keys", "GET", f"/{b}?max-keys=2")
    step("list-v2", "GET", f"/{b}?list-type=2")
    step("list-v2-page", "GET", f"/{b}?list-type=2&max-keys=2")
    step("list-v2-continue", "GET",
         f"/{b}?list-type=2&max-keys=2&continuation-token=dir%2Fc.txt")
    step("list-v2-start-after", "GET", f"/{b}?list-type=2&start-after=dir/sub")
    step("list-v2-prefix-delimiter", "GET",
         f"/{b}?list-type=2&prefix=dir/&delimiter=/")
    step("mp-init", "POST", f"/{b}/mp.bin?uploads", b"",
         {"x-amz-meta-color": "red"}, capture="upload")
    step("mp-part1", "PUT", f"/{b}/mp.bin?partNumber=1&uploadId={{upload}}",
         part1, capture="etag1")
    step("mp-part2-copy", "PUT",
         f"/{b}/mp.bin?partNumber=2&uploadId={{upload}}", b"",
         {"x-amz-copy-source": f"/{b}/big.bin",
          "x-amz-copy-source-range": "bytes=0-1048575"}, capture="etag2")
    step("mp-part3", "PUT", f"/{b}/mp.bin?partNumber=3&uploadId={{upload}}",
         part3, capture="etag3")
    step("mp-list-parts", "GET", f"/{b}/mp.bin?uploadId={{upload}}")
    step("mp-list-uploads", "GET", f"/{b}?uploads")
    step("mp-complete-bad-order", "POST", f"/{b}/mp.bin?uploadId={{upload}}",
         b"<CompleteMultipartUpload><Part><PartNumber>2</PartNumber></Part>"
         b"<Part><PartNumber>1</PartNumber></Part></CompleteMultipartUpload>")
    step("mp-complete", "POST", f"/{b}/mp.bin?uploadId={{upload}}",
         "complete")
    step("mp-get", "GET", f"/{b}/mp.bin")
    step("mp-head", "HEAD", f"/{b}/mp.bin")
    step("copy", "PUT", f"/{b}/copy.bin", b"",
         {"x-amz-copy-source": f"/{b}/big.bin"})
    step("copy-get", "GET", f"/{b}/copy.bin")
    step("copy-to-itself", "PUT", f"/{b}/a.txt", b"",
         {"x-amz-copy-source": f"/{b}/a.txt"})
    step("tag-put", "PUT", f"/{b}/a.txt?tagging", tagging)
    step("tag-get", "GET", f"/{b}/a.txt?tagging")
    step("tag-delete", "DELETE", f"/{b}/a.txt?tagging")
    step("tag-get-again", "GET", f"/{b}/a.txt?tagging")
    step("acl-put", "PUT", f"/{b}/a.txt?acl", b"", {"x-amz-acl": "public-read"})
    step("acl-get", "GET", f"/{b}/a.txt?acl")
    step("acl-put-bad", "PUT", f"/{b}?acl", b"", {"x-amz-acl": "nope"})
    step("bucket-acl-get", "GET", f"/{b}?acl")
    step("versioning-get", "GET", f"/{b}?versioning")
    step("policy-get", "GET", f"/{b}?policy")
    step("lifecycle-get-none", "GET", f"/{b}?lifecycle")
    step("lifecycle-put", "PUT", f"/{b}?lifecycle", lifecycle)
    step("lifecycle-get", "GET", f"/{b}?lifecycle")
    step("lifecycle-then-put", "PUT", f"/{b}/logs/x.txt", b"log line\n",
         diverges=True)
    step("lifecycle-delete", "DELETE", f"/{b}?lifecycle")
    # the diverging object goes, so the listings after it compare equal
    step("lifecycle-object-delete", "DELETE", f"/{b}/logs/x.txt")
    step("put-after-lifecycle", "PUT", f"/{b}/logs/y.txt", b"log line\n")
    step("post-policy", "POST", f"/{b}", form, {"Content-Type": form_ct},
         sign=False)
    step("post-policy-get", "GET", f"/{b}/up/form.txt")
    step("unsigned-get", "GET", f"/{b}/dir/b.txt", sign=False)
    step("unsigned-put-with-body", "PUT", f"/{b}/u.bin", b"z" * 5000,
         sign=False)
    step("reader-get", "GET", f"/{b}/dir/b.txt", key=("READONLY", "rdsecret"))
    step("reader-put", "PUT", f"/{b}/r.txt", b"r",
         key=("READONLY", "rdsecret"))
    step("wrong-secret", "GET", f"/{b}/dir/b.txt", key=(AK, "wrong"))
    step("delete-objects", "POST", f"/{b}?delete", delete)
    step("list-after-delete", "GET", f"/{b}?list-type=2")
    step("delete-bucket-nonempty", "DELETE", f"/{b}")
    step("delete-object", "DELETE", f"/{b}/dir/sub/d.txt")
    step("quota-bucket", "PUT", "/quotab")
    step("quota-put-1", "PUT", "/quotab/one.bin", rng.bytes(MiB + 1000))
    step("quota-check", "SHELL", "",
         ["s3.bucket.quota -bucket quotab -sizeMB 1",
          "s3.bucket.quota.check"])
    step("quota-put-refused", "PUT", "/quotab/two.bin", b"more")
    step("quota-get-still", "GET", "/quotab/one.bin")
    return s


def _run_sequence(url: str, env, seq):
    results, vals, uploads = [], {}, []
    for label, method, target, body, headers, opt in seq:
        if method == "SHELL":
            env.out = io.StringIO()
            mod = (port_commands if isinstance(env, port_commands.CommandEnv)
                   else ref_commands)
            for line in body:
                mod.run_command(env, line)
            results.append((label, env.out.getvalue()))
            continue
        target = target.format(**vals)
        if body == "complete":
            body = ("<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{i}</PartNumber><ETag>"
                f"{vals[f'etag{i}']}</ETag></Part>" for i in (1, 2, 3))
                + "</CompleteMultipartUpload>").encode()
        resp = _call(url, method, target, body, headers,
                     sign=opt.get("sign", True),
                     key=opt.get("key", (AK, SK)))
        cap = opt.get("capture")
        if cap == "upload":
            vals["upload"] = _xml_text(resp[2], "UploadId")
            uploads.append(vals["upload"])
        elif cap:
            vals[cap] = resp[1].get("etag") or _xml_text(resp[2], "ETag")
        results.append((label, resp, opt.get("diverges", False)))
    return [(r[0], r[1]) if len(r) == 2 else
            (r[0], _norm(r[1], uploads), r[2]) for r in results]


def test_differential_sequence_against_the_reference_gateway(planes):
    seq = _sequence(18)
    got = {side: _run_sequence(planes["gw"][side].url, planes["envs"][side],
                               seq) for side in ("port", "ref")}
    assert len(got["port"]) == len(got["ref"]) == len(seq)
    for port_r, ref_r in zip(got["port"], got["ref"]):
        label = port_r[0]
        if len(port_r) == 2:  # a shell step: same output
            assert port_r[1] == ref_r[1], label
            continue
        if port_r[2]:
            # the TTL repair: the reference's PUT under the lifecycle rule
            # fails, the port's succeeds
            assert ref_r[1][0] == 500, (label, ref_r[1])
            assert port_r[1][0] == 200, (label, port_r[1])
            continue
        assert port_r[1] == ref_r[1], label
    by_label = {r[0]: r[1] for r in got["port"]}
    assert by_label["get-big"][0] == 200
    assert by_label["mp-get"][0] == 200 and \
        by_label["mp-get"][1]["etag"].endswith('-3"')
    assert by_label["unsigned-get"][0] == 403
    assert by_label["quota-put-refused"][0] == 403
    assert b"QuotaExceeded" in by_label["quota-put-refused"][2]
    assert by_label["post-policy-get"][2] == b"posted bytes"


def test_lifecycle_rule_ttl_reaches_needles_and_entries(planes):
    """The TTL repair: under a lifecycle Expiration of 7 days the port's
    PUT lands, its entry carries ttl_sec = 7 days and its needle and volume
    the TTL "7d" (the rule's own string); the reference's PUT answers 500
    because its filer asks the volume side for "604800s"."""
    rule = (b"<LifecycleConfiguration><Rule><Filter><Prefix>exp/</Prefix>"
            b"</Filter><Status>Enabled</Status><Expiration><Days>7</Days>"
            b"</Expiration></Rule></LifecycleConfiguration>")
    status = {}
    for side in ("port", "ref"):
        url = planes["gw"][side].url
        assert _call(url, "PUT", "/ttlb")[0] == 200
        assert _call(url, "PUT", "/ttlb?lifecycle", rule)[0] == 200
        status[side] = _call(url, "PUT", "/ttlb/exp/k.bin", b"k" * 4096)
        assert _call(url, "PUT", "/ttlb/keep/k.bin", b"k")[0] == 200
    assert status["ref"][0] == 500, status["ref"]
    assert status["port"][0] == 200, status["port"]
    got = _call(planes["gw"]["port"].url, "GET", "/ttlb/exp/k.bin")
    assert got[:1] == (200,) and got[2] == b"k" * 4096
    e = planes["fs"]["port"].filer.find_entry("/buckets/ttlb/exp", "k.bin")
    assert e.attributes.ttl_sec == 7 * 86400
    vid, nid, _cookie = parse_file_id(e.chunks[0].file_id)
    holders = [s.vs.store.find_volume(vid)
               for s in planes["c"]["served"].values()]
    vol = next(v for v in holders if v is not None)
    assert str(vol.super_block.ttl) == "7d"
    assert str(vol.read_needle(nid).ttl) == "7d"
    keep = planes["fs"]["port"].filer.find_entry("/buckets/ttlb/keep",
                                                 "k.bin")
    assert keep.attributes.ttl_sec == 0


def _seeded_requests(mod, rng):
    """(label, verify-callable) over one package's signers."""
    now = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    url = "http://127.0.0.1:8333/bkt/some/key.bin"
    body = rng.bytes(333)
    cases = []
    h = mod.sign_request_v4("PUT", url, {}, body, AK, SK, amz_date=now)
    cases.append(("header-good", "PUT", "/bkt/some/key.bin", {}, h,
                  hashlib.sha256(body).hexdigest()))
    bad = dict(h)
    bad["Authorization"] = bad["Authorization"][:-4] + "0000"
    cases.append(("header-tampered-sig", "PUT", "/bkt/some/key.bin", {}, bad,
                  hashlib.sha256(body).hexdigest()))
    cases.append(("header-other-path", "PUT", "/bkt/other", {}, h,
                  hashlib.sha256(body).hexdigest()))
    old = mod.sign_request_v4("GET", url, {}, b"", AK, SK,
                              amz_date="20200101T000000Z")
    cases.append(("header-stale", "GET", "/bkt/some/key.bin", {}, old,
                  hashlib.sha256(b"").hexdigest()))
    wrong = mod.sign_request_v4("GET", url, {}, b"", AK, "nope", amz_date=now)
    cases.append(("header-wrong-secret", "GET", "/bkt/some/key.bin", {}, wrong,
                  hashlib.sha256(b"").hexdigest()))
    unknown = mod.sign_request_v4("GET", url, {}, b"", "NOBODY", SK,
                                  amz_date=now)
    cases.append(("header-unknown-key", "GET", "/bkt/some/key.bin", {},
                  unknown, hashlib.sha256(b"").hexdigest()))
    reader = mod.sign_request_v4("GET", url, {}, b"", "READONLY", "rdsecret",
                                 amz_date=now)
    cases.append(("header-reader", "GET", "/bkt/some/key.bin", {}, reader,
                  hashlib.sha256(b"").hexdigest()))
    return cases


def _presigned_query(mod, path, expires, amz_date, secret=SK):
    """A presigned GET's query, signed as an SDK presigns (canonical
    request over the X-Amz-* query with UNSIGNED-PAYLOAD)."""
    date = amz_date[:8]
    q = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256",
         "X-Amz-Credential": f"{AK}/{date}/us-east-1/s3/aws4_request",
         "X-Amz-Date": amz_date, "X-Amz-Expires": str(expires),
         "X-Amz-SignedHeaders": "host"}
    iam = mod.IdentityAccessManagement()
    canonical = iam._canonical_request("GET", path, q,
                                       {"host": "127.0.0.1:8333"}, ["host"],
                                       "UNSIGNED-PAYLOAD")
    q["X-Amz-Signature"] = iam._signature(secret, date, "us-east-1", "s3",
                                          amz_date, canonical)
    return q


def _verdict(fn):
    try:
        ident = fn()
        return ("ok", getattr(ident, "name", None) or ident[0].name)
    except (auth.S3Error, ref_auth.S3Error) as e:
        return ("error", e.code, e.status)


def test_auth_verdicts_equal_the_reference(planes):
    rng = np.random.default_rng(7)
    port_iam = auth.IdentityAccessManagement(IAM_CONFIG)
    ref_iam = ref_auth.IdentityAccessManagement(IAM_CONFIG)
    verdicts = {}
    for label, method, path, q, hdrs, sha in _seeded_requests(auth, rng):
        low = {k.lower(): v for k, v in hdrs.items()}
        for side, iam in (("port", port_iam), ("ref", ref_iam)):
            verdicts.setdefault(label, {})[side] = _verdict(
                lambda iam=iam: iam.authenticate(method, path, q, low, sha))
    now = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    presigned = {
        "presigned-good": _presigned_query(auth, "/bkt/k", 600, now),
        "presigned-expired": _presigned_query(auth, "/bkt/k", 60,
                                              "20200101T000000Z"),
        "presigned-wrong-secret": _presigned_query(auth, "/bkt/k", 600, now,
                                                   secret="bad"),
    }
    tampered = dict(presigned["presigned-good"])
    tampered["X-Amz-Expires"] = "601"
    presigned["presigned-tampered"] = tampered
    for label, q in presigned.items():
        for side, iam in (("port", port_iam), ("ref", ref_iam)):
            verdicts.setdefault(label, {})[side] = _verdict(
                lambda iam=iam, q=q: iam.authenticate(
                    "GET", "/bkt/k", q, {"host": "127.0.0.1:8333"},
                    "UNSIGNED-PAYLOAD"))
    # streaming: the seed signature, then the chunk chain
    data = rng.bytes(150_000)
    hdrs, ctx = auth.sign_streaming_request_v4(
        "PUT", "http://127.0.0.1:8333/bkt/s.bin", {}, len(data), AK, SK)
    low = {k.lower(): v for k, v in hdrs.items()}
    framed = chunked.encode_chunked_payload(data, ctx, chunk_size=65536)
    broken = framed.replace(b"chunk-signature=", b"chunk-signature=0", 1)
    for side, iam, ch in (("port", port_iam, chunked),
                          ("ref", ref_iam, ref_chunked)):
        ident, seed = iam.authenticate_streaming("PUT", "/bkt/s.bin", {}, low)
        assert ch.decode_chunked_payload(framed, seed) == data
        verdicts.setdefault("streaming-chain-broken", {})[side] = _verdict(
            lambda ch=ch, seed=seed: ch.decode_chunked_payload(broken, seed))
        verdicts.setdefault("streaming-seed", {})[side] = ("ok", ident.name)
    # V2: header and query
    date = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime())
    hv2 = {"date": date, "content-type": "text/plain"}
    to_sign = auth._string_to_sign_v2("PUT", "/bkt/v2.txt", {}, hv2, date)
    for label, secret in (("v2-header-good", SK), ("v2-header-bad", "x")):
        sig = auth.sign_v2(secret, to_sign)
        h = dict(hv2, authorization=f"AWS {AK}:{sig}")
        for side, mod, iam in (("port", auth, port_iam),
                               ("ref", ref_auth, ref_iam)):
            verdicts.setdefault(label, {})[side] = _verdict(
                lambda mod=mod, iam=iam, h=h: mod.verify_v2_header(
                    iam, "PUT", "/bkt/v2.txt", {}, h))
    for label, expires in (("v2-query-good", int(time.time()) + 600),
                           ("v2-query-expired", 1000)):
        ts = auth._string_to_sign_v2("GET", "/bkt/v2.txt", {}, {},
                                     str(expires))
        q = {"AWSAccessKeyId": AK, "Expires": str(expires),
             "Signature": auth.sign_v2(SK, ts)}
        for side, mod, iam in (("port", auth, port_iam),
                               ("ref", ref_auth, ref_iam)):
            verdicts.setdefault(label, {})[side] = _verdict(
                lambda mod=mod, iam=iam, q=q: mod.verify_v2_presigned(
                    iam, "GET", "/bkt/v2.txt", q, {}))
    for label, v in verdicts.items():
        assert v["port"] == v["ref"], (label, v)
    assert verdicts["header-good"]["port"] == ("ok", "admin")
    assert verdicts["header-reader"]["port"] == ("ok", "reader")
    assert verdicts["presigned-good"]["port"] == ("ok", "admin")
    assert verdicts["presigned-expired"]["port"][0] == "error"
    assert verdicts["header-tampered-sig"]["port"][1] == \
        "SignatureDoesNotMatch"
    assert verdicts["v2-header-good"]["port"] == ("ok", "admin")
    assert verdicts["streaming-chain-broken"]["port"][1] == \
        "SignatureDoesNotMatch"
    assert len(verdicts) >= 16


@pytest.mark.parametrize("size,chunk", [(0, 65536), (1, 65536),
                                        (200_001, 8192), (3 * 65536, 65536)])
def test_aws_chunked_framing_decodes_equal(size, chunk):
    data = np.random.default_rng(size).bytes(size)
    hdrs, ctx = auth.sign_streaming_request_v4(
        "PUT", "http://h/b/k", {}, size, AK, SK,
        amz_date="20261018T040000Z")
    rhdrs, rctx = ref_auth.sign_streaming_request_v4(
        "PUT", "http://h/b/k", {}, size, AK, SK,
        amz_date="20261018T040000Z")
    assert hdrs == rhdrs
    framed = chunked.encode_chunked_payload(data, ctx, chunk_size=chunk)
    assert framed == ref_chunked.encode_chunked_payload(data, rctx,
                                                        chunk_size=chunk)
    assert chunked.decode_chunked_payload(framed, ctx) == \
        ref_chunked.decode_chunked_payload(framed, rctx) == data
    assert chunked.decode_chunked_payload(framed, None) == data


def test_circuit_breakers_decide_alike():
    conf = {"global": {"Read": 3, "Write:count": 2, "Write:bytes": "1MB"},
            "buckets": {"hot": {"Write": 1, "List": 1}}}
    rng = np.random.default_rng(11)
    breakers = {"port": CircuitBreaker(conf), "ref": RefBreaker(conf)}
    held = {"port": [], "ref": []}
    trace = {"port": [], "ref": []}
    for _ in range(400):
        op = rng.integers(0, 3)
        action = ["Read", "Write", "List", "Tagging"][rng.integers(0, 4)]
        bucket = ["hot", "cold", ""][rng.integers(0, 3)]
        nbytes = int(rng.integers(0, 600_000))
        pick = float(rng.random())
        for side, br in breakers.items():
            if op < 2:
                cm = br.acquire(action, bucket, nbytes)
                try:
                    cm.__enter__()
                    held[side].append(cm)
                    trace[side].append("admit")
                except Exception as e:  # noqa: BLE001 — the refusal
                    trace[side].append((type(e).__name__, e.code, e.status))
            elif held[side]:
                held[side].pop(int(pick * len(held[side]))
                               ).__exit__(None, None, None)
                trace[side].append("release")
    assert trace["port"] == trace["ref"]
    assert "admit" in trace["port"] and any(
        isinstance(t, tuple) for t in trace["port"])


_ODD_KEYS = ["with space.txt", "plus+sign.txt", "per%cent.txt",
             "slash%2Fencoded.txt", "unicodé/ключ.txt", "a b/c+d/e%f.bin"]


def test_odd_keys_sign_store_and_list_alike(planes):
    """Keys an SDK sends percent-encoded and signs decoded: both gateways
    give the same verdict, store the same key, list it and read it back."""
    out = {}
    for side in ("port", "ref"):
        url = planes["gw"][side].url
        rows = [_call(url, "PUT", "/oddb")[0]]
        for i, k in enumerate(_ODD_KEYS):
            enc = urllib.parse.quote(k, safe="/")
            rows.append(_call(url, "PUT", f"/oddb/{enc}", f"v{i}".encode(),
                              sign_path=f"/oddb/{k}")[0])
            got = _call(url, "GET", f"/oddb/{enc}", sign_path=f"/oddb/{k}")
            rows.append((got[0], got[2]))
        listing = _call(url, "GET", "/oddb?list-type=2")
        rows.append(_norm(listing))
        keys = re.findall(rb"<Key>([^<]*)</Key>", listing[2])
        for k in keys:
            k = k.decode()
            enc = urllib.parse.quote(k, safe="/")
            got = _call(url, "GET", f"/oddb/{enc}", sign_path=f"/oddb/{k}")
            rows.append((k, got[0], got[2]))
        out[side] = rows
    assert out["port"] == out["ref"]
    assert sum(1 for r in out["port"] if r == 200) >= 4


def _live_needles(c) -> int:
    return sum(v.file_count for served in c["served"].values()
               for loc in served.vs.store.locations
               for v in list(loc.volumes.values()))


def test_streamed_put_and_get_of_64_mib_hold_the_bounds(planes):
    """A signed 64 MiB PutObject streams through the gateway into the
    port's filer (1 MiB chunks): the body queue holds at most
    fastweb.STREAM_BOUND, at most SWTPU_FILER_UPLOAD_CONC chunk uploads
    ride at once, and the GET streams back window by window; sha256 and
    the md5 ETag equal."""
    fs = planes["fs"]["port"]
    url = planes["gw"]["port"].url
    for k in fs.stream_peaks:
        fs.stream_peaks[k] = 0
    rng = np.random.default_rng(64)
    pieces = [rng.bytes(MiB) for _ in range(4)]
    sha, md5 = hashlib.sha256(), hashlib.md5()
    for i in range(64):
        sha.update(pieces[i % 4])
        md5.update(pieces[i % 4])
    assert _call(url, "PUT", "/bigb")[0] == 200
    headers = {"host": url, "Content-Length": str(64 * MiB)}
    headers = auth._client_sign("PUT", f"http://{url}/bigb/obj.bin", headers,
                                sha.hexdigest(), AK, SK, "us-east-1", "s3",
                                None)[0]
    conn = http.client.HTTPConnection(*url.split(":"), timeout=300)
    conn.request("PUT", "/bigb/obj.bin",
                 body=(pieces[i % 4] for i in range(64)), headers=headers)
    r = conn.getresponse()
    assert (r.status, r.getheader("ETag")) == (200, f'"{md5.hexdigest()}"')
    r.read()
    conn.close()
    peaks = dict(fs.stream_peaks)
    assert 0 < peaks["queued"] <= fastweb.STREAM_BOUND
    assert 1 <= peaks["inflight_chunks"] <= fs.upload_conc
    headers = auth.sign_request_v4("GET", f"http://{url}/bigb/obj.bin", {},
                                   b"", AK, SK)
    conn = http.client.HTTPConnection(*url.split(":"), timeout=300)
    conn.request("GET", "/bigb/obj.bin", headers=headers)
    r = conn.getresponse()
    assert r.status == 200 and r.getheader("Content-Length") == str(64 * MiB)
    got, n = hashlib.sha256(), 0
    while True:
        piece = r.read(MiB)
        if not piece:
            break
        got.update(piece)
        n += len(piece)
    conn.close()
    assert n == 64 * MiB and got.hexdigest() == sha.hexdigest()
    tc.wait_until(lambda: fs.stream_peaks["window"] > 0,
                  msg="the GET's peaks recorded")
    window = fs.read_window_views * fs.chunk_size
    assert fs.stream_peaks["window"] <= window
    assert fs.stream_peaks["sent_buffered"] <= window + (64 << 10)
    assert len(fs.filer.find_entry("/buckets/bigb", "obj.bin").chunks) == 64


def test_digest_mismatch_leaves_no_entry_and_no_needle(planes):
    """A streamed PUT signed over a sha256 its body does not have answers
    XAmzContentSHA256Mismatch, publishes no entry, and the chunks that
    landed are deleted again (the live needle count returns)."""
    c = planes["c"]
    url = planes["gw"]["port"].url
    assert _call(url, "PUT", "/shab")[0] == 200
    body = np.random.default_rng(3).bytes(5 * MiB + 17)
    before = _live_needles(c)
    headers = auth._client_sign(
        "PUT", f"http://{url}/shab/bad.bin",
        {"host": url, "Content-Length": str(len(body))},
        hashlib.sha256(b"something else").hexdigest(), AK, SK, "us-east-1",
        "s3", None)[0]
    conn = http.client.HTTPConnection(*url.split(":"), timeout=120)
    conn.request("PUT", "/shab/bad.bin", body=body, headers=headers)
    r = conn.getresponse()
    text = r.read()
    conn.close()
    assert r.status == 400 and b"XAmzContentSHA256Mismatch" in text
    fs = planes["fs"]["port"]
    tc.wait_until(lambda: _live_needles(c) == before, timeout=30,
                  msg="the landed chunks deleted")
    assert fs.filer.find_entry("/buckets/shab", "bad.bin") is None
    assert _call(url, "GET", "/shab/bad.bin")[0] == 404


def _write_objects(url: str, b: str, objs: dict, parts: list) -> dict:
    """PUT `objs` and a multipart object of `parts` into bucket `b` through
    the gateway at `url`; what a reader should find there."""
    assert _call(url, "PUT", f"/{b}")[0] == 200
    for k, v in objs.items():
        st = _call(url, "PUT", f"/{b}/{k}", v)
        assert st[0] == 200, (url, k, st)
    body = _call(url, "POST", f"/{b}/mp.bin?uploads")[2]
    up = _xml_text(body, "UploadId")
    etags = []
    for i, p in enumerate(parts, 1):
        resp = _call(url, "PUT", f"/{b}/mp.bin?partNumber={i}&uploadId={up}",
                     p)
        assert resp[0] == 200
        etags.append(resp[1]["etag"])
    xml = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>")
    assert _call(url, "POST", f"/{b}/mp.bin?uploadId={up}",
                 xml.encode())[0] == 200
    return {**objs, "mp.bin": b"".join(parts)}


def _read_back(url: str, b: str, objs: dict) -> None:
    for k, v in objs.items():
        got = _call(url, "GET", f"/{b}/{k}")
        assert (got[0], got[2]) == (200, v), (url, k)
    listing = _call(url, "GET", f"/{b}?list-type=2")
    assert re.findall(rb"<Key>([^<]*)</Key>", listing[2]) == \
        sorted(k.encode() for k in objs)


def test_gateways_over_each_others_filers(planes):
    """A port gateway over the JAX filer, through the port's FilerClient
    (as the `s3` verb runs it), writes objects past the chunk size and a
    multipart object, which the JAX gateway over that filer reads back;
    a JAX gateway in process over the port's FilerServer writes objects of
    at most one chunk (its streamed PUT and GET speak aiohttp's body and
    response, which the port's filer does not), which the port's gateway
    reads back. (The JAX gateway over the reference's FilerClient cannot
    write: that client's write_file returns no entry.)"""
    fs = planes["fs"]
    rng = np.random.default_rng(5)
    fc = FilerClient(fs["ref"].url)
    gw = S3Gateway(fc, port=tc.free_port_pair(),
                   iam_config=IAM_CONFIG).start()
    try:
        objs = _write_objects(gw.url, "xportoverref",
                              {"s.txt": b"small object",
                               "m.bin": rng.bytes(3 * MiB + 7)},
                              [rng.bytes(MiB + 3), rng.bytes(1000)])
        _read_back(planes["gw"]["ref"].url, "xportoverref", objs)
        _read_back(gw.url, "xportoverref", objs)
    finally:
        gw.stop()
        fc.close()
    ref_gw = RefS3Gateway(fs["port"], port=tc.free_port_pair(),
                          iam_config=IAM_CONFIG).start()
    try:
        objs = _write_objects(ref_gw.url, "xrefoverport",
                              {"s.txt": b"small object",
                               "m.bin": rng.bytes(MiB - 5)},
                              [rng.bytes(MiB - 3), rng.bytes(1000)])
        _read_back(planes["gw"]["port"].url, "xrefoverport", objs)
    finally:
        ref_gw.stop()


def test_unread_body_of_a_refused_put_keeps_the_connection(planes):
    """A large unsigned PUT answered 403 before its body was read: the
    gateway drains the body, the client reads its 403, and the same
    keep-alive connection serves the next request."""
    url = planes["gw"]["port"].url
    host, port = url.split(":")
    s = socket.create_connection((host, int(port)), 30)
    body = b"q" * (3 * MiB)
    s.sendall(b"PUT /diffb/unsigned.bin HTTP/1.1\r\nHost: h\r\n"
              b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n"
              + body)
    f = s.makefile("rb")
    first = f.readline()
    assert b" 403 " in first
    length = 0
    while True:
        line = f.readline()
        if line in (b"\r\n", b""):
            break
        if line.lower().startswith(b"content-length:"):
            length = int(line.split(b":")[1])
        assert not line.lower().startswith(b"connection: close")
    f.read(length)
    s.sendall(b"GET /diffb/x HTTP/1.1\r\nHost: h\r\n\r\n")
    assert b" 403 " in f.readline()
    s.close()
