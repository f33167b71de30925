"""S3 authentication: AWS Signature V4 (header + presigned query) and
identity/action management.

Reference: weed/s3api/auth_credentials.go (identities + Action model),
auth_signature_v4.go (sigv4 verification), s3api/s3_constants. Identities
come from a dict/JSON config shaped like the reference's s3.json:
{"identities": [{"name": ..., "credentials": [{"accessKey","secretKey"}],
"actions": ["Read","Write","List","Tagging","Admin", ...]}]}.
Actions may be suffixed ":bucket" to scope them.

The port's copy of seaweedfs_tpu/s3/auth.py, whole: the gateway's
verifier (SigV4 in the header, presigned and streaming; the legacy V2
header and query schemes; browser post policies), identities and actions,
and the client signers (`sign_request_v4`, `sign_streaming_request_v4`,
`_client_sign`) that storage/backend.S3Remote and the S3-family tiers
use. No difference in behaviour; it imports no torch.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass, field

ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"
ACTION_ADMIN = "Admin"


class S3Error(Exception):
    def __init__(self, code: str, message: str, status: int):
        super().__init__(message)
        self.code, self.message, self.status = code, message, status


ErrAccessDenied = lambda: S3Error("AccessDenied", "Access Denied.", 403)  # noqa: E731
ErrSignatureMismatch = lambda: S3Error(  # noqa: E731
    "SignatureDoesNotMatch",
    "The request signature we calculated does not match the signature you provided.",
    403)
ErrInvalidAccessKey = lambda: S3Error(  # noqa: E731
    "InvalidAccessKeyId",
    "The AWS Access Key Id you provided does not exist in our records.", 403)
ErrRequestExpired = lambda: S3Error(  # noqa: E731
    "AccessDenied", "Request has expired", 403)

MAX_CLOCK_SKEW_S = 15 * 60  # AWS allows +-15 min on x-amz-date


def _amz_time(s: str) -> float:
    import calendar
    import time as _time

    return calendar.timegm(_time.strptime(s, "%Y%m%dT%H%M%SZ"))


@dataclass
class Identity:
    name: str
    credentials: dict[str, str] = field(default_factory=dict)  # access -> secret
    actions: list[str] = field(default_factory=list)

    def allows(self, action: str, bucket: str) -> bool:
        for a in self.actions:
            if a == ACTION_ADMIN:
                return True
            act, _, scope = a.partition(":")
            if act == action and (not scope or scope == bucket):
                return True
        return False


class IdentityAccessManagement:
    """Access-key → identity lookup + sigv4 verification."""

    def __init__(self, config: dict | None = None):
        self._by_access_key: dict[str, tuple[Identity, str]] = {}
        self.enabled = False
        if config:
            self.load(config)

    def load(self, config: dict) -> None:
        # build then swap atomically — the gateway authenticates on other
        # threads while the IAM API hot-reloads (GIL makes the rebind safe)
        table: dict[str, tuple[Identity, str]] = {}
        for ident_cfg in config.get("identities", []):
            ident = Identity(name=ident_cfg["name"],
                             actions=list(ident_cfg.get("actions", [])))
            for cred in ident_cfg.get("credentials", []):
                ident.credentials[cred["accessKey"]] = cred["secretKey"]
                table[cred["accessKey"]] = (ident, cred["secretKey"])
        self._by_access_key = table
        self.enabled = bool(table)

    def lookup(self, access_key: str) -> tuple[Identity, str]:
        hit = self._by_access_key.get(access_key)
        if hit is None:
            raise ErrInvalidAccessKey()
        return hit

    # -- sigv4 --------------------------------------------------------------
    def authenticate(self, method: str, path: str, query: dict[str, str],
                     headers: dict[str, str], payload_hash: str) -> Identity:
        """Verify a sigv4-signed request; returns the matching identity.
        Raises S3Error on failure. headers keys must be lower-case."""
        auth = headers.get("authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256 "):
            return self._auth_header(method, path, query, headers,
                                     payload_hash, auth)
        if query.get("X-Amz-Algorithm") == "AWS4-HMAC-SHA256":
            return self._auth_presigned(method, path, query, headers)
        raise ErrAccessDenied()

    def _auth_header(self, method, path, query, headers, payload_hash, auth):
        return self._auth_header_ctx(method, path, query, headers,
                                     payload_hash, auth, want_ctx=False)[0]

    def _auth_header_ctx(self, method, path, query, headers, payload_hash,
                         auth, want_ctx=True):
        """Verify; with want_ctx also return the signing context the
        streaming-chunked verifier chains off (reference
        calculateSeedSignature, chunked_reader_v4.go)."""
        fields = {}
        for part in auth[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v
        cred = fields.get("Credential", "").split("/")
        if len(cred) != 5:
            raise ErrSignatureMismatch()
        access_key, date, region, service, _ = cred
        ident, secret = self.lookup(access_key)
        self._check_freshness(headers.get("x-amz-date", ""))
        signed_headers = fields.get("SignedHeaders", "").split(";")
        canonical = self._canonical_request(
            method, path, query, headers, signed_headers, payload_hash)
        amz_date = headers.get("x-amz-date", "")
        key = self._signing_key(secret, date, region, service)
        sig = self._signature_with_key(key, date, region, service, amz_date,
                                       canonical)
        if not hmac.compare_digest(sig, fields.get("Signature", "")):
            raise ErrSignatureMismatch()
        if not want_ctx:
            return ident, None
        from .chunked import SeedContext
        ctx = SeedContext(
            signing_key=key, amz_date=amz_date,
            scope=f"{date}/{region}/{service}/aws4_request",
            seed_signature=sig)
        return ident, ctx

    def authenticate_streaming(self, method, path, query, headers):
        """Header-auth a STREAMING-AWS4-HMAC-SHA256-PAYLOAD request and hand
        back the seed context for per-chunk verification."""
        auth = headers.get("authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            raise ErrAccessDenied()
        return self._auth_header_ctx(
            method, path, query, headers,
            "STREAMING-AWS4-HMAC-SHA256-PAYLOAD", auth)

    def _auth_presigned(self, method, path, query, headers):
        cred = query.get("X-Amz-Credential", "").split("/")
        if len(cred) != 5:
            raise ErrSignatureMismatch()
        access_key, date, region, service, _ = cred
        ident, secret = self.lookup(access_key)
        self._check_presigned_expiry(query.get("X-Amz-Date", ""),
                                     query.get("X-Amz-Expires", ""))
        signed_headers = query.get("X-Amz-SignedHeaders", "host").split(";")
        q = {k: v for k, v in query.items() if k != "X-Amz-Signature"}
        canonical = self._canonical_request(
            method, path, q, headers, signed_headers, "UNSIGNED-PAYLOAD")
        sig = self._signature(secret, date, region, service,
                              query.get("X-Amz-Date", ""), canonical)
        if not hmac.compare_digest(sig, query.get("X-Amz-Signature", "")):
            raise ErrSignatureMismatch()
        return ident

    @staticmethod
    def _check_freshness(amz_date: str) -> None:
        import time as _time

        try:
            ts = _amz_time(amz_date)
        except ValueError:
            raise ErrSignatureMismatch() from None
        if abs(_time.time() - ts) > MAX_CLOCK_SKEW_S:  # swtpu-lint: disable=wallclock-duration (vs client clock)
            raise S3Error("RequestTimeTooSkewed",
                          "The difference between the request time and the "
                          "server's time is too large.", 403)

    @staticmethod
    def _check_presigned_expiry(amz_date: str, expires: str) -> None:
        import time as _time

        try:
            ts = _amz_time(amz_date)
            ttl = int(expires) if expires else 604800
        except ValueError:
            raise ErrSignatureMismatch() from None
        if _time.time() > ts + min(ttl, 604800):  # 7-day cap like AWS  # swtpu-lint: disable=wallclock-duration (vs client clock)
            raise ErrRequestExpired()

    @staticmethod
    def _canonical_request(method, path, query, headers, signed_headers,
                           payload_hash) -> str:
        enc_path = urllib.parse.quote(path, safe="/~")
        q = "&".join(
            f"{urllib.parse.quote(k, safe='~')}={urllib.parse.quote(v, safe='~')}"
            for k, v in sorted(query.items()))
        hdrs = "".join(f"{h}:{' '.join(headers.get(h, '').split())}\n"
                       for h in signed_headers)
        return "\n".join([method, enc_path, q, hdrs, ";".join(signed_headers),
                          payload_hash])

    @staticmethod
    def _signing_key(secret, date, region, service) -> bytes:
        def h(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = h(f"AWS4{secret}".encode(), date)
        k = h(k, region)
        k = h(k, service)
        return h(k, "aws4_request")

    @staticmethod
    def _signature_with_key(key, date, region, service, amz_date,
                            canonical) -> str:
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date,
                         f"{date}/{region}/{service}/aws4_request",
                         hashlib.sha256(canonical.encode()).hexdigest()])
        return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()

    @classmethod
    def _signature(cls, secret, date, region, service, amz_date,
                   canonical) -> str:
        return cls._signature_with_key(
            cls._signing_key(secret, date, region, service),
            date, region, service, amz_date, canonical)


def _client_sign(method: str, url: str, headers: dict[str, str],
                 payload_hash: str, access_key: str, secret_key: str,
                 region: str, service: str, amz_date: "str | None",
                 ) -> tuple[dict[str, str], str, str, str]:
    """Shared client-side signing core. headers must already include any
    x-amz-* extras to sign. Returns (headers+Authorization, sig, now, date)."""
    import datetime

    u = urllib.parse.urlsplit(url)
    now = amz_date or datetime.datetime.now(datetime.timezone.utc
                                            ).strftime("%Y%m%dT%H%M%SZ")
    date = now[:8]
    out = dict(headers)
    out.setdefault("host", u.netloc)
    out["x-amz-date"] = now
    out["x-amz-content-sha256"] = payload_hash
    signed = sorted(h.lower() for h in out)
    query = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
    iam = IdentityAccessManagement()
    canonical = iam._canonical_request(method, u.path or "/", query,
                                       {k.lower(): v for k, v in out.items()},
                                       signed, payload_hash)
    sig = iam._signature(secret_key, date, region, service, now, canonical)
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{date}/{region}/{service}/"
        f"aws4_request, SignedHeaders={';'.join(signed)}, Signature={sig}")
    return out, sig, now, date


def sign_request_v4(method: str, url: str, headers: dict[str, str],
                    payload: bytes, access_key: str, secret_key: str,
                    region: str = "us-east-1", service: str = "s3",
                    amz_date: str | None = None) -> dict[str, str]:
    """Client-side signer (used by tests and the replication s3 sink).
    Returns headers with Authorization added."""
    return _client_sign(method, url, headers,
                        hashlib.sha256(payload).hexdigest(), access_key,
                        secret_key, region, service, amz_date)[0]


def sign_streaming_request_v4(method: str, url: str, headers: dict[str, str],
                              decoded_length: int, access_key: str,
                              secret_key: str, region: str = "us-east-1",
                              service: str = "s3",
                              amz_date: str | None = None):
    """Client-side signer for STREAMING-AWS4-HMAC-SHA256-PAYLOAD uploads.

    Returns (headers_with_authorization, SeedContext); frame the body with
    chunked.encode_chunked_payload(data, ctx) afterwards. Mirrors what the
    AWS SDKs do for large PUTs (reference chunked_reader_v4.go's client side).
    """
    from .chunked import STREAMING_PAYLOAD, SeedContext

    pre = dict(headers)
    pre["x-amz-decoded-content-length"] = str(decoded_length)
    pre["content-encoding"] = "aws-chunked"
    out, sig, now, date = _client_sign(method, url, pre, STREAMING_PAYLOAD,
                                       access_key, secret_key, region,
                                       service, amz_date)
    ctx = SeedContext(
        signing_key=IdentityAccessManagement._signing_key(
            secret_key, date, region, service),
        amz_date=now, scope=f"{date}/{region}/{service}/aws4_request",
        seed_signature=sig)
    return out, ctx


# ---------------------------------------------------------------------------
# Signature V2 (reference auth_signature_v2.go) — legacy SDK compatibility.
# ---------------------------------------------------------------------------

_SUBRESOURCES = ("acl", "delete", "lifecycle", "location", "logging",
                 "notification", "partNumber", "policy", "requestPayment",
                 "tagging", "torrent", "uploadId", "uploads", "versionId",
                 "versioning", "versions", "website")


def _canonical_resource_v2(path: str, query: dict) -> str:
    sub = "&".join(f"{k}={query[k]}" if query[k] else k
                   for k in sorted(query) if k in _SUBRESOURCES)
    return path + (f"?{sub}" if sub else "")


def _canonical_amz_headers_v2(headers: dict) -> str:
    amz = sorted((k, v) for k, v in headers.items()
                 if k.startswith("x-amz-"))
    return "".join(f"{k}:{v}\n" for k, v in amz)


def _string_to_sign_v2(method: str, path: str, query: dict,
                       headers: dict, date_or_expires: str) -> str:
    return "\n".join([
        method,
        headers.get("content-md5", ""),
        headers.get("content-type", ""),
        date_or_expires,
    ]) + "\n" + _canonical_amz_headers_v2(headers) \
        + _canonical_resource_v2(path, query)


def sign_v2(secret: str, to_sign: str) -> str:
    import base64
    return base64.b64encode(
        hmac.new(secret.encode(), to_sign.encode(),
                 hashlib.sha1).digest()).decode()


def verify_v2_header(iam: "IdentityAccessManagement", method: str, path: str,
                     query: dict, headers: dict) -> "Identity":
    """`Authorization: AWS AKID:sig` (doesSignatureMatchV2)."""
    auth = headers.get("authorization", "")
    cred = auth[len("AWS "):]
    access_key, _, sig = cred.partition(":")
    ident, secret = iam.lookup(access_key)
    # with x-amz-date present the Date slot is empty (the amz date rides
    # the canonical amz headers instead)
    date = "" if headers.get("x-amz-date") else headers.get("date", "")
    want = sign_v2(secret, _string_to_sign_v2(method, path, query, headers,
                                              date))
    if not hmac.compare_digest(want, sig):
        raise ErrSignatureMismatch()
    return ident


def verify_v2_presigned(iam: "IdentityAccessManagement", method: str,
                        path: str, query: dict, headers: dict) -> "Identity":
    """?AWSAccessKeyId=&Expires=&Signature= (doesPresignedSignatureMatchV2)."""
    import time as _time
    ident, secret = iam.lookup(query.get("AWSAccessKeyId", ""))
    expires = query.get("Expires", "0")
    try:
        if _time.time() > int(expires):  # swtpu-lint: disable=wallclock-duration (vs client clock)
            raise ErrRequestExpired()
    except ValueError:
        raise ErrSignatureMismatch() from None
    q = {k: v for k, v in query.items()
         if k not in ("AWSAccessKeyId", "Expires", "Signature")}
    want = sign_v2(secret, _string_to_sign_v2(method, path, q, headers,
                                              expires))
    if not hmac.compare_digest(want, query.get("Signature", "")):
        raise ErrSignatureMismatch()
    return ident


def verify_post_policy(iam: "IdentityAccessManagement",
                       form: dict) -> "Identity":
    """Browser form upload (reference policy_check + post-policy): the v4
    signature covers the base64 policy document; expiration and bucket/key
    conditions are enforced."""
    import base64
    import datetime
    import json as _json

    policy_b64 = form.get("policy", "")
    cred = form.get("x-amz-credential", "").split("/")
    if len(cred) != 5:
        raise ErrSignatureMismatch()
    access_key, date, region, service, _ = cred
    ident, secret = iam.lookup(access_key)
    key = IdentityAccessManagement._signing_key(secret, date, region, service)
    want = hmac.new(key, policy_b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, form.get("x-amz-signature", "")):
        raise ErrSignatureMismatch()
    try:
        policy = _json.loads(base64.b64decode(policy_b64))
        exp = policy.get("expiration", "")
        exp_ts = datetime.datetime.fromisoformat(
            exp.replace("Z", "+00:00")).timestamp()
    except Exception:  # noqa: BLE001
        raise S3Error("InvalidPolicyDocument", "malformed policy", 400) \
            from None
    import time as _time
    if _time.time() > exp_ts:  # swtpu-lint: disable=wallclock-duration (vs client clock)
        raise ErrRequestExpired()
    # enforce the conditions we understand (bucket equality, key prefix)
    for cond in policy.get("conditions", []):
        if isinstance(cond, dict):
            for k, v in cond.items():
                if k in ("bucket", "key") and form.get(k) != v:
                    raise S3Error("AccessDenied",
                                  f"policy condition failed on {k}", 403)
        elif isinstance(cond, list) and len(cond) == 3:
            op, field, want = cond[0], str(cond[1]).lstrip("$"), cond[2]
            have = str(form.get(field, ""))
            if op == "starts-with":
                ok = have.startswith(want)
            elif op == "eq":
                ok = have == str(want)
            else:
                # refuse rather than silently skip: an unknown operator is
                # a restriction we cannot honor
                raise S3Error("InvalidPolicyDocument",
                              f"unsupported condition operator {op!r}", 400)
            if not ok:
                raise S3Error("AccessDenied",
                              f"policy condition failed on {field}", 403)
    return ident
