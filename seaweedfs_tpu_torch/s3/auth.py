"""Client-side AWS Signature V4 signing.

The port's copy of the client signer of seaweedfs_tpu/s3/auth.py
(`sign_request_v4` and `_client_sign`, with the canonical request, signing
key and signature they take from `IdentityAccessManagement`). The gateway's
verifier, IAM and the V2 and streaming signers are not ported; the S3-family
remote tiers (storage/backend.S3Remote) only sign requests.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse


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


def _signing_key(secret, date, region, service) -> bytes:
    def h(key, msg):
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = h(f"AWS4{secret}".encode(), date)
    k = h(k, region)
    k = h(k, service)
    return h(k, "aws4_request")


def _signature(secret, date, region, service, amz_date, canonical) -> str:
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date,
                     f"{date}/{region}/{service}/aws4_request",
                     hashlib.sha256(canonical.encode()).hexdigest()])
    return hmac.new(_signing_key(secret, date, region, service), sts.encode(),
                    hashlib.sha256).hexdigest()


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
    canonical = _canonical_request(method, u.path or "/", query,
                                   {k.lower(): v for k, v in out.items()},
                                   signed, payload_hash)
    sig = _signature(secret_key, date, region, service, now, canonical)
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{date}/{region}/{service}/"
        f"aws4_request, SignedHeaders={';'.join(signed)}, Signature={sig}")
    return out, sig, now, date


def sign_request_v4(method: str, url: str, headers: dict[str, str],
                    payload: bytes, access_key: str, secret_key: str,
                    region: str = "us-east-1", service: str = "s3",
                    amz_date: str | None = None) -> dict[str, str]:
    """Client-side signer (the S3-family remote tiers). Returns headers with
    Authorization added."""
    return _client_sign(method, url, headers,
                        hashlib.sha256(payload).hexdigest(), access_key,
                        secret_key, region, service, amz_date)[0]
