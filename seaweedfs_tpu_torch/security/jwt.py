"""Minimal HS256 JSON Web Tokens (stdlib only).

Mirrors the behavior of reference weed/security/jwt.go: the master signs
`SeaweedFileIdClaims{fid}` (jwt.go:18-21) with an optional `exp`; filer
tokens carry only registered claims (jwt.go:26-28). Token extraction order
matches jwt.go:76-99: `jwt` query param, then `Authorization: Bearer`,
then a `jwt` cookie.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


class JwtError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _unb64url(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


_HEADER = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"},
                             separators=(",", ":")).encode())


def encode(claims: dict, key: bytes | str) -> str:
    if isinstance(key, str):
        key = key.encode()
    payload = _b64url(json.dumps(claims, separators=(",", ":"),
                                 sort_keys=True).encode())
    signing_input = f"{_HEADER}.{payload}".encode("ascii")
    sig = hmac.new(key, signing_input, hashlib.sha256).digest()
    return f"{_HEADER}.{payload}.{_b64url(sig)}"


def decode_jwt(token: str, key: bytes | str, *, now: float | None = None) -> dict:
    """Verify signature + time claims; returns the claims dict."""
    if isinstance(key, str):
        key = key.encode()
    parts = token.split(".")
    if len(parts) != 3:
        raise JwtError("malformed token")
    header_b64, payload_b64, sig_b64 = parts
    try:
        header = json.loads(_unb64url(header_b64))
        payload = json.loads(_unb64url(payload_b64))
        sig = _unb64url(sig_b64)
    except Exception as e:
        raise JwtError(f"bad encoding: {e}") from e
    if header.get("alg") != "HS256":
        raise JwtError(f"unexpected alg {header.get('alg')!r}")
    expect = hmac.new(key, f"{header_b64}.{payload_b64}".encode("ascii"),
                      hashlib.sha256).digest()
    if not hmac.compare_digest(sig, expect):
        raise JwtError("signature mismatch")
    t = time.time() if now is None else now
    if "exp" in payload and t > float(payload["exp"]):
        raise JwtError("token expired")
    if "nbf" in payload and t < float(payload["nbf"]):
        raise JwtError("token not yet valid")
    return payload


def gen_jwt_for_volume_server(signing_key: str | bytes,
                              expires_after_sec: int, file_id: str) -> str:
    """Single-file write token, minted by the master on Assign
    (reference jwt.go:30 GenJwtForVolumeServer). Empty key -> empty token."""
    if not signing_key:
        return ""
    claims: dict = {"fid": file_id}
    if expires_after_sec > 0:
        claims["exp"] = int(time.time()) + expires_after_sec
    return encode(claims, signing_key)


def gen_jwt_for_fid_range(signing_key: str | bytes,
                          expires_after_sec: int, vid: int,
                          start_key: int, count: int, cookie: int) -> str:
    """Range-scoped write token for a fid-range lease (TPU extension;
    the reference's Assign(count=N) still mints a single-fid token,
    master_grpc_server_assign.go). One signature covers the whole leased
    key range [start_key, start_key+count) on `vid`, so a bulk client
    can write N needles without N master-minted tokens. Claim layout:
    `rng = "<vid>,<start_hex>,<count>,<cookie_hex>"` — hex keys avoid
    any JSON big-int precision questions for snowflake-sized keys."""
    if not signing_key:
        return ""
    claims: dict = {"rng": f"{vid},{start_key:x},{count},{cookie:08x}"}
    if expires_after_sec > 0:
        claims["exp"] = int(time.time()) + expires_after_sec
    return encode(claims, signing_key)


def parse_range_claim(claims: dict) -> "tuple[int, int, int, int] | None":
    """(vid, start_key, count, cookie) from a range token's claims, or
    None when the token carries no (or a malformed) `rng` claim."""
    rng = claims.get("rng", "")
    if not rng:
        return None
    try:
        vid_s, start_s, count_s, cookie_s = rng.split(",")
        return int(vid_s), int(start_s, 16), int(count_s), int(cookie_s, 16)
    except ValueError:
        return None


def range_covers_fid(claims: dict, fid: str) -> bool:
    """True when the token's leased range covers `fid` (vid, key within
    [start, start+count), cookie equal)."""
    rng = parse_range_claim(claims)
    if rng is None:
        return False
    vid, start, count, cookie = rng
    # one fid grammar for the whole tree (lazy: keep this module
    # importable without the storage package on the path)
    from ..storage.types import parse_file_id
    try:
        f_vid, f_key, f_cookie = parse_file_id(fid)
    except ValueError:
        return False
    return (f_vid == vid and f_cookie == cookie
            and start <= f_key < start + count)


def peek_claims(token: str) -> dict:
    """UNVERIFIED claims decode — for a client reading its OWN token's
    exp/rng (e.g. deriving a lease TTL from the range JWT the master
    minted when the transport carried no TTL field). Never use for
    authorization: the signature is not checked."""
    try:
        return json.loads(_unb64url(token.split(".")[1]))
    except Exception:  # noqa: BLE001 — opaque/foreign token: no claims
        return {}


def gen_jwt_for_filer_server(signing_key: str | bytes,
                             expires_after_sec: int) -> str:
    """Filer-API token used by gateways (jwt.go:53 GenJwtForFilerServer)."""
    if not signing_key:
        return ""
    claims: dict = {}
    if expires_after_sec > 0:
        claims["exp"] = int(time.time()) + expires_after_sec
    return encode(claims, signing_key)


def derive_cluster_key(signing_key: str) -> str:
    """Derive the gRPC-plane bearer key from the HTTP signing key, so a
    cluster token sniffed off plaintext gRPC metadata can never validate
    as a volume-server write/read JWT (the reference keeps the planes
    apart with a distinct filer key + mTLS, security/tls.go:26)."""
    if not signing_key:
        return ""
    return hmac.new(signing_key.encode(), b"swtpu-grpc-cluster-v1",
                    hashlib.sha256).hexdigest()


def jwt_from_request(query: dict, headers) -> str:
    """Extract a token the way jwt.go:76-99 does: query param, bearer
    header, cookie. `query` is a mapping; `headers` any mapping with .get."""
    tok = query.get("jwt", "")
    if tok:
        return tok
    bearer = headers.get("Authorization", "") or headers.get("authorization", "")
    if bearer.startswith("Bearer ") or bearer.startswith("BEARER "):
        return bearer[7:].strip()
    cookie = headers.get("Cookie", "") or headers.get("cookie", "")
    for part in cookie.split(";"):
        k, _, v = part.strip().partition("=")
        if k == "jwt":
            return v
    return ""
