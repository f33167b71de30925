"""Access guard: white list -> basic auth -> JWT, in that order.

Reference: weed/security/guard.go:42 (Guard), :55 (NewGuard), and the
volume server's write-path JWT check (weed/server/volume_server.go guard
wiring; volume_server_handlers_write.go). A guard with no white list, no
credentials, and no signing keys allows everything — security is opt-in,
matching the reference's default `security.toml` (all keys empty).
"""

from __future__ import annotations

import base64
import ipaddress

from . import jwt as _jwt


class Guard:
    def __init__(self,
                 white_list: list[str] | None = None,
                 signing_key: str = "",
                 expires_after_sec: int = 10,
                 read_signing_key: str = "",
                 read_expires_after_sec: int = 60,
                 username: str = "",
                 password: str = ""):
        self.white_list = list(white_list or [])
        self.signing_key = signing_key
        self.expires_after_sec = expires_after_sec
        self.read_signing_key = read_signing_key
        self.read_expires_after_sec = read_expires_after_sec
        self.username = username
        self.password = password

    # -- policy flags --------------------------------------------------

    @property
    def is_write_active(self) -> bool:
        return bool(self.white_list) or bool(self.signing_key)

    @property
    def is_read_active(self) -> bool:
        return bool(self.read_signing_key)

    # -- checks --------------------------------------------------------

    def white_listed(self, remote_ip: str) -> bool:
        if not self.white_list:
            return False
        try:
            ip = ipaddress.ip_address(remote_ip)
        except ValueError:
            return False
        for item in self.white_list:
            try:
                if "/" in item:
                    if ip in ipaddress.ip_network(item, strict=False):
                        return True
                elif ip == ipaddress.ip_address(item):
                    return True
            except ValueError:
                continue
        return False

    def basic_auth_ok(self, headers) -> bool:
        if not self.username:
            return False
        auth = headers.get("Authorization", "") or headers.get("authorization", "")
        if not auth.startswith("Basic "):
            return False
        try:
            user, _, pw = base64.b64decode(auth[6:]).decode().partition(":")
        except Exception:
            return False
        return user == self.username and pw == self.password

    def _admit_write(self, remote_ip: str, query: dict, headers,
                     ) -> "tuple[bool | None, str, dict]":
        """Shared write-admission preamble (guard.go:27-28 ordering:
        write-active, whitelist, basic auth, then jwt). Returns
        (decision, reason, claims): decision True/False is final;
        None means 'token decoded OK — caller applies its scope check
        on claims'."""
        if not self.is_write_active:
            return True, "", {}
        if self.white_listed(remote_ip):
            return True, "", {}
        if self.basic_auth_ok(headers):
            return True, "", {}
        if not self.signing_key:
            return False, "not in white list", {}
        token = _jwt.jwt_from_request(query, headers)
        if not token:
            return False, "missing jwt", {}
        try:
            return None, "", _jwt.decode_jwt(token, self.signing_key)
        except _jwt.JwtError as e:
            return False, str(e), {}

    def check_write(self, remote_ip: str, query: dict, headers,
                    fid: str = "") -> tuple[bool, str]:
        """Gate a mutating request. Returns (allowed, reason)."""
        decision, why, claims = self._admit_write(remote_ip, query, headers)
        if decision is not None:
            return decision, why
        # The master scopes write tokens to one file id (jwt.go:18-21)
        # and the volume server demands an EXACT match
        # (volume_server_handlers.go:199) — an empty claimed fid must
        # NOT act as a wildcard on fid-scoped checks, else any
        # filer-style token doubles as a write-everything pass. A
        # range token (fid-range lease, jwt.py gen_jwt_for_fid_range)
        # is accepted for any fid INSIDE its leased range, so leased
        # clients can also issue plain per-needle PUTs.
        if fid and "rng" in claims:
            if _jwt.range_covers_fid(claims, fid):
                return True, ""
            return False, "jwt fid outside leased range"
        claimed = claims.get("fid", "")
        if fid and claimed != fid:
            return False, "jwt fid mismatch"
        return True, ""

    def check_bulk(self, remote_ip: str, query: dict, headers, vid: int,
                   keys, cookie: int) -> tuple[bool, str]:
        """Gate one bulk-PUT frame with a SINGLE token validation: the
        range token must cover every needle key in the frame (all share
        one cookie by lease construction). Admission ordering is
        check_write's, via the shared preamble."""
        decision, why, claims = self._admit_write(remote_ip, query, headers)
        if decision is not None:
            return decision, why
        rng = _jwt.parse_range_claim(claims)
        if rng is None:
            return False, "bulk write requires a range jwt"
        r_vid, r_start, r_count, r_cookie = rng
        if r_vid != vid:
            return False, "jwt vid mismatch"
        if r_cookie != cookie:
            return False, "jwt cookie mismatch"
        lo, hi = min(keys), max(keys)
        if lo < r_start or hi >= r_start + r_count:
            return False, "jwt fid outside leased range"
        return True, ""

    def check_read(self, remote_ip: str, query: dict, headers,
                   fid: str = "") -> tuple[bool, str]:
        if not self.is_read_active:
            return True, ""
        if self.white_listed(remote_ip):
            return True, ""
        token = _jwt.jwt_from_request(query, headers)
        if not token:
            return False, "missing jwt"
        try:
            claims = _jwt.decode_jwt(token, self.read_signing_key)
        except _jwt.JwtError as e:
            return False, str(e)
        claimed = claims.get("fid", "")
        if fid and claimed != fid:
            return False, "jwt fid mismatch"
        return True, ""

    def check_ip(self, remote_ip: str) -> tuple[bool, str]:
        """IP-whitelist-only gate for non-mutating endpoints (the reference
        applies just guard.WhiteList to master HTTP handlers)."""
        if not self.white_list:
            return True, ""
        if self.white_listed(remote_ip):
            return True, ""
        return False, "not in white list"
