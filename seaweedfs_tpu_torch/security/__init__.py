"""Security: JWT write/read authz and access guard.

TPU-native re-design of the reference's weed/security package
(jwt.go:30 GenJwtForVolumeServer, guard.go:42 Guard). Masters mint an
HS256 JWT scoped to a single file id on Assign; volume servers verify it
before accepting writes (and optionally reads). The guard also supports an
IP white list and basic auth, checked in that order (guard.go:27-28).

The port's copy of the JAX package's security/ (jwt.py and guard.py): the
same tokens byte for byte, the same guard decisions; security/cipher.py
is the filer's per-chunk AES-GCM (imported by the filer, not here).
"""

from .jwt import (
    gen_jwt_for_volume_server,
    gen_jwt_for_fid_range,
    gen_jwt_for_filer_server,
    decode_jwt,
    jwt_from_request,
    parse_range_claim,
    range_covers_fid,
    JwtError,
)
from .guard import Guard

__all__ = [
    "gen_jwt_for_volume_server",
    "gen_jwt_for_fid_range",
    "gen_jwt_for_filer_server",
    "decode_jwt",
    "jwt_from_request",
    "parse_range_claim",
    "range_covers_fid",
    "JwtError",
    "Guard",
]
