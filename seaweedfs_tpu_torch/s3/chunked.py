"""Streaming-chunked sigv4 payload decoding + per-chunk verification.

Reference: weed/s3api/chunked_reader_v4.go — AWS SDK clients send large PUTs
with `x-amz-content-sha256: STREAMING-AWS4-HMAC-SHA256-PAYLOAD` and an
aws-chunked body:

    <hex-size>;chunk-signature=<sig64>\r\n<bytes>\r\n ... 0;chunk-signature=<sig>\r\n\r\n

Every chunk's signature chains off the previous one (the request's seed
signature first):

    sig_i = HMAC(signing_key, "AWS4-HMAC-SHA256-PAYLOAD" \n amz_date \n scope
                 \n sig_{i-1} \n sha256("") \n sha256(chunk_bytes))

Also supports the unsigned trailer variant's plain framing
(STREAMING-UNSIGNED-PAYLOAD-TRAILER) by skipping signature checks.

The port's copy of seaweedfs_tpu/s3/chunked.py, unchanged in behaviour.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from .auth import S3Error, ErrSignatureMismatch

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
STREAMING_UNSIGNED = "STREAMING-UNSIGNED-PAYLOAD-TRAILER"


@dataclass
class SeedContext:
    """Signing context carried from the header auth to the chunk verifier."""
    signing_key: bytes   # derived AWS4 key (date/region/service/aws4_request)
    amz_date: str
    scope: str           # "{date}/{region}/{service}/aws4_request"
    seed_signature: str


def _chunk_string_to_sign(ctx: SeedContext, prev_sig: str,
                          chunk: bytes) -> str:
    return "\n".join([
        "AWS4-HMAC-SHA256-PAYLOAD", ctx.amz_date, ctx.scope, prev_sig,
        EMPTY_SHA256, hashlib.sha256(chunk).hexdigest()])


def sign_chunk(ctx: SeedContext, prev_sig: str, chunk: bytes) -> str:
    return hmac.new(ctx.signing_key,
                    _chunk_string_to_sign(ctx, prev_sig, chunk).encode(),
                    hashlib.sha256).hexdigest()


def decode_chunked_payload(body: bytes, ctx: "SeedContext | None") -> bytes:
    """Strip aws-chunked framing; verify the signature chain when ctx given.

    Raises S3Error on malformed framing or a broken chain (the reference
    returns ErrSignatureDoesNotMatch mid-stream the same way).
    """
    out = bytearray()
    pos = 0
    prev_sig = ctx.seed_signature if ctx else ""
    while True:
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            raise S3Error("IncompleteBody",
                          "chunked encoding truncated", 400)
        header = body[pos:nl].decode("latin-1")
        size_hex, _, ext = header.partition(";")
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise S3Error("IncompleteBody",
                          f"bad chunk size {size_hex!r}", 400) from None
        if size < 0:
            raise S3Error("IncompleteBody",
                          f"negative chunk size {size_hex!r}", 400)
        sig = ""
        for part in ext.split(";"):
            k, _, v = part.strip().partition("=")
            if k == "chunk-signature":
                sig = v
        data_start = nl + 2
        data_end = data_start + size
        if data_end > len(body):
            raise S3Error("IncompleteBody", "chunk data truncated", 400)
        chunk = bytes(body[data_start:data_end])
        if ctx is not None:
            want = sign_chunk(ctx, prev_sig, chunk)
            if not sig or not hmac.compare_digest(want, sig):
                raise ErrSignatureMismatch()
            prev_sig = want
        out += chunk
        # final chunk (size 0) ends the stream; trailers (if any) follow
        if size == 0:
            break
        pos = data_end
        if body[pos:pos + 2] == b"\r\n":
            pos += 2
    return bytes(out)


def encode_chunked_payload(data: bytes, ctx: SeedContext,
                           chunk_size: int = 64 * 1024) -> bytes:
    """Client-side encoder (tests + sdk-less clients): frame and sign."""
    out = bytearray()
    prev = ctx.seed_signature
    offsets = list(range(0, len(data), chunk_size)) or [0]
    for off in offsets:
        chunk = data[off:off + chunk_size]
        if not chunk:
            break
        sig = sign_chunk(ctx, prev, chunk)
        out += f"{len(chunk):x};chunk-signature={sig}\r\n".encode()
        out += chunk + b"\r\n"
        prev = sig
    final = sign_chunk(ctx, prev, b"")
    out += f"0;chunk-signature={final}\r\n\r\n".encode()
    return bytes(out)
