"""Per-chunk encryption at rest (reference weed/util/cipher.go).

Each chunk gets a random AES-256-GCM key stored in its FileChunk.cipher_key
metadata (never on the volume server, which only ever sees ciphertext); the
nonce rides in front of the ciphertext. Matches the reference's model: the
filer namespace is trusted, the blob plane is not.

The port's copy of seaweedfs_tpu/security/cipher.py. `cryptography` stays
optional: it is imported when a chunk is sealed or opened, not when this
module is, so a filer without it starts and serves unencrypted data.
"""

from __future__ import annotations

import os

NONCE_SIZE = 12
KEY_SIZE = 32


def encrypt(data: bytes) -> tuple[bytes, bytes]:
    """-> (nonce || ciphertext+tag, key)."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    key = os.urandom(KEY_SIZE)
    nonce = os.urandom(NONCE_SIZE)
    sealed = AESGCM(key).encrypt(nonce, data, None)
    return nonce + sealed, key


def decrypt(blob: bytes, key: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    if len(blob) < NONCE_SIZE:
        raise ValueError("cipher blob too short")
    return AESGCM(bytes(key)).decrypt(bytes(blob[:NONCE_SIZE]),
                                      bytes(blob[NONCE_SIZE:]), None)
