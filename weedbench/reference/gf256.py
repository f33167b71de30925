"""GF(2^8) arithmetic and the systematic Reed-Solomon matrices, in NumPy.

Field: primitive polynomial 0x11D, generator 2. Encode matrix: the
Vandermonde matrix V[r, c] = r^c over n = d + p rows, multiplied by the
inverse of its top d x d block, so the first d rows are the identity
(klauspost/reedsolomon buildMatrix, the construction SeaweedFS's shards
use).
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0x11D


def _tables() -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[0:255]
    mul = np.zeros((256, 256), dtype=np.uint8)
    nz = np.arange(1, 256)
    mul[np.ix_(nz, nz)] = exp[(log[nz][:, None] + log[nz][None, :]) % 255]
    return exp, log, mul


EXP, LOG, MUL = _tables()


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(int(LOG[a]) * n) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(EXP[(255 - int(LOG[a])) % 255])


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[m, k] x [k, n] over GF(2^8)."""
    prod = MUL[np.asarray(a, np.uint8)[:, :, None],
               np.asarray(b, np.uint8)[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1)


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^8)."""
    m = np.asarray(m, np.uint8)
    n = m.shape[0]
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r, col]), None)
        if pivot is None:
            raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = MUL[gf_inv(int(aug[col, col])), aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= MUL[int(aug[r, col]), aug[col]]
    return aug[:, n:].copy()


@functools.lru_cache(maxsize=16)
def encode_matrix(d: int, p: int) -> np.ndarray:
    """The systematic [d + p, d] encode matrix."""
    n = d + p
    vand = np.array([[gf_pow(r, c) for c in range(d)] for r in range(n)],
                    dtype=np.uint8)
    enc = matmul(vand, mat_inv(vand[:d, :d]))
    enc.setflags(write=False)
    return enc


def apply(mat: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """[m, k] GF matrix applied to [k, L] bytes -> [m, L]."""
    mat = np.asarray(mat, np.uint8)
    out = np.zeros((mat.shape[0], rows.shape[1]), dtype=np.uint8)
    for j in range(mat.shape[0]):
        for i in range(mat.shape[1]):
            c = int(mat[j, i])
            if c:
                out[j] ^= MUL[c, rows[i]]
    return out


def parity(data: np.ndarray, p: int) -> np.ndarray:
    """[d, L] data rows -> [p, L] parity rows."""
    d = data.shape[0]
    return apply(encode_matrix(d, p)[d:], data)

