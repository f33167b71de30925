"""GF(2^8) arithmetic and Reed-Solomon matrix construction (host side, numpy).

This is the mathematical core of the erasure-coding plane. The reference
(ZTO-Express/seaweedfs) delegates this to the vendored klauspost/reedsolomon
Go library (reference: weed/storage/erasure_coding/ec_encoder.go:202
``reedsolomon.New(DataShardsCount, ParityShardsCount)``). We re-derive the same
construction from first principles so shards produced by either implementation
interoperate:

* field GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D) and
  generator 2 — the same field used by klauspost/reedsolomon and
  Backblaze/JavaReedSolomon;
* systematic encode matrix built from a Vandermonde matrix V[r,c] = r^c whose
  top k-by-k block is inverted and multiplied through, so the first k rows
  become the identity (klauspost ``buildMatrix``).

The key fact (everything downstream builds on this): multiplication by a
*constant* c in GF(2^8) is linear over GF(2), i.e. an 8x8 bit-matrix M(c).
Hence RS encode — parity_j = XOR_i g[j,i] * data_i — expands to a single
binary matrix multiply

    parity_bits[8p, L] = B[8p, 8d] @ data_bits[8d, L]  (mod 2)

which the plain PyTorch version (ops/rs_torch.py) takes as a float32 matmul
followed by ``& 1``. The CUDA kernel (csrc/rs_gf.cu, wrapped by ops/rs_cuda.py)
instead looks products up in 8-entry register tables built from the same field
(ops/rs_cuda.field_tables).
"""

from __future__ import annotations

import functools

import numpy as np

# Primitive polynomial for GF(2^8): x^8 + x^4 + x^3 + x^2 + 1.
POLY = 0x11D
FIELD = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """exp/log tables for generator 2 and the full 256x256 multiply table."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[0:255]  # wraparound so exp[a+b] works without mod
    # mul[a, b] via log/exp; row/col 0 are zero.
    la = log[np.arange(256)]
    mul = np.zeros((256, 256), dtype=np.uint8)
    nz = np.arange(1, 256)
    mul[np.ix_(nz, nz)] = exp[(la[nz][:, None] + la[nz][None, :]) % 255]
    return exp, log, mul


GF_EXP, GF_LOG, GF_MUL = _build_tables()


def gf_mul(a: int, b: int) -> int:
    return int(GF_MUL[a, b])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(GF_EXP[(255 - int(GF_LOG[a])) % 255])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8). a: [m,k] uint8, b: [k,n] uint8 -> [m,n]."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    # products[m,k,n] then XOR-reduce over k
    prod = GF_MUL[a[:, :, None], b[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2^8) by Gauss-Jordan elimination."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"matrix not square: {m.shape}")
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for r in range(col, n):
            if aug[r, col] != 0:
                pivot = r
                break
        if pivot is None:
            raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv = gf_inv(int(aug[col, col]))
        aug[col] = GF_MUL[inv, aug[col]]
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= GF_MUL[int(aug[r, col]), aug[col]]
    return aug[:, n:].copy()


@functools.lru_cache(maxsize=64)
def _encode_matrix_cached(d: int, p: int) -> np.ndarray:
    n = d + p
    if not (0 < d and 0 < p and n <= FIELD):
        raise ValueError(f"invalid RS geometry d={d} p={p}")
    # Vandermonde: V[r, c] = r^c  (klauspost/backblaze construction).
    vand = np.zeros((n, d), dtype=np.uint8)
    for r in range(n):
        for c in range(d):
            vand[r, c] = gf_pow(r, c)
    top_inv = gf_mat_inv(vand[:d, :d])
    enc = gf_matmul(vand, top_inv)
    enc.setflags(write=False)
    return enc


def encode_matrix(d: int, p: int) -> np.ndarray:
    """Systematic [d+p, d] encode matrix: top d rows identity, bottom p parity."""
    return _encode_matrix_cached(d, p)


def parity_matrix(d: int, p: int) -> np.ndarray:
    """The [p, d] parity block of the systematic encode matrix."""
    return encode_matrix(d, p)[d:, :]


def decode_matrix(d: int, p: int, present: "list[int] | np.ndarray") -> np.ndarray:
    """Matrix reconstructing ALL n=d+p shards from d surviving shards.

    `present` lists >=d surviving shard ids (sorted); the first d are used.
    Returns R [n, d] with all-shards = R (x) survivors[:d], such that rows for
    surviving shards are unit rows (copy-through). Mirrors the per-read inverse
    the reference computes inside reedsolomon.Reconstruct
    (reference: weed/storage/erasure_coding/ec_encoder.go:274).
    """
    present = sorted(int(i) for i in present)
    if len(present) < d:
        raise ValueError(f"need >= {d} shards, have {len(present)}")
    use = present[:d]
    enc = encode_matrix(d, p)
    sub = enc[use, :]  # [d, d]
    inv = gf_mat_inv(sub)  # data = inv (x) survivors
    return gf_matmul(enc, inv)  # [n, d]


# ---------------------------------------------------------------------------
# Bit-matrix expansion: the bridge from GF(2^8) to a GF(2) matmul.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _bit_matrix_of_const(c: int) -> bytes:
    """8x8 GF(2) matrix of 'multiply by c'; M[i, j] = bit i of c * (1 << j)."""
    m = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        prod = gf_mul(c, 1 << j)
        for i in range(8):
            m[i, j] = (prod >> i) & 1
    return m.tobytes()


def bit_matrix_of_const(c: int) -> np.ndarray:
    return np.frombuffer(_bit_matrix_of_const(int(c)), dtype=np.uint8).reshape(8, 8)


def expand_to_bits(mat: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix [m, k] into its GF(2) bit-matrix [8m, 8k].

    Block (j, i) of the result is the 8x8 bit-matrix of mat[j, i]; with data
    bytes unpacked LSB-first along the row axis, out_bits = B @ in_bits mod 2
    computes the GF(2^8) product.
    """
    mat = np.asarray(mat, dtype=np.uint8)
    m, k = mat.shape
    out = np.zeros((8 * m, 8 * k), dtype=np.uint8)
    for j in range(m):
        for i in range(k):
            out[8 * j:8 * j + 8, 8 * i:8 * i + 8] = bit_matrix_of_const(mat[j, i])
    return out


# ---------------------------------------------------------------------------
# Reference (numpy) encode/reconstruct — correctness oracle for device paths.
# ---------------------------------------------------------------------------

def np_gf_apply(mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """Apply GF matrix [m, k] to shard bytes [k, L] -> [m, L] (numpy oracle)."""
    mat = np.asarray(mat, dtype=np.uint8)
    shards = np.asarray(shards, dtype=np.uint8)
    out = np.zeros((mat.shape[0], shards.shape[1]), dtype=np.uint8)
    for j in range(mat.shape[0]):
        acc = out[j]
        for i in range(mat.shape[1]):
            c = mat[j, i]
            if c:
                acc ^= GF_MUL[c, shards[i]]
    return out


def np_encode(data: np.ndarray, p: int) -> np.ndarray:
    """data [d, L] -> parity [p, L]; pure-numpy oracle."""
    d = data.shape[0]
    return np_gf_apply(parity_matrix(d, p), data)


def np_reconstruct(shards: np.ndarray, present: "list[int]", d: int, p: int) -> np.ndarray:
    """shards [n, L] with garbage rows for missing ids -> full [n, L]."""
    rec = decode_matrix(d, p, present)
    use = sorted(present)[:d]
    return np_gf_apply(rec, shards[use])
