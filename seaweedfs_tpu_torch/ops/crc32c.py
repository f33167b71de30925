"""CRC32-Castagnoli on the host: the needle checksum and the GF(2)
formulation that the batched device CRC (kernel K3, ops/crc_cuda.py) and
its plain version (ops/crc_torch.py) rest on.

Port of the host half of the JAX package's ops/crc32c.py. The reference
verifies a CRC32C per needle on every read and during scrub (reference:
weed/storage/needle/crc.go:13, volume_checking.go:91). ``crc32c`` runs the
port's own C library (csrc/crc32c_host.c: the CPU's crc32 instruction where
it has SSE4.2, a slicing-by-8 table otherwise), built and loaded at first
use; ``_soft_crc32c`` is the per-byte Python loop kept as the oracle.

CRC is GF(2)-affine in the message bits:

    state' = A @ state  ^  D @ byte_bits      (per byte, over GF(2))

so K bytes fold into one [32, 32] state matrix S_K = A^K and one [32, 8K]
injection matrix C_K. Variable needle lengths are handled by LEFT-padding
with zeros: with a zero initial state, leading zero bytes leave the state
unchanged, and the true init (0xFFFFFFFF) is restored afterwards with the
length-dependent affine correction crc_raw(m, I) = crc_raw(pad||m, 0) ^
A^len @ I (``finalize``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

from . import _build

CASTAGNOLI = 0x82F63B78  # reversed (LSB-first) representation
_INIT = 0xFFFFFFFF

_lib_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_update = None  # the C library's crc32c_update, typed, after first use


@functools.lru_cache(maxsize=1)
def _table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CASTAGNOLI if (c & 1) else 0)
        t[i] = c
    return t


def _soft_crc32c(data: bytes | np.ndarray, value: int = 0) -> int:
    t = _table()
    s = value ^ _INIT
    buf = bytes(data) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8).tobytes()
    for b in buf:
        s = (s >> 8) ^ int(t[(s ^ b) & 0xFF])
    return s ^ _INIT


def host_library() -> ctypes.CDLL:
    """Build (first use) and load csrc/crc32c_host.c with typed arguments."""
    global _lib, _update
    with _lib_lock:
        if _lib is None:
            lib = _build.build_host("crc32c_host").lib
            lib.crc32c_init.argtypes = []
            lib.crc32c_init.restype = None
            lib.crc32c_hw.argtypes = []
            lib.crc32c_hw.restype = ctypes.c_int
            lib.crc32c_update.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                          ctypes.c_size_t]
            lib.crc32c_update.restype = ctypes.c_uint32
            lib.crc32c_init()
            _lib = lib
            _update = lib.crc32c_update
    return _lib


def crc32c(data: bytes | bytearray | memoryview | np.ndarray,
           value: int = 0) -> int:
    """Standard CRC32C (init/final xor 0xFFFFFFFF); `value` chains calls.
    Runs the C library (built and loaded at first use; a failed build
    raises)."""
    if _update is None:
        host_library()
    if isinstance(data, bytes):
        return _update(value ^ _INIT, data, len(data)) ^ _INIT
    arr = (np.ascontiguousarray(data, dtype=np.uint8)
           if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8))
    return _update(value ^ _INIT, arr.ctypes.data, arr.size) ^ _INIT


# ---------------------------------------------------------------------------
# GF(2)-linear formulation. Bit convention: state bit i = (crc >> i) & 1,
# message bits LSB-first per byte — identical to ops/rs_torch.unpack_bits.
# ---------------------------------------------------------------------------

def _byte_step_matrices() -> tuple[np.ndarray, np.ndarray]:
    """A [32,32]: state map per byte; D [32,8]: byte-bit injection."""
    t = _table()
    a = np.zeros((32, 32), dtype=np.uint8)
    for i in range(32):
        s = 1 << i
        out = (s >> 8) ^ (int(t[s & 0xFF]))
        for j in range(32):
            a[j, i] = (out >> j) & 1
    d = np.zeros((32, 8), dtype=np.uint8)
    for i in range(8):
        out = int(t[1 << i])
        for j in range(32):
            d[j, i] = (out >> j) & 1
    return a, d


@functools.lru_cache(maxsize=1)
def _a_d() -> tuple[np.ndarray, np.ndarray]:
    return _byte_step_matrices()


def _m2mul(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return (x.astype(np.int32) @ y.astype(np.int32) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def chunk_matrices(k: int) -> tuple[np.ndarray, np.ndarray]:
    """(S_K [32,32], C_K [32,8K]) folding K message bytes into the state.

    state_after = S_K @ state ^ C_K @ bits(chunk), chunk byte 0 first,
    C_K columns [8*i : 8*i+8] belong to byte i (LSB-first).
    """
    a, d = _a_d()
    cols = []
    # byte i passes through A another (k-1-i) times after injection
    powers = [np.eye(32, dtype=np.uint8)]
    for _ in range(k):
        powers.append(_m2mul(a, powers[-1]))
    for i in range(k):
        cols.append(_m2mul(powers[k - 1 - i], d))
    c = np.concatenate(cols, axis=1) if cols else np.zeros((32, 0), np.uint8)
    return powers[k], c


@functools.lru_cache(maxsize=1)
def _a_pow2() -> list[np.ndarray]:
    """A^(2^j) for j in 0..47 as uint32 column bitmasks for fast host matvec."""
    a, _ = _a_d()
    mats = []
    cur = a
    for _ in range(48):
        # column c as uint32 bitmask
        mask = np.zeros(32, dtype=np.uint32)
        for c in range(32):
            mask[c] = int.from_bytes(np.packbits(cur[:, c], bitorder="little").tobytes(), "little")
        mats.append(mask)
        cur = _m2mul(cur, cur)
    return mats


def _matvec_u32(colmask: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """Apply 32x32 GF(2) matrix (uint32 column masks) to batched uint32 vecs."""
    out = np.zeros_like(vec)
    for c in range(32):
        bit = (vec >> np.uint32(c)) & np.uint32(1)
        out ^= colmask[c] * bit
    return out


def zero_prefix_correction(lengths: np.ndarray) -> np.ndarray:
    """A^len @ INIT for a batch of lengths -> uint32 raw-state corrections.

    crc_raw(msg, init=0xFFFFFFFF) = device_raw(zeropad||msg) ^ correction(len).
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    vec = np.full(lengths.shape, _INIT, dtype=np.uint32)
    mats = _a_pow2()
    for j in range(48):
        bit = (lengths >> j) & 1
        if not bit.any():
            continue
        applied = _matvec_u32(mats[j], vec)
        vec = np.where(bit.astype(bool), applied, vec)
    return vec


def finalize(raw_states: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Combine device raw states (init-0, left-padded) into true CRC32C values."""
    return (np.asarray(raw_states, dtype=np.uint32)
            ^ zero_prefix_correction(lengths)
            ^ np.uint32(_INIT))
