"""ctypes bridge to the port's native CPU library (csrc/gf8.cpp).

Port of seaweedfs_tpu/ops/native.py. The library is built at first use by
ops/_build.build_host with the host C++ compiler and the SIMD flags the
JAX package's native/Makefile picks from /proc/cpuinfo, into
build/kernels/. NativeCoder is the CPU baseline the card is measured
against: the same AVX2 split-table algorithm klauspost/reedsolomon uses.

Unlike the reference, nothing here degrades: a library that cannot be
built raises, from NativeCoder and from crc32c alike.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import _build, gf8
from .coder import ErasureCoder, register_coder

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def load() -> ctypes.CDLL:
    """Build (first use) and load csrc/gf8.cpp with typed arguments; a
    failed build raises."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.build_host("gf8").lib
            lib.rs_apply_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
            lib.rs_apply_batch.restype = None
            lib.rs_apply.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int64]
            lib.rs_apply.restype = None
            lib.crc32c_update.restype = ctypes.c_uint32
            lib.crc32c_update.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                          ctypes.c_int64]
            lib.crc32c_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_uint32,
                                         ctypes.c_void_p]
            lib.crc32c_batch.restype = None
            lib.native_features.argtypes = []
            lib.native_features.restype = ctypes.c_int
            _lib = lib
        return _lib


def features() -> dict:
    """Which SIMD paths the built library took."""
    f = load().native_features()
    return {"avx2": bool(f & 1), "sse42_crc": bool(f & 2)}


def _apply(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """mat [m, k] uint8, data [..., k, L] uint8 -> [..., m, L]."""
    lib = load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    m, k = mat.shape
    if data.ndim not in (2, 3) or data.shape[-2] != k:
        raise ValueError(f"data shape {data.shape} does not match "
                         f"[B, {k}, L] or [{k}, L]")
    if data.ndim == 2:
        out = np.empty((m, data.shape[1]), dtype=np.uint8)
        lib.rs_apply(data.ctypes.data, out.ctypes.data, mat.ctypes.data,
                     k, m, data.shape[1])
        return out
    b, _, length = data.shape
    out = np.empty((b, m, length), dtype=np.uint8)
    lib.rs_apply_batch(data.ctypes.data, out.ctypes.data, mat.ctypes.data,
                       k, m, length, b)
    return out


def crc32c(data: "bytes | np.ndarray", value: int = 0) -> int:
    """Hardware CRC32C with the standard init/final-xor convention."""
    lib = load()
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(
            data, dtype=np.uint8)
    raw = lib.crc32c_update(value ^ 0xFFFFFFFF, arr.ctypes.data, arr.size)
    return raw ^ 0xFFFFFFFF


class NativeCoder(ErasureCoder):
    """AVX2 split-table CPU coder — the reference-equivalent baseline."""

    def __init__(self, d: int, p: int):
        super().__init__(d, p)
        load()  # raises where the library cannot be built
        self._parity = gf8.parity_matrix(d, p)

    def encode(self, data: np.ndarray) -> np.ndarray:
        return _apply(self._parity, data)

    def reconstruct(self, survivors, present, wanted):
        rec = gf8.decode_matrix(self.d, self.p, list(present))[list(wanted), :]
        return _apply(rec, survivors)


register_coder("native", NativeCoder)
