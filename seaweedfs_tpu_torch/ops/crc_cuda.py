"""Wrapper of kernel K3 (csrc/crc32c.cu): batched raw CRC32C states on the
GPU.

K3 replaces the JAX package's device function
ops/crc32c.py::device_crc_states (XLA, not Pallas): [B, L] uint8 rows,
LEFT-padded with zeros, L % 512 == 0 -> the raw CRC32C state of each row
(init 0, no final xor), bit for bit. ops/crc32c.finalize then gives each
needle's CRC32C on the host.

A tensor on the CPU goes to the plain PyTorch version (ops/crc_torch.py) —
only because it lies on the CPU. A CUDA tensor launches the kernel or
raises: there is no fallback. States come back as int64 holding the uint32
value.

The tables K3 reads are built here, from the port's GF(2) matrices
(ops/crc32c.py): ``slice_tables`` (S_j[x] = A^j T[x], j < 16) for the
16-byte lane CRC, and ``shift_tables(n)`` (the four byte tables of A^n) for
the lane tree (n = 16, 32, 64, 128, 256), the chunk step (n = 512) and the
fold of a split row's segments (n = 512 q). tests/test_torch_k3_model.py
runs K3's arithmetic over them in numpy.

``launches`` counts kernel launches (one per call that reaches the card),
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, crc32c, crc_torch

CHUNK = 512          # bytes a warp folds per step (the kernel's constant)
LANE_BYTES = 16      # bytes per lane per step
TREE_SHIFTS = (16, 32, 64, 128, 256)
#: split a row into segments until the batch has this many warp tasks
TARGET_TASKS = 8192
#: ... while every segment keeps at least this many chunks
MIN_SEGMENT_CHUNKS = 4

#: kernel launches since the last reset_launches()
launches = 0

_LIB: "ctypes.CDLL | None" = None
_dev_tables: "dict[tuple, torch.Tensor]" = {}


def reset_launches() -> None:
    global launches
    launches = 0


def load() -> ctypes.CDLL:
    """Build (first use) and load K3 with every argument typed: pointers
    and the stream as c_void_p, so ctypes never cuts them to 32 bits."""
    global _LIB
    if _LIB is None:
        lib = _build.build("crc32c").lib
        lib.crc32c_states.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.crc32c_states.restype = ctypes.c_int
        for fn in (lib.crc32c_chunk_bytes, lib.crc32c_table_words):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if lib.crc32c_chunk_bytes() != CHUNK or (
                lib.crc32c_table_words() != kernel_tables().size):
            raise RuntimeError("csrc/crc32c.cu and ops/crc_cuda.py disagree "
                               "on the chunk or the table layout")
        _LIB = lib
    return _LIB


# -- tables ------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def pow_matrix(n: int) -> np.ndarray:
    """A^n [32, 32] over GF(2): the state map of n zero bytes."""
    a, _ = crc32c._a_d()
    out = np.eye(32, dtype=np.uint8)
    base = a
    while n:
        if n & 1:
            out = crc32c._m2mul(out, base)
        base = crc32c._m2mul(base, base)
        n >>= 1
    return out


def apply_matrix(m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """[32, 32] GF(2) matrix times each uint32 state in vecs -> uint32."""
    v = np.asarray(vecs, dtype=np.uint64)
    bits = (v[..., None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
    out = (bits.astype(np.int64) @ m.T.astype(np.int64)) & 1
    return (out.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=-1).astype(np.uint32)


@functools.lru_cache(maxsize=64)
def shift_tables(n: int) -> np.ndarray:
    """[4, 256] uint32: row m holds A^n (x << 8m), so that
    A^n v = T[0][v & 255] ^ T[1][v >> 8 & 255] ^ T[2][v >> 16 & 255] ^ T[3][v >> 24]."""
    x = np.arange(256, dtype=np.uint64)
    vecs = np.stack([x << np.uint64(8 * m) for m in range(4)])
    out = apply_matrix(pow_matrix(n), vecs)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=1)
def slice_tables() -> np.ndarray:
    """[16, 256] uint32: S_j[x] = A^j T[x], the raw zero-init state of byte
    x followed by j zero bytes."""
    t = crc32c._table()
    out = np.stack([apply_matrix(pow_matrix(j), t) for j in range(LANE_BYTES)])
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=1)
def kernel_tables() -> np.ndarray:
    """K3's shared-memory image: slice tables, the five tree shifts, the
    chunk step, as one flat uint32 array (the kernel's layout)."""
    parts = [slice_tables().ravel()]
    parts += [shift_tables(n).ravel() for n in TREE_SHIFTS]
    parts.append(shift_tables(CHUNK).ravel())
    out = np.concatenate(parts)
    out.setflags(write=False)
    return out


def segments(rows: int, chunks: int) -> int:
    """How many segments K3 splits each row into: doubled (a power of two
    that divides the chunks) while the batch has fewer than TARGET_TASKS
    warp tasks and each segment keeps MIN_SEGMENT_CHUNKS chunks."""
    s = 1
    while (rows * s < TARGET_TASKS and chunks % (2 * s) == 0
           and chunks // (2 * s) >= MIN_SEGMENT_CHUNKS):
        s *= 2
    return s


def _on_device(key, make, device: torch.device) -> torch.Tensor:
    k = (device.index, key)
    t = _dev_tables.get(k)
    if t is None:
        arr = np.ascontiguousarray(make(), dtype=np.uint32).view(np.int32)
        t = torch.from_numpy(arr.copy()).to(device)
        _dev_tables[k] = t
    return t


# -- the kernel's entry ------------------------------------------------------
def crc_states(blocks: torch.Tensor) -> torch.Tensor:
    """blocks [B, L] uint8, L % 512 == 0 -> raw CRC32C states [B] int64."""
    if not isinstance(blocks, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(blocks).__name__}")
    if blocks.dtype != torch.uint8 or blocks.ndim != 2:
        raise ValueError(f"expected [B, L] uint8 blocks, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    b, length = blocks.shape
    if length % CHUNK:
        raise ValueError(f"row length {length} is not a multiple of {CHUNK}")
    if blocks.device.type == "cpu":
        return crc_torch.crc_states(blocks, CHUNK)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must start on a 16-byte boundary")
    dev = blocks.device
    if b == 0 or length == 0:
        return torch.zeros(b, dtype=torch.int64, device=dev)
    out = torch.empty(b, dtype=torch.int64, device=dev)
    chunks = length // CHUNK
    s = segments(b, chunks)
    lib = load()
    tables = _on_device("tables", kernel_tables, dev)
    if s > 1:
        seg = torch.empty(b * s, dtype=torch.int32, device=dev)
        q = chunks // s
        seg_shift = _on_device(("segment", q),
                               lambda: shift_tables(CHUNK * q), dev)
    else:
        seg = seg_shift = out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.crc32c_states(blocks.data_ptr(), out.data_ptr(),
                               seg.data_ptr(), tables.data_ptr(),
                               seg_shift.data_ptr(), b, length, s, stream)
    if rc != 0:
        raise RuntimeError(f"crc32c_states launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
