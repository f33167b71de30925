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
(ops/crc32c.py). A linear map (a 32x32 GF(2) map M, or the raw state of a
16-byte piece) cut into fields of w input bits is one table per field,
T_i[e] = M (e << w i), and M v is the XOR over the fields of T_i[field i of
v] (``field_tables``). ``kernel_tables`` is the compact image the kernel
copies in: the lane tables (16 data bytes, 5-bit fields), the chunk step
A^512 (5-bit fields) and the fold tables (``fold_tables``: lane l's map
A^(16 (31 - l)), 4-bit fields, one value per lane). Each block writes the
lane and step tables 32-fold, so that every lane reads its own copy in its
own bank. ``shift_tables(n)`` (the four byte tables of A^n) serve the fold
of a split row's segments (n = 512 q). tests/test_torch_k3_model.py runs
K3's arithmetic over them in numpy.

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
LANES = 32
#: field widths, in bits, of the lane, chunk-step and fold tables (the
#: kernel's kLaneBits, kStepBits, kFoldBits)
LANE_BITS, STEP_BITS, FOLD_BITS = 5, 5, 4
#: warps K3 keeps resident on an SM: one 1024-thread block, whose tables
#: take most of the SM's shared memory (the kernel's kWarps)
WARPS_PER_SM = 32
#: a row is split only while every segment keeps at least this many chunks,
#: so that a task's fold (8 lookups, a butterfly and a store) stays small
#: beside its 33 lookups a chunk
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
        for fn in (lib.crc32c_chunk_bytes, lib.crc32c_table_words,
                   lib.crc32c_shared_bytes):
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


def bit_images(m: np.ndarray) -> np.ndarray:
    """[32] uint32: M applied to each single-bit state, bit b in row b."""
    return apply_matrix(m, np.uint64(1) << np.arange(32, dtype=np.uint64))


@functools.lru_cache(maxsize=1)
def lane_bit_images() -> np.ndarray:
    """[128] uint32: the raw zero-init state of 16 bytes whose only set bit
    is bit b (byte b // 8, bit b % 8), A^(15 - b // 8) T[1 << b % 8]."""
    t = crc32c._table()
    return np.array([apply_matrix(pow_matrix(LANE_BYTES - 1 - b // 8),
                                  t[1 << (b % 8)]) for b in range(128)],
                    dtype=np.uint32)


def field_tables(images: np.ndarray, width: int) -> np.ndarray:
    """The tables of a linear map cut into fields of `width` input bits,
    concatenated: field i (bits [width i, width i + w)) has 2^w entries,
    entry e = XOR of the images of the bits set in e << width i. The last
    field may be narrower. The map of v is the XOR over the fields of
    table_i[field i of v]."""
    out = []
    for lo in range(0, images.size, width):
        img = images[lo:lo + width]
        e = np.arange(1 << img.size)
        bits = (e[:, None] >> np.arange(img.size)) & 1
        out.append(np.bitwise_xor.reduce(
            np.where(bits == 1, img[None, :], 0).astype(np.uint32), axis=1))
    return np.concatenate(out).astype(np.uint32)


@functools.lru_cache(maxsize=1)
def fold_tables() -> np.ndarray:
    """[entries, 32] uint32: column l holds the FOLD_BITS field tables of
    lane l's map A^(16 (31 - l)), from its running state to its share of
    the segment's state."""
    out = np.stack([field_tables(bit_images(pow_matrix(LANE_BYTES * (LANES - 1 - lane))),
                                 FOLD_BITS) for lane in range(LANES)], axis=-1)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=1)
def kernel_tables() -> np.ndarray:
    """K3's compact table image, one flat uint32 array in the kernel's
    order: the lane tables (16 data bytes in fields of LANE_BITS), the
    chunk step A^512 (fields of STEP_BITS), the fold tables (one value per
    lane). The kernel writes the first two 32-fold into shared memory."""
    out = np.concatenate([field_tables(lane_bit_images(), LANE_BITS),
                          field_tables(bit_images(pow_matrix(CHUNK)), STEP_BITS),
                          fold_tables().ravel()])
    out.setflags(write=False)
    return out


def target_tasks(device: torch.device) -> int:
    """One round of the card's resident warps, the grid crc32c_states
    launches (SMs x WARPS_PER_SM), rounded down to a power of two: rows
    are split until the batch has this many warp tasks. More tasks balance
    no better and lengthen the serial fold of a row's segments in the
    second launch."""
    n = torch.cuda.get_device_properties(device).multi_processor_count * WARPS_PER_SM
    return 1 << (n.bit_length() - 1)


def segments(rows: int, chunks: int, target: int) -> int:
    """How many segments K3 splits each row into: doubled (a power of two
    that divides the chunks) while the batch has fewer than `target` warp
    tasks and each segment keeps MIN_SEGMENT_CHUNKS chunks."""
    s = 1
    while (rows * s < target and chunks % (2 * s) == 0
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
    s = segments(b, chunks, target_tasks(dev))
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
