"""Wrapper of kernel K1 (csrc/rs_gf.cu): GF(2^8) matrix apply on the GPU.

K1 replaces the JAX package's Pallas kernel (ops/rs_pallas.py::_make_kernel,
launched by _apply). Its four entries map one to one:

    encode_jit              -> encode
    encode_seeded_jit       -> encode_seeded
    reconstruct_jit         -> reconstruct
    reconstruct_seeded_jit  -> reconstruct_seeded

all of them thin wrappers of ``gf_apply``, which takes any [m, k] GF(2^8)
matrix. A tensor on the CPU goes to the plain PyTorch version
(ops/rs_torch.py) — only because it lies on the CPU. A CUDA tensor launches
the kernel or raises: there is no fallback.

``launches`` counts kernel launches (total and per entry), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, gf8, rs_torch

#: kernel launches since the last reset_launches(), all entries together
launches = 0
#: the same count split by entry
launches_by_entry: "dict[str, int]" = {}

_tables: "dict[tuple, torch.Tensor]" = {}
_LIB: "ctypes.CDLL | None" = None


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_entry.clear()


def load() -> ctypes.CDLL:
    """Build (first use) and load K1, with every argument typed: pointers
    and the stream as c_void_p, so ctypes never cuts them to 32 bits."""
    global _LIB
    if _LIB is None:
        lib = _build.build("rs_gf").lib
        lib.rs_gf_apply.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_void_p]
        lib.rs_gf_apply.restype = ctypes.c_int
        lib.rs_gf_max_table_bytes.argtypes = []
        lib.rs_gf_max_table_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def field_tables(mat: np.ndarray) -> np.ndarray:
    """[m, k] GF matrix -> [m, k, 32] uint8, K1's tables. A byte x is
    a | b << 3 | e << 6 (a, b < 8, e < 4), and for each coefficient c
    slots 0:8 hold c*a, 8:16 hold c*(b << 3), 16:20 hold c*(e << 6) and
    20:32 are zero, so c*x = t[a] ^ t[8 + b] ^ t[16 + e]."""
    mat = np.asarray(mat, dtype=np.uint8)
    part = np.arange(8, dtype=np.uint8)
    slots = np.concatenate([part, part << 3, part[:4] << 6])
    tab = np.zeros(mat.shape + (32,), dtype=np.uint8)
    tab[:, :, :20] = gf8.GF_MUL[mat[:, :, None], slots[None, None, :]]
    return tab


def _device_tables(mat: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (device.index, mat.shape, mat.tobytes())
    tab = _tables.get(key)
    if tab is None:
        tab = torch.from_numpy(field_tables(mat)).to(device)
        _tables[key] = tab
    return tab


def gf_apply(mat: np.ndarray, data: torch.Tensor, seed: int = 0,
             entry: str = "apply") -> torch.Tensor:
    """out[b, j, c] = XOR_i mat[j, i] * (data[b, i, c] ^ seed) over GF(2^8).

    data: [B, k, C] (or one stripe [k, C]) uint8 -> [B, m, C] ([m, C]).
    """
    mat = np.asarray(mat, dtype=np.uint8)
    if mat.ndim != 2:
        raise ValueError(f"GF matrix must be 2-D, got shape {mat.shape}")
    m, k = mat.shape
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(data).__name__}")
    if data.dtype != torch.uint8:
        raise TypeError(f"expected uint8 data, got {data.dtype}")
    if data.ndim not in (2, 3) or data.shape[-2] != k:
        raise ValueError(f"data shape {tuple(data.shape)} does not match "
                         f"[B, {k}, C] or [{k}, C]")
    if data.device.type == "cpu":
        return rs_torch.gf_apply(mat, data, seed)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    squeeze = data.ndim == 2
    x = data.unsqueeze(0) if squeeze else data
    b, _, c = x.shape
    lib = load()
    if m * k * 32 > lib.rs_gf_max_table_bytes():
        raise ValueError(f"[{m}, {k}] matrix needs {m * k * 32} B of field "
                         f"tables, over the kernel's "
                         f"{lib.rs_gf_max_table_bytes()} B of shared memory")
    if b > 65535:
        raise ValueError(f"batch {b} over the kernel's grid limit 65535")
    out = torch.empty((b, m, c), dtype=torch.uint8, device=x.device)
    tables = _device_tables(mat, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rs_gf_apply(x.data_ptr(), out.data_ptr(), tables.data_ptr(),
                             b, k, m, c, int(seed) & 0xFF, stream)
    if rc != 0:
        raise RuntimeError(f"rs_gf_apply launch failed: CUDA error {rc}")
    global launches
    launches += 1
    launches_by_entry[entry] = launches_by_entry.get(entry, 0) + 1
    return out[0] if squeeze else out


def encode(data: torch.Tensor, d: int, p: int) -> torch.Tensor:
    """data [B, d, C] uint8 -> parity [B, p, C] uint8."""
    return gf_apply(gf8.parity_matrix(d, p), data, entry="encode")


def encode_seeded(data: torch.Tensor, seed: int, d: int, p: int) -> torch.Tensor:
    """Timing entry: encode of data ^ seed, the XOR taken inside the kernel."""
    return gf_apply(gf8.parity_matrix(d, p), data, seed, entry="encode_seeded")


@functools.lru_cache(maxsize=256)
def _decode_rows(d: int, p: int, survivors: tuple, wanted: tuple) -> np.ndarray:
    """rs_torch.decode_rows, cached: the GF(2^8) inversion behind it takes
    the host longer than K1 takes for a batch."""
    rows = rs_torch.decode_rows(d, p, survivors, wanted)
    rows.setflags(write=False)
    return rows


def reconstruct(survivors: torch.Tensor, present, wanted, d: int,
                p: int) -> torch.Tensor:
    """survivors [B, d, C] (rows = sorted(present)[:d]) -> [B, |wanted|, C]."""
    return gf_apply(_decode_rows(d, p, tuple(sorted(present)[:d]),
                                 tuple(wanted)), survivors, entry="reconstruct")


def reconstruct_seeded(survivors: torch.Tensor, seed: int, present, wanted,
                       d: int, p: int) -> torch.Tensor:
    """Timing entry: reconstruct of survivors ^ seed, XOR inside the kernel."""
    return gf_apply(_decode_rows(d, p, tuple(sorted(present)[:d]),
                                 tuple(wanted)), survivors, seed,
                    entry="reconstruct_seeded")
