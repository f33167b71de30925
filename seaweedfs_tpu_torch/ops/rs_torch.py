"""Reed-Solomon encode / reconstruct in plain PyTorch — the plain version
of the CUDA kernel (ops/rs_cuda.py, csrc/rs_gf.cu).

Port of the JAX package's ops/rs_jax.py. GF(2^8) shard arithmetic expands
over GF(2) to

    out_bits[8m, N] = B[8m, 8k] @ in_bits[8k, N]   (mod 2)

where in_bits is the LSB-first bit-unpacking of the shard bytes (see
ops/gf8.py). The product is taken in float32: ``torch.matmul`` refuses
integer dtypes on CUDA, and an int8 product on the CPU returns int8, which
wraps. float32 is exact here because the entries are 0/1 and every sum is
at most 8k <= 2040 < 2^24. On CUDA, apply_bitmatrix sets
``torch.backends.cuda.matmul.allow_tf32 = False`` so the product runs in
full float32 whatever precision mode the caller had set.

Runs on whatever device its tensors are on (CPU in the tests, CUDA in
chip_smoke.py's comparison with the kernel). Memory: the unpacked bits of
a [B, k, L] input take 32x its bytes as float32, and the product and its
packing as much again; on the CPU, where the host's memory is shared with
everything else, the columns go in slices of at most `CPU_SLICE_BYTES` of
input (a [32, 10, 1 MiB] batch would otherwise take ~30 GB). The bytes are
the same either way: each column is independent.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf8

_BIT_SHIFTS = tuple(range(8))
# largest input slice one CPU product takes (its working set ~50x this)
CPU_SLICE_BYTES = 16 << 20


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """[..., k, L] uint8 -> [..., 8k, L] uint8 bits, LSB-first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device).reshape(8, 1)
    bits = (data.unsqueeze(-2) >> shifts) & 1
    return bits.reshape(*data.shape[:-2], data.shape[-2] * 8, data.shape[-1])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8m, L] integer bits -> [..., m, L] uint8, LSB-first."""
    b = bits.reshape(*bits.shape[:-2], bits.shape[-2] // 8, 8, bits.shape[-1])
    weights = torch.tensor([1 << s for s in _BIT_SHIFTS], dtype=torch.int32,
                           device=bits.device).reshape(8, 1)
    # the sum promotes to int64; every value is < 256, so the cast is exact
    return (b.to(torch.int32) * weights).sum(dim=-2).to(torch.uint8)


def apply_bitmatrix(bmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matrix application via GF(2) matmul.

    bmat: [8m, 8k] 0/1 (from gf8.expand_to_bits); data: [..., k, L] uint8.
    Returns [..., m, L] uint8.
    """
    if data.is_cuda:
        # byte-for-byte comparison with the kernel: full float32 products
        # (0/1 inputs would survive TF32, but nothing here rests on that)
        torch.backends.cuda.matmul.allow_tf32 = False
    fmat = bmat.to(device=data.device, dtype=torch.float32)
    length = data.shape[-1]
    step = length
    if not data.is_cuda and data.numel():
        step = max(1, CPU_SLICE_BYTES // (data.numel() // max(length, 1)))
    if step >= length:
        return _apply(fmat, data)
    return torch.cat([_apply(fmat, data[..., s:s + step])
                      for s in range(0, length, step)], dim=-1)


def _apply(fmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    bits = unpack_bits(data).to(torch.float32)            # [..., 8k, L]
    return pack_bits(torch.matmul(fmat, bits).to(torch.int32) & 1)


def decode_rows(d: int, p: int, present, wanted) -> np.ndarray:
    """[len(wanted), d] GF matrix rebuilding `wanted` from the survivors
    sorted(present)[:d] (the survivor-row contract of every coder)."""
    rec = gf8.decode_matrix(d, p, sorted(present)[:d])
    return np.ascontiguousarray(rec[list(wanted), :])


def gf_apply(mat: np.ndarray, data: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Apply GF(2^8) matrix [m, k] to [..., k, L] uint8 (optionally XORed
    with the byte `seed` first) -> [..., m, L] uint8."""
    if seed:
        data = data ^ (seed & 0xFF)
    bmat = torch.from_numpy(gf8.expand_to_bits(np.asarray(mat, np.uint8)))
    return apply_bitmatrix(bmat, data)


def encode(data: torch.Tensor, d: int, p: int) -> torch.Tensor:
    """data [..., d, L] uint8 -> parity [..., p, L] uint8."""
    if data.shape[-2] != d:
        raise ValueError(f"data shard axis {data.shape[-2]} != d={d}")
    return gf_apply(gf8.parity_matrix(d, p), data)


def reconstruct(survivors: torch.Tensor, present, wanted, d: int,
                p: int) -> torch.Tensor:
    """Rebuild shards `wanted` from the first d surviving shards.

    survivors: [..., d, L] uint8 — rows are shards sorted(present)[:d].
    """
    return gf_apply(decode_rows(d, p, present, wanted), survivors)
