"""Batched raw CRC32C states in plain PyTorch — the plain version of kernel
K3 (csrc/crc32c.cu, ops/crc_cuda.py).

Port of the JAX package's ops/crc32c.device_crc_states, in the same
formulation: the blocks are walked in `chunk`-byte steps, and each step is

    state = (state @ S_K^T + bits @ C_K^T) mod 2

over [B, 32] state bits and [B, 8K] message bits (LSB-first per byte, as
ops/rs_torch.unpack_bits lays them out; ops/crc32c.chunk_matrices gives S_K
and C_K). The products run in float32 with TF32 off, as ops/rs_torch.py
does: the entries are 0/1 and every sum is at most 32 + 8K < 2^24, so the
result is exact.

Raw state: init 0, no final xor, over LEFT-zero-padded rows;
ops/crc32c.finalize turns it into the CRC32C of the unpadded needle. States
come back as int64 holding the uint32 value (torch has little uint32
support); view them as np.uint32 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import crc32c
from .rs_torch import unpack_bits

_WEIGHTS = tuple(1 << i for i in range(32))


def crc_states(blocks: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """blocks [B, L] uint8 (L % chunk == 0) -> raw states [B] int64."""
    if blocks.dtype != torch.uint8 or blocks.ndim != 2:
        raise ValueError(f"expected [B, L] uint8 blocks, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    b, length = blocks.shape
    if length % chunk:
        raise ValueError(f"row length {length} is not a multiple of the "
                         f"{chunk}-byte chunk")
    dev = blocks.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    s_k, c_k = crc32c.chunk_matrices(chunk)
    s_kt = torch.from_numpy(np.ascontiguousarray(s_k.T)).to(dev, torch.float32)
    c_kt = torch.from_numpy(np.ascontiguousarray(c_k.T)).to(dev, torch.float32)
    state = torch.zeros((b, 32), dtype=torch.float32, device=dev)
    for t in range(length // chunk):
        step = blocks[:, t * chunk:(t + 1) * chunk]
        bits = unpack_bits(step.unsqueeze(-1))[..., 0].to(torch.float32)
        acc = state @ s_kt + bits @ c_kt
        state = (acc.to(torch.int32) & 1).to(torch.float32)
    weights = torch.tensor(_WEIGHTS, dtype=torch.int64, device=dev)
    return (state.to(torch.int64) * weights).sum(dim=1)
