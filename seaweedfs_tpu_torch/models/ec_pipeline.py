"""ECPipeline — the flagship device pipeline ("model"), single-device part.

Port of seaweedfs_tpu/models/ec_pipeline.py. `forward` is the ec.encode hot
path: a stripe batch [B, d, L] -> parity [B, p, L] through kernel K1 on the
card (ops/rs_cuda.py), or through the plain PyTorch version when the caller
asks for device="cpu". `scrub` counts needle-CRC mismatches of a
left-padded batch through kernel K3 (ops/crc_cuda.py) on the same device.
The multi-device `step`, and the mesh reduction of the reference's scrub
(parallel/pipeline.scrub_sharded's psum), come with the multi-device slice
of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import crc32c, crc_cuda, rs_cuda
from ..ops.coder import resolve_device


@dataclass
class ECPipeline:
    d: int = 10
    p: int = 4
    device: "str | torch.device" = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def n(self) -> int:
        return self.d + self.p

    def forward(self, data: "torch.Tensor | np.ndarray") -> torch.Tensor:
        """Stripe batch [B, d, L] (or one stripe [d, L]) uint8 -> parity
        [B, p, L] uint8, on this pipeline's device."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
        return rs_cuda.encode(data.to(self.device).contiguous(),
                              self.d, self.p)

    def scrub(self, blocks: np.ndarray, lengths: np.ndarray) -> int:
        """Host-facing scrub: needles left-padded into [B, L] + true lengths.
        Computes the raw CRC states on this pipeline's device, compares them
        with the states the host expects of intact needles, and returns the
        mismatch count. Rows are left-padded further with zeros to a
        multiple of K3's 512-byte chunk, which leaves zero-init states
        unchanged."""
        blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
        pad = -blocks.shape[1] % crc_cuda.CHUNK
        x = torch.from_numpy(np.pad(blocks, ((0, 0), (pad, 0))) if pad
                             else blocks).to(self.device)
        want = torch.from_numpy(self._expected(blocks, lengths).astype(
            np.int64)).to(self.device)
        return int((crc_cuda.crc_states(x) != want).sum().item())

    @staticmethod
    def _expected(blocks: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Expected raw device states for intact blocks (host oracle)."""
        out = np.zeros(len(blocks), dtype=np.uint32)
        for i, (blk, ln) in enumerate(zip(blocks, lengths)):
            msg = blk[len(blk) - ln:]
            true = crc32c.crc32c(msg.tobytes())
            # invert finalize: raw = value ^ correction ^ 0xFFFFFFFF
            corr = crc32c.zero_prefix_correction(np.array([ln]))[0]
            out[i] = np.uint32(true) ^ corr ^ np.uint32(0xFFFFFFFF)
        return out
