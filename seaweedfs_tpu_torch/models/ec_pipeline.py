"""ECPipeline — the flagship device pipeline ("model") of the framework.

Port of seaweedfs_tpu/models/ec_pipeline.py. One "step" is the full
data-integrity cycle a storage cluster runs continuously: encode stripe
batches into parity, scrub needle CRCs, and rebuild lost shards — all on
device, sharded over a ('data', 'shard') mesh of torch.distributed ranks
(parallel/mesh.py, parallel/pipeline.py). `forward` is the ec.encode hot
path on one device: a stripe batch [B, d, L] -> parity [B, p, L] through
kernel K1 on the card (ops/rs_cuda.py), or through the plain PyTorch
version when the caller asks for device="cpu".

The mesh is built on first use of `step` or `scrub` (a world of one where
none is launched) unless one is given; `close()` releases a world the
pipeline initialised.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import crc32c, rs_cuda
from ..ops.coder import resolve_device
from ..parallel import pipeline as pp
from ..parallel.mesh import AXES, Mesh, build_mesh


@dataclass
class ECPipeline:
    d: int = 10
    p: int = 4
    device: "str | torch.device" = "cuda"
    mesh: "Mesh | None" = None

    def __post_init__(self):
        # a given mesh decides the device; else the caller's choice does
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(self.device))
        self._own_mesh = False

    @property
    def n(self) -> int:
        return self.d + self.p

    def _mesh(self) -> Mesh:
        if self.mesh is None:
            self.mesh = build_mesh(device=self.device)
            self._own_mesh = True
        return self.mesh

    def close(self) -> None:
        """Release the mesh this pipeline built (a mesh given to it stays
        the caller's)."""
        if self._own_mesh:
            self.mesh.close()
            self.mesh = None
            self._own_mesh = False

    def n_pad(self) -> int:
        ns = self._mesh().shape["shard"]
        return (self.n + ns - 1) // ns * ns

    # -- single-device forward (entry() target) ------------------------------
    def forward(self, data: "torch.Tensor | np.ndarray") -> torch.Tensor:
        """Stripe batch [B, d, L] (or one stripe [d, L]) uint8 -> parity
        [B, p, L] uint8, on this pipeline's device."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
        return rs_cuda.encode(data.to(self.device).contiguous(),
                              self.d, self.p)

    # -- full distributed step (dryrun_multichip target) ---------------------
    def step(self, data: "torch.Tensor | np.ndarray",
             lost: "tuple[int, ...]") -> dict:
        """Encode -> shard layout -> rebuild `lost` -> verify.

        data: the global [B, d, L] host array (each rank puts its
        data-axis rows on its device), or this rank's block of it as a
        tensor on the mesh's device. Returns device scalars, the same on
        every rank: the rebuild's byte-mismatch count over the mesh (must
        be 0) and the bytes encoded (int64)."""
        mesh = self._mesh()
        d, p, n = self.d, self.p, self.n
        n_pad = self.n_pad()
        if not isinstance(data, torch.Tensor):
            data = pp.shard_put(mesh, np.asarray(data, dtype=np.uint8),
                                ("data", None, None))
        b, _, l = data.shape
        # every parity row, so that a rank can take the shard rows it owns
        parity = pp.all_gather(mesh, pp.encode_sharded(mesh, data, d, p),
                               "shard", dim=1)
        rows = n_pad // mesh.shape["shard"]
        lo = mesh.axis_index("shard") * rows
        shards = torch.zeros((b, rows, l), dtype=torch.uint8, device=data.device)
        for r in range(lo, min(lo + rows, n)):
            shards[:, r - lo] = data[:, r] if r < d else parity[:, r - d]
        wiped = shards.clone()
        for s in lost:
            if lo <= s < lo + rows:
                wiped[:, s - lo] = 0
        present = tuple(i for i in range(n) if i not in lost)
        rebuilt = pp.rebuild_sharded(mesh, wiped, present, d, p)
        real = max(0, min(rows, n - lo))  # rows past n are padding
        mismatch = (rebuilt[:, :real] != shards[:, :real]).sum(
            dtype=torch.int64).reshape(1)
        torch.distributed.all_reduce(mismatch, group=mesh.group(AXES))
        return {"rebuild_mismatch_bytes": mismatch[0],
                "bytes_encoded": torch.tensor(
                    b * mesh.shape["data"] * d * l, dtype=torch.int64,
                    device=data.device)}

    def scrub(self, blocks: np.ndarray, lengths: np.ndarray) -> int:
        """Host-facing scrub: needles left-padded into [B, L] + true lengths.
        Each rank computes the raw CRC states of its rows (B split over the
        whole mesh, which it must divide) and compares them with the states
        the host expects of intact needles; returns the mesh's mismatch
        count."""
        mesh = self._mesh()
        blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
        want = self._expected(blocks, lengths).astype(np.int64)
        bad = pp.scrub_sharded(mesh, pp.shard_put(mesh, blocks, (AXES, None)),
                               pp.shard_put(mesh, want, (AXES,)))
        return int(bad.item())

    @staticmethod
    def _expected(blocks: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Expected raw device states for intact blocks (host oracle):
        raw = crc32c(needle) ^ correction(len) ^ 0xFFFFFFFF, the finalize
        inverted."""
        lengths = np.asarray(lengths, dtype=np.int64)
        width = blocks.shape[1]
        true = np.fromiter((crc32c.crc32c(blk[width - ln:])
                            for blk, ln in zip(blocks, lengths)),
                           dtype=np.uint32, count=len(blocks))
        return (true ^ crc32c.zero_prefix_correction(lengths)
                ^ np.uint32(0xFFFFFFFF))
