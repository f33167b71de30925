"""Sharded EC compute steps over a ('data', 'shard') mesh (kernel K4's port).

Port of seaweedfs_tpu/parallel/pipeline.py, which runs its steps under
``shard_map`` with ``all_gather``/``psum`` between the devices. Here each
device is a rank of a torch.distributed world (parallel/mesh.py) and every
step works on the rank's LOCAL block, as the reference's shard_map body
does; collectives between the ranks put the global result together:

* stripe batches ride the ``data`` axis (volumes are independent);
* the parity rows (encode) and all n shard rows (rebuild) are partitioned
  along ``shard``, p and n padded up to a multiple of its size with zero
  matrix rows; a rank whose rows are all padding still launches and joins
  every collective;
* rebuild all_gathers the survivor rows along ``shard`` (the reference's
  tiled ``all_gather``, concatenated along the shard-row axis) and each
  rank decodes only the rows it owns;
* scrub splits the needle batch over both axes in row-major rank order
  and sums the mismatch counts over the whole world.

The per-rank GF(2^8) products are kernel K1 (ops/rs_cuda.gf_apply: the
rank's band of the padded parity or decode matrix), the CRC states kernel
K3 (ops/crc_cuda.crc_states); tensors on the CPU take their plain versions.

Layouts are named as the reference's PartitionSpecs, one entry per array
axis: None (replicated), "data", "shard", or ("data", "shard") (split over
both, data-major). ``shard_put`` takes a rank's block of a host array,
``gather`` puts the global array back together on every rank.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..ops import crc_cuda, gf8, rs_cuda
from ..ops.coder import ErasureCoder, TorchCoder, register_coder
from .mesh import AXES, Mesh


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# -- layout ------------------------------------------------------------------

def _local_block(mesh: Mesh, arr, spec: tuple):
    """This rank's block of global `arr` (numpy or tensor) under `spec`."""
    if len(spec) != arr.ndim:
        raise ValueError(f"spec {spec} does not match a {arr.ndim}-D array")
    index = []
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        parts, pos = 1, 0
        for a in axes:
            parts *= mesh.shape[a]
            pos = pos * mesh.shape[a] + mesh.axis_index(a)
        size = arr.shape[dim]
        if size % parts:
            raise ValueError(f"axis {dim} of size {size} does not divide "
                             f"over {parts} ranks along {axes}")
        step = size // parts
        index.append(slice(pos * step, (pos + 1) * step))
    return arr[tuple(index)]


def shard_put(mesh: Mesh, arr, spec: tuple) -> torch.Tensor:
    """Host array -> this rank's block on its device: each rank sends only
    its own rows (the reference's NamedSharding device_put)."""
    block = _local_block(mesh, arr, spec)
    if not isinstance(block, torch.Tensor):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(mesh.device, non_blocking=True).contiguous()


def all_gather(mesh: Mesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The blocks of every rank along `axes`, concatenated along `dim` in
    mesh order (jax.lax.all_gather(..., tiled=True))."""
    group = mesh.group(axes)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather(mesh: Mesh, local: torch.Tensor, spec: tuple) -> torch.Tensor:
    """Global array from every rank's block under `spec`, on every rank."""
    out = local
    for dim, entry in enumerate(spec):
        if entry is not None:
            out = all_gather(mesh, out, entry, dim)
    return out


# -- encode ------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _padded_parity_matrix(d: int, p: int, p_pad: int) -> np.ndarray:
    out = np.zeros((p_pad, d), dtype=np.uint8)
    out[:p] = gf8.parity_matrix(d, p)
    out.setflags(write=False)
    return out


def _band(mesh: Mesh, mat: np.ndarray) -> np.ndarray:
    """The rows of `mat` that this rank's shard index owns."""
    rows = mat.shape[0] // mesh.shape["shard"]
    idx = mesh.axis_index("shard")
    return mat[idx * rows:(idx + 1) * rows]


def encode_sharded(mesh: Mesh, data: torch.Tensor, d: int, p: int) -> torch.Tensor:
    """This rank's data block [B_loc, d, L] (its data index's rows) -> its
    band of the parity, [B_loc, p_pad / n_shard, L]; globally
    [B, p_pad, L] with B over 'data' and parity rows over 'shard'."""
    p_pad = _ceil_to(p, mesh.shape["shard"])
    sub = _band(mesh, _padded_parity_matrix(d, p, p_pad))
    return rs_cuda.gf_apply(sub, data.contiguous(), entry="encode")


# -- rebuild -----------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _padded_decode_matrix(d: int, p: int, present: "tuple[int, ...]",
                          n_pad: int) -> np.ndarray:
    """Decode matrix producing all n_pad shard slots from d survivors."""
    out = np.zeros((n_pad, d), dtype=np.uint8)
    out[:d + p] = gf8.decode_matrix(d, p, list(present))
    out.setflags(write=False)
    return out


def rebuild_sharded(mesh: Mesh, shards: torch.Tensor,
                    present: "tuple[int, ...]", d: int, p: int) -> torch.Tensor:
    """This rank's shard rows [B_loc, n_pad / n_shard, L] (lost rows are
    garbage) -> the same rows recomputed from the survivors
    sorted(present)[:d], gathered from every rank along 'shard'."""
    n = d + p
    n_pad = shards.shape[1] * mesh.shape["shard"]
    if n_pad < n:
        raise ValueError(f"{n_pad} shard rows over the mesh, need >= {n}")
    use = tuple(sorted(present)[:d])
    if len(use) < d:
        raise ValueError(f"need {d} survivors, have {len(use)}")
    allsh = all_gather(mesh, shards, "shard", dim=1)  # [B_loc, n_pad, L]
    survivors = allsh[:, list(use)].contiguous()
    sub = _band(mesh, _padded_decode_matrix(d, p, use, n_pad))
    return rs_cuda.gf_apply(sub, survivors, entry="reconstruct")


# -- scrub -------------------------------------------------------------------

def scrub_sharded(mesh: Mesh, blocks: torch.Tensor,
                  expected_states: torch.Tensor) -> torch.Tensor:
    """This rank's needles [B_loc, L] (left-zero-padded) and the raw CRC
    states intact needles have ([B_loc] int64 holding the uint32 values)
    -> the mismatch count of the whole mesh, the same on every rank.

    Rows are left-padded further with zeros to K3's 512-byte chunk, which
    leaves zero-init states unchanged. B is split over both axes (the
    reference's P(("data", "shard"))); the count is one all_reduce."""
    pad = -blocks.shape[1] % crc_cuda.CHUNK
    if pad:
        wide = blocks.new_zeros((blocks.shape[0], blocks.shape[1] + pad))
        wide[:, pad:] = blocks
        blocks = wide
    states = crc_cuda.crc_states(blocks.contiguous())
    bad = (states != expected_states.to(states.device, torch.int64)).sum(
        dtype=torch.int64).reshape(1)
    dist.all_reduce(bad, group=mesh.group(AXES))
    return bad[0]


# -- the coder facade --------------------------------------------------------

class MeshCoder(TorchCoder):
    """ErasureCoder over the mesh-sharded encode and rebuild: the seam that
    lets the disk-fed streaming pipeline (ec/stream.encode_volumes) batch
    host slabs straight onto the mesh. Batches ride 'data' (padded up to a
    multiple of its size), parity rows 'shard'.

    Every rank runs the same program on the same host input: it puts only
    its own block on its device, and the collectives give every rank the
    global result, which comes back as TorchCoder's does (a DeviceResult
    on CUDA, numpy on the CPU)."""

    def __init__(self, mesh: Mesh, d: int, p: int):
        ErasureCoder.__init__(self, d, p)
        self.mesh = mesh
        self.device = mesh.device

    def _batched(self, arr):
        """[k, L] -> [1, k, L], and a batch padded with zero stripes to a
        multiple of the data axis."""
        arr = np.asarray(arr, dtype=np.uint8)
        if arr.ndim == 2:
            arr = arr[None]
        if arr.ndim != 3:
            raise ValueError(f"expected [B, k, L] or [k, L], got {arr.shape}")
        pad = -arr.shape[0] % self.mesh.shape["data"]
        if pad:
            arr = np.concatenate(
                [arr, np.zeros((pad,) + arr.shape[1:], np.uint8)])
        return arr

    def encode(self, data):
        squeeze = np.ndim(data) == 2
        b = 1 if squeeze else data.shape[0]
        spec = ("data", None, None)
        parity = encode_sharded(self.mesh,
                                shard_put(self.mesh, self._batched(data), spec),
                                self.d, self.p)
        out = gather(self.mesh, parity, ("data", "shard", None))[:b, :self.p]
        return self._finish(out[0] if squeeze else out.contiguous())

    def reconstruct(self, survivors, present, wanted):
        """survivors [B, d, L] = shard rows sorted(present)[:d]."""
        squeeze = np.ndim(survivors) == 2
        present = tuple(sorted(present))[:self.d]
        arr = self._batched(survivors)
        b = 1 if squeeze else survivors.shape[0]
        n_pad = _ceil_to(self.n, self.mesh.shape["shard"])
        wiped = np.zeros((arr.shape[0], n_pad, arr.shape[2]), dtype=np.uint8)
        wiped[:, list(present)] = arr
        spec = ("data", "shard", None)
        rebuilt = rebuild_sharded(self.mesh, shard_put(self.mesh, wiped, spec),
                                  present, self.d, self.p)
        out = gather(self.mesh, rebuilt, spec)[:b, list(wanted)]
        return self._finish(out[0] if squeeze else out.contiguous())


def _all_device_mesh_coder(d: int, p: int, device="cuda") -> MeshCoder:
    """Registry factory: MeshCoder over every rank of the world (a world of
    one where none is launched), so `-coder mesh` works like any other
    coder name (ops.coder.get_coder imports this module when asked)."""
    from .mesh import build_mesh
    return MeshCoder(build_mesh(device=device), d, p)


register_coder("mesh", _all_device_mesh_coder)
