"""Device mesh of the EC compute plane over torch.distributed.

Port of seaweedfs_tpu/parallel/mesh.py. The reference lays its devices out
as a ('data', 'shard') jax Mesh inside one process. Here every device is a
rank of a torch.distributed world, and rank r sits at
(data, shard) = divmod(r, n_shard), the row-major order of the reference's
``np.reshape`` (mesh.py:47).

Mesh axes:
* ``data``  — stripe-batch data parallelism: different volumes/rows on
  different devices (reference command_ec_encode.go:113-126 spreads
  ec.encode jobs over volume servers).
* ``shard`` — shard parallelism: the n=d+p output shards are partitioned
  across devices, as shards live on distinct servers
  (balancedEcDistribution, command_ec_encode.go:333). Rebuild all_gathers
  survivors along this axis — the device analogue of the cross-host shard
  fetch in store_ec.go:367-400.

A mesh holds its device, one process group per ``shard`` row and per
``data`` column (a group that spans the whole world is the world's own),
and the world group for reductions over both axes. Collectives run over
NCCL on CUDA and gloo on the CPU; nothing switches between them on its own.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..ops.coder import resolve_device

AXES = ("data", "shard")
#: how long a collective waits for a missing peer before it raises
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """This rank's view of a ('data', 'shard') mesh over the current
    torch.distributed world. `shape` maps each axis to its size."""

    def __init__(self, n_data: int, n_shard: int, device: torch.device,
                 owns_world: bool = False):
        self.shape = {"data": n_data, "shard": n_shard}
        self.rank = dist.get_rank()
        self.device = device
        self._owns_world = owns_world
        data_idx, shard_idx = divmod(self.rank, n_shard)
        self._index = {"data": data_idx, "shard": shard_idx}
        # every rank creates every group, in the same order (new_group is
        # collective over the world); each keeps the ones it belongs to
        rows = [[r * n_shard + s for s in range(n_shard)] for r in range(n_data)]
        cols = [[r * n_shard + s for r in range(n_data)] for s in range(n_shard)]
        self._groups = {
            "shard": _groups(rows)[data_idx],
            "data": _groups(cols)[shard_idx],
            AXES: dist.group.WORLD,
        }

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (jax.lax.axis_index)."""
        return self._index[axis]

    def group(self, axes):
        """The process group of the ranks that share every coordinate but
        those along `axes` ("data", "shard" or both as a tuple)."""
        return self._groups[tuple(axes) if isinstance(axes, (tuple, list))
                            else axes]

    def close(self) -> None:
        """Destroy the world if this mesh initialised it (a world of one);
        a launched world belongs to its launcher."""
        if self._owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_world = False

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, shard={self.shape['shard']}, "
                f"rank={self.rank}, device={self.device})")


def _groups(rank_lists):
    world = dist.get_world_size()
    return [dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
            for ranks in rank_lists]


def default_shard_axis(n: int) -> int:
    """The reference's rule (mesh.py:39-46): 4 or 2 where it divides n,
    else 1 — a single device gives 1x1, 8 devices 2x4."""
    for cand in (4, 2):
        if n % cand == 0 and cand <= n:
            return cand
    return 1


def _rank_device(device: torch.device) -> torch.device:
    """This rank's device: on CUDA the card of its local rank."""
    if device.type != "cuda":
        return device
    if device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local} has no card: "
                           f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", local)


def _init_world_of_one(device: torch.device) -> None:
    """A world of one over an in-process store: NCCL bound to the card on
    CUDA (collectives are then copies on the card), gloo on the CPU."""
    kwargs = dict(store=dist.HashStore(), rank=0, world_size=1,
                  timeout=COLLECTIVE_TIMEOUT)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(_BACKEND[device.type], **kwargs)


def build_mesh(n_devices: "int | None" = None, shard_axis: "int | None" = None,
               device="cuda") -> Mesh:
    """2-D ('data', 'shard') mesh over the torch.distributed world.

    The world already launched (torchrun, parallel/launch.py) is used as it
    is and must hold exactly `n_devices` ranks when that is given. Where
    there is none, a world of one is initialised for `n_devices` None or
    1; a host with several cards and no launched world raises rather than
    use one of them. `shard_axis` defaults to min(n, 4) rounded down to a
    divisor of n (reference mesh.py:39-46).
    """
    device = resolve_device(device)
    owns = False
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"requested {n_devices} devices, only 1 available: no "
                f"torch.distributed world is launched (start {n_devices} "
                f"ranks with torchrun or seaweedfs_tpu_torch.parallel.launch."
                f"launch, one per device)")
        if (device.type == "cuda" and n_devices is None
                and torch.cuda.device_count() > 1):
            raise RuntimeError(
                f"{torch.cuda.device_count()} cards visible and no "
                f"torch.distributed world launched: start one rank per card "
                f"(torchrun --nproc-per-node {torch.cuda.device_count()}, or "
                f"seaweedfs_tpu_torch.parallel.launch.launch), or ask for "
                f"build_mesh(1)")
        device = _rank_device(device)
        _init_world_of_one(device)
        owns = True
    else:
        device = _rank_device(device)
    try:
        backend = str(dist.get_backend())
        if _BACKEND[device.type] not in backend:
            raise RuntimeError(
                f"the world's backend is {backend!r}; a mesh on "
                f"{device.type} needs {_BACKEND[device.type]!r}")
        n = dist.get_world_size()
        if n_devices is not None and n_devices != n:
            raise RuntimeError(
                f"requested {n_devices} devices, the launched world has "
                f"{n} ranks (one device per rank)")
        if shard_axis is None:
            shard_axis = default_shard_axis(n)
        if shard_axis <= 0 or n % shard_axis:
            raise ValueError(
                f"shard axis {shard_axis} does not divide {n} devices")
        return Mesh(n // shard_axis, shard_axis, device, owns_world=owns)
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise
