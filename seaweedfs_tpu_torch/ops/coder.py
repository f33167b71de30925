"""Pluggable ErasureCoder interface (port of seaweedfs_tpu/ops/coder.py).

Implementations:

* ``NumpyCoder`` — pure-numpy GF tables; correctness oracle, slow.
* ``TorchCoder`` — the GPU path: [B, d, L] stripe batches through the
  hand-written CUDA kernel K1 (csrc/rs_gf.cu via ops/rs_cuda.py). It runs
  on the card unless the caller passes ``device="cpu"``, which selects the
  plain PyTorch version (ops/rs_torch.py). Without CUDA it raises; it
  never drops to another backend on its own.
* ``native`` (ops/native.py) — the port's own AVX2 split-table CPU coder,
  the klauspost-style CPU baseline; raises where it cannot be built.
* ``mesh`` (parallel/pipeline.MeshCoder) — K1 sharded over a ('data',
  'shard') mesh of torch.distributed ranks.
* the layered codecs ``piggyback`` (ops/piggyback.py) and ``msr``
  (ops/product_matrix.py); they wrap a backend coder built on the device
  the caller names.

All but ``numpy`` and ``torch`` register when first asked for by name.

All coders operate on uint8 arrays shaped [d, L] / [B, d, L] and are
stateless w.r.t. data; geometry is fixed per instance.
"""

from __future__ import annotations

import abc
import importlib
import inspect

import numpy as np
import torch

from . import gf8, rs_cuda


class ErasureCoder(abc.ABC):
    #: True when encode() may return an async handle (a DeviceResult,
    #: materialized by host_result); the streaming pipeline double-buffers
    #: those and takes a zero-copy synchronous fast path for the rest.
    async_dispatch = False
    #: Erasure codec this coder implements — persisted into the .vif seal
    #: so rebuild always decodes with the codec that encoded.
    codec = "rs"

    def __init__(self, d: int, p: int):
        if d <= 0 or p <= 0 or d + p > 256:
            raise ValueError(f"invalid RS geometry ({d},{p})")
        self.d = d
        self.p = p
        self.n = d + p

    @abc.abstractmethod
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [..., d, L] uint8 -> parity [..., p, L] uint8."""

    @abc.abstractmethod
    def reconstruct(self, survivors: np.ndarray, present: tuple[int, ...],
                    wanted: tuple[int, ...]) -> np.ndarray:
        """survivors [..., d, L] = shards sorted(present)[:d] -> [..., |wanted|, L]."""

    def host_buffer(self, shape: tuple) -> np.ndarray:
        """A zeroed uint8 host array for staging this coder's inputs."""
        return np.zeros(shape, dtype=np.uint8)

    def repair_plan(self, present: "tuple[int, ...]",
                    wanted: "tuple[int, ...]", shard_size: int,
                    ) -> "list[tuple[int, int, int]] | None":
        """Byte ranges [(shard_id, offset, length), ...] of survivors
        sufficient to rebuild `wanted`, or None when nothing beats the
        trivial plan (read d full survivors). Plain RS has no sub-shard
        structure, so the answer is always None."""
        return None

    def verify(self, shards: np.ndarray) -> bool:
        """shards [..., n, L]: recompute parity from data rows and compare."""
        data = shards[..., : self.d, :]
        parity = shards[..., self.d:, :]
        return bool(np.array_equal(host_result(self.encode(data)),
                                   np.asarray(parity)))


class NumpyCoder(ErasureCoder):
    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim == 2:
            return gf8.np_encode(data, self.p)
        return np.stack([gf8.np_encode(b, self.p) for b in data])

    def reconstruct(self, survivors, present, wanted):
        survivors = np.asarray(survivors, dtype=np.uint8)
        rec = gf8.decode_matrix(self.d, self.p, list(present))[list(wanted), :]
        if survivors.ndim == 2:
            return gf8.np_gf_apply(rec, survivors)
        return np.stack([gf8.np_gf_apply(rec, b) for b in survivors])


def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on: CUDA unless the caller
    names another. Raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the GPU path needs an NVIDIA card; pass "
            "device='cpu' explicitly for the plain PyTorch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class DeviceResult:
    """Handle of one in-flight device call: the output is being copied into
    a pinned host buffer on the current stream, and `event` marks the end
    of that copy. `wait()` blocks on the event and hands over the numpy
    view of the host buffer."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event: torch.cuda.Event):
        self.host = host
        self.event = event

    def wait(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


def host_result(out) -> np.ndarray:
    """Host bytes of a coder output: an array, a tensor, or a pending
    result — anything with a ``wait()`` that hands over the array, as
    DeviceResult does."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    wait = getattr(out, "wait", None)
    if callable(wait):
        return np.asarray(wait())
    return np.asarray(out)


class TorchCoder(ErasureCoder):
    """GPU coder over kernel K1. encode/reconstruct take host arrays (or
    tensors) and, on CUDA, return a DeviceResult: the H2D copy, the kernel
    and the D2H copy of the output are all queued on the current stream
    before the call returns. The input's host memory is read by the copy
    engine after the call returns, so a caller must not refill it until
    the result has been waited on (ec/stream.AsyncPipe keeps that rule).
    Inputs from `host_buffer` are pinned, so their copy is truly async.

    With device="cpu" it runs the plain PyTorch version and returns numpy.
    """

    async_dispatch = True

    def __init__(self, d: int, p: int, device="cuda"):
        super().__init__(d, p)
        self.device = resolve_device(device)

    def host_buffer(self, shape: tuple) -> np.ndarray:
        if self.device.type != "cuda":
            return super().host_buffer(shape)
        # the numpy view keeps the pinned tensor (and its memory) alive
        return torch.zeros(shape, dtype=torch.uint8, pin_memory=True).numpy()

    def _to_device(self, arr) -> torch.Tensor:
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.uint8))
        return t.to(self.device, non_blocking=True).contiguous()

    def _finish(self, out: torch.Tensor):
        if self.device.type != "cuda":
            return out.numpy()
        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return DeviceResult(host, event)

    def encode(self, data):
        return self._finish(rs_cuda.encode(self._to_device(data), self.d, self.p))

    def reconstruct(self, survivors, present, wanted):
        return self._finish(rs_cuda.reconstruct(
            self._to_device(survivors), tuple(sorted(present)), tuple(wanted),
            self.d, self.p))


_REGISTRY = {"numpy": NumpyCoder, "torch": TorchCoder}

# backend names double as the plain-RS codec: NumpyCoder is the host
# oracle, so "rs" resolves there (repair costing, codec enumeration)
_REGISTRY["rs"] = NumpyCoder

# coders that register themselves when their module is imported; a .vif or
# a caller may name one before anything imported it. name -> (module,
# whether it is an erasure codec rather than a compute backend)
_LAZY = {
    "native": (".native", False),
    "mesh": ("..parallel.pipeline", False),
    "piggyback": (".piggyback", True),
    "msr": (".product_matrix", True),
}


def _resolve(name: str):
    if name not in _REGISTRY and name in _LAZY:
        importlib.import_module(_LAZY[name][0], __package__)
    return _REGISTRY.get(name)


def _takes(cls, arg: str) -> bool:
    """Whether constructor `cls` has a parameter named `arg` (inspected,
    not probed: a TypeError raised inside the constructor must not be
    mistaken for a missing parameter)."""
    try:
        return arg in inspect.signature(cls).parameters
    except (TypeError, ValueError):  # uninspectable callable
        return False


def get_coder(name: str, d: int, p: int, device="cuda") -> ErasureCoder:
    """Coder `name` at RS(d, p); `device` reaches every constructor that
    takes one (TorchCoder and the layered codecs' inner coders)."""
    cls = _resolve(name)
    if cls is None:
        raise ValueError(f"unknown coder {name!r}; have {sorted(_REGISTRY)}")
    if _takes(cls, "device"):
        return cls(d, p, device=device)
    return cls(d, p)


def register_coder(name: str, cls) -> None:
    _REGISTRY[name] = cls


def registered_codecs() -> "list[str]":
    """Erasure CODEC names (one per wire/disk format, not per compute
    backend). Entries may be classes or factory callables; those without
    a `codec` attribute are plain-RS backends."""
    for name, (_, is_codec) in _LAZY.items():
        if is_codec:
            _resolve(name)
    return sorted({getattr(cls, "codec", "rs") for cls in _REGISTRY.values()})


def codec_coder(codec: str, d: int, p: int, backend: str = "numpy",
                device="cuda") -> ErasureCoder:
    """Construct the coder for an erasure `codec` on a compute `backend`.
    Plain "rs" is the backend coder itself; layered codecs wrap the
    backend as their inner GF engine. A torch backend runs on `device`,
    always the caller's choice."""
    if not codec or codec == "rs":
        return get_coder(backend, d, p, device=device)
    cls = _resolve(codec)
    if cls is None or getattr(cls, "codec", "rs") != codec:
        raise ValueError(
            f"unknown erasure codec {codec!r}; have {registered_codecs()}")
    kwargs = {k: v for k, v in (("backend", backend), ("device", device))
              if _takes(cls, k)}
    return cls(d, p, **kwargs)


def repair_read_bytes(codec: str, d: int, p: int, missing, shard_size: int,
                      ) -> int:
    """Survivor bytes a rebuild of `missing` must read under `codec` —
    the repair planner's byte-costing primitive (numpy inner backend: the
    coder is consulted purely for plan geometry)."""
    missing = sorted(set(missing))
    coder = codec_coder(codec or "rs", d, p)
    present = tuple(i for i in range(d + p) if i not in missing)
    plan = coder.repair_plan(present, tuple(missing), shard_size)
    if plan is None:
        return d * shard_size
    return sum(ln for _, _, ln in plan)
