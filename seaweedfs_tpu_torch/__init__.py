"""PyTorch/CUDA port of the erasure-coding data-integrity plane.

The package mirrors ``seaweedfs_tpu``'s layout (``ops/``, ``ec/``,
``models/``, ``storage/``, ``utils/``) and shares its on-disk format: a
volume encoded by either package rebuilds and decodes with the other. It
imports ``torch`` and never ``jax``. Device work runs on an NVIDIA GPU
through the hand-written CUDA kernels in ``csrc/`` (``rs_gf.cu``, the
GF(2^8) apply; ``crc32c.cu``, the batched CRC32C), on one card or sharded
over a ('data', 'shard') mesh of ``torch.distributed`` ranks
(``parallel/``); entry points default to ``device="cuda"`` and raise when
there is no card. An explicit ``device="cpu"`` selects the plain PyTorch
versions.
"""

import os as _os

# Opt-in runtime lock-order detector (utils/locktrack.py): patching here
# means any entry point — pytest, `python -m seaweedfs_tpu_torch`, a server
# started in a subprocess — gets tracked locks by exporting one env var,
# before any module of the package creates its first lock.
if _os.environ.get("SWTPU_LOCKCHECK") == "1":  # pragma: no cover
    from .utils import locktrack as _locktrack

    _locktrack.install()
