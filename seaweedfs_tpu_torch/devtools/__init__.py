"""Developer tooling for the concurrency correctness plane.

`swtpu_lint` is the AST-based static analyzer (`make lint`,
`python -m seaweedfs_tpu_torch.devtools.swtpu_lint`); its runtime sibling is
`utils/locktrack.py` (SWTPU_LOCKCHECK=1), which watches real lock
acquisition order instead of source text. Both exist because the same
*classes* of concurrency bug kept recurring (I/O under a lock, wall-clock
deadlines, silenced exceptions, leaked threads) — classes are exactly what
tooling can extinguish.
`crashsim` is the crash-consistency plane's enumerator over the
utils/fstrack shim.

The port's copy of seaweedfs_tpu/devtools/, pointed at the port's own
tree and surfaces.
"""
