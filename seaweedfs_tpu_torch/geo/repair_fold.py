"""Per-helper repair matrices: the GF-linear view of the MSR decode.

Port of seaweedfs_tpu/geo/repair_fold.py.

`repair_decode` (ops/product_matrix.py) recovers a failed node from
every helper's repair-plane symbols through pair-uncoupling and a
precomputed fiber solve — GF(256) multiply-LUT and XOR steps only, so
the whole decode is linear in the helpers' plane symbols:

    lost[alpha, W] = XOR_i  M_i (x) c_i[planes]      M_i in [alpha, beta]

with beta = alpha/q planes per helper. That linearity is what the geo
plane cashes in: a relay holder on the far side of an expensive link
can gather its DC-local peers' raw plane rows (cheap intra-DC), apply
the horizontally stacked matrix hstack(M_i for i in group), and ship
ONE folded partial of alpha rows across the thin link instead of
|group|*beta raw rows. XOR-ing folded partials with the near-side
decode reproduces `repair_decode`'s output byte-identically.

Per-helper compression below beta is information-theoretically
impossible (beta IS the cut-set minimum), so folding only pays when a
far group is larger than q: |group|*beta > alpha <=> |group| > q.

The matrices are extracted by probing `repair_decode` with unit
vectors — one W=1 decode per (helper, plane), (n-1)*beta probes total,
cached per (d, p, f). Probing keeps this module honest against any
future decode change: the identity above is re-derived from the real
decode, never hand-maintained.

A relay applies the stacked matrix on its host with gf8.np_gf_apply. Kernel
K1 does not take it: a [alpha, |group|*beta] matrix (e.g. [256, 640] at
RS(14,2)) needs ~5 MB of field tables, far over K1's 48 KiB of shared
memory (csrc/rs_gf.cu).
"""

from __future__ import annotations

import functools

import numpy as np

from ..ops.product_matrix import ProductMatrixCoder


@functools.lru_cache(maxsize=128)
def helper_matrices(d: int, p: int, f: int) -> dict:
    """{sid: M_sid[alpha, beta]} over all n-1 helpers of failed node f.

    Matrices are read-only uint8 arrays; beta columns follow the
    ascending `repair_planes(f)` order (the same order the repair
    fragment ranges are fetched in).
    """
    coder = ProductMatrixCoder(d, p, backend="numpy")
    g = coder.grid
    if g.q < 2:
        raise ValueError(f"msr repair-plane path needs q >= 2, got p={p}")
    if not 0 <= f < coder.n:
        raise ValueError(f"failed node {f} out of range n={coder.n}")
    planes = g.repair_planes(f)
    beta = len(planes)
    mats: dict[int, np.ndarray] = {}
    for sid in range(coder.n):
        if sid == f:
            continue
        m = np.zeros((g.alpha, beta), dtype=np.uint8)
        for j in range(beta):
            c = np.zeros((g.nbar, g.alpha, 1), dtype=np.uint8)
            c[sid, planes[j], 0] = 1
            m[:, j] = coder.repair_decode(c, f)[:, 0]
        m.setflags(write=False)
        mats[sid] = m
    return mats


def stacked_matrix(d: int, p: int, f: int, sids: "tuple[int, ...]",
                   ) -> np.ndarray:
    """hstack(M_sid for sid in sids) — the combine_matrix a relay
    applies to its group's stacked plane rows (rows ordered sid-major,
    plane-minor, matching `sids` order then ascending planes)."""
    mats = helper_matrices(d, p, f)
    return np.concatenate([mats[sid] for sid in sids], axis=1)


def fold_groups(helper_dcs: "dict[int, str]", local_dc: str, q: int,
                ) -> "list[tuple[str, tuple[int, ...]]]":
    """Partition far-DC helpers into foldable groups.

    helper_dcs maps sid -> data center of a reachable holder ("" when
    unknown). Returns [(dc, sids)] for every remote DC whose helper
    count exceeds q — smaller groups ship raw plane rows anyway
    (|group|*beta <= alpha), so folding them only adds a relay hop.
    Unknown-DC helpers never fold. Groups and members sort ascending
    for deterministic wire plans.
    """
    if not local_dc:
        return []
    by_dc: dict[str, list[int]] = {}
    for sid, dc in helper_dcs.items():
        if dc and dc != local_dc:
            by_dc.setdefault(dc, []).append(sid)
    return [(dc, tuple(sorted(sids)))
            for dc, sids in sorted(by_dc.items()) if len(sids) > q]
