"""Piggybacked RS: a repair-efficient erasure code behind the coder seam.

Port of seaweedfs_tpu/ops/piggyback.py. The repair-bandwidth problem
(arXiv:1309.0186): rebuilding one lost shard of an RS(d, p) stripe reads d
*full* shards. The piggybacking framework (arXiv:1412.3022, the Hitchhiker
construction) cuts single-shard repair bytes ~35% without touching the
storage overhead, the systematic property or the fault tolerance: it is the
same RS code, with a little data from one substripe XOR-folded
("piggybacked") onto parities of a second.

Construction (2 substripes over the shard byte range, boundary at L/2):

* every shard's first half (**substripe a**) is a plain RS(d, p) codeword
  over the data shards' first halves;
* every shard's second half (**substripe b**) is a plain RS codeword over
  the second halves, EXCEPT parities 1..p-1, which store

      pb_g = P_g(b)  XOR  (XOR_{i in S_g} a_i)        g = 1 .. p-1

  where S_1..S_{p-1} partition the data ids round-robin. Parity 0 is never
  piggybacked, and data shards are untouched.

Single data-shard repair (shard f in group S_g) reads byte ranges: the
b-halves of the other d-1 data shards and of parity 0 decode b_f; the
piggybacked parity's b-half and the a-halves of S_g minus {f} release a_f.
Total (d + |S_g|) half-shards = (d + |S_g|) / (2d) of the plain-RS cost;
0.65-0.70x at RS(10, 4). With p = 2 the only group is all of [d] and the
plan degenerates to the trivial one (repair_plan returns None).

The GF(2^8) math rides the inner coder — TorchCoder by default, so kernel
K1 (csrc/rs_gf.cu) on the card, or the plain PyTorch version with
device="cpu" — and every inner output goes through `host_result`. The XOR
folds stay numpy on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np

from .coder import ErasureCoder, get_coder, host_result, register_coder


def partition_groups(d: int, p: int) -> "list[list[int]]":
    """Round-robin partition of data ids 0..d-1 into p-1 piggyback groups;
    groups[g-1] backs parity g. Derived from (d, p) alone, so nothing
    extra is persisted in the .vif."""
    if p < 2:
        return []
    return [[i for i in range(d) if i % (p - 1) == g] for g in range(p - 1)]


class PiggybackCoder(ErasureCoder):
    """Hitchhiker-style piggybacked RS over an inner backend coder.

    The last axis is one shard's full byte range and the substripe boundary
    sits at L // 2 (L must be even). encode/reconstruct accept [d|k, L] and
    batched [B, d|k, L] like every other coder, and return host arrays.
    """

    codec = "piggyback"
    async_dispatch = False  # host-orchestrated; inner device calls still batch

    def __init__(self, d: int, p: int, backend: str = "torch", device="cuda"):
        super().__init__(d, p)
        if p < 2:
            raise ValueError("piggyback needs p >= 2 (nothing to fold onto)")
        self.backend = backend
        self.inner = get_coder(backend, d, p, device=device)
        self.groups = partition_groups(d, p)

    def group_of(self, f: int) -> tuple[int, list[int]]:
        """(parity index g in 1..p-1, data ids of f's group)."""
        g = f % (self.p - 1)
        return g + 1, self.groups[g]

    # -- array construction --------------------------------------------------
    @staticmethod
    def _split(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
        half = arr.shape[-1] // 2
        if arr.shape[-1] != half * 2:
            raise ValueError(f"piggyback needs an even length, got {arr.shape[-1]}")
        return arr[..., :half], arr[..., half:], half

    def _xor_group(self, a_data: np.ndarray, grp: "list[int]") -> np.ndarray:
        """XOR of the group's rows of a_data [..., d, half]."""
        if not grp:  # d < p-1 leaves trailing groups empty: zero piggyback
            return np.zeros(a_data.shape[:-2] + a_data.shape[-1:],
                            dtype=np.uint8)
        return np.bitwise_xor.reduce(a_data[..., grp, :], axis=-2)

    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        parity = np.array(host_result(self.inner.encode(data)), dtype=np.uint8)
        a, _b, _half = self._split(data)
        for g, grp in enumerate(self.groups, start=1):
            parity[..., g, parity.shape[-1] // 2:] ^= self._xor_group(a, grp)
        return parity

    def reconstruct(self, survivors: np.ndarray, present: tuple[int, ...],
                    wanted: tuple[int, ...]) -> np.ndarray:
        """survivors = shards sorted(present)[:d], FULL shard ranges.

        Substripe a is plain RS everywhere, so missing a-halves come straight
        from the inner decode; b-halves of surviving piggybacked parities are
        first purified (their piggyback XOR-ed back off using the recovered
        a substripe), decoded as plain RS, and wanted piggybacked parities
        get their piggyback re-applied.
        """
        survivors = np.asarray(survivors, dtype=np.uint8)
        squeeze = survivors.ndim == 2
        if squeeze:
            survivors = survivors[None]
        wanted = tuple(wanted)
        used = tuple(sorted(present))[: self.d]
        a, b, half = self._split(survivors)
        # one inner decode serves both the X_g terms (all data a-halves)
        # and the wanted rows' a-halves
        want_a = tuple(range(self.d)) + tuple(w for w in wanted if w >= self.d)
        a_rows = host_result(self.inner.reconstruct(a, present, want_a))
        a_data = a_rows[:, : self.d]
        xg = {g: self._xor_group(a_data, grp)
              for g, grp in enumerate(self.groups, start=1)}
        b_pure = np.array(b, dtype=np.uint8)
        for idx, s in enumerate(used):
            if s > self.d:  # piggybacked parity survivor
                b_pure[:, idx] ^= xg[s - self.d]
        b_rows = host_result(self.inner.reconstruct(b_pure, present, wanted))
        out = np.empty(survivors.shape[:1] + (len(wanted), 2 * half),
                       dtype=np.uint8)
        for wi, w in enumerate(wanted):
            if w < self.d:
                out[:, wi, :half] = a_rows[:, w]
            else:
                out[:, wi, :half] = a_rows[:, self.d + want_a[self.d:].index(w)]
            brow = b_rows[:, wi]
            if w > self.d:
                brow = brow ^ xg[w - self.d]
            out[:, wi, half:] = brow
        return out[0] if squeeze else out

    # -- ranged repair -------------------------------------------------------
    def repair_plan(self, present: tuple[int, ...], wanted: tuple[int, ...],
                    shard_size: int):
        """Byte ranges of survivors needed to rebuild `wanted`, or None when
        no plan beats reading d full shards (multi-loss, parity loss, p = 2,
        or a required survivor itself missing)."""
        present = set(present)
        if len(wanted) != 1 or shard_size % 2:
            return None
        f = wanted[0]
        if not 0 <= f < self.d:
            return None
        g, grp = self.group_of(f)
        if len(grp) >= self.d:  # p == 2: the "plan" would read d full shards
            return None
        need_b = [i for i in range(self.d) if i != f] + [self.d, self.d + g]
        need_a = [i for i in grp if i != f]
        if any(s not in present for s in need_b + need_a):
            return None
        half = shard_size // 2
        return ([(s, half, half) for s in need_b]
                + [(s, 0, half) for s in need_a])


register_coder("piggyback", PiggybackCoder)
