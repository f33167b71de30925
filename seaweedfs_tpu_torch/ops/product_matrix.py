"""Product-matrix MSR regenerating codec: bandwidth-optimal repair for ANY
single shard loss, data or parity.

Port of seaweedfs_tpu/ops/product_matrix.py. The piggybacked codec
(ops/piggyback.py) buys ~0.65x repair bytes but only for single-*data*-shard
loss, and degenerates to plain RS at p = 2. A minimum-storage regenerating
(MSR) code reaches the cut-set bound for every single loss: with all n-1
survivors helping, repair moves

    (n - 1) / p   shard-equivalents        (vs d for plain RS)

i.e. 7.5 vs 14 at RS(14,2) and 3.25 vs 10 at RS(10,4), at the same storage
overhead and fault tolerance (the code stays MDS).

Construction (product-matrix pairwise coupling over layered RS):

* every shard file splits into alpha = q^t sub-symbols ("layers"), q = p,
  t = ceil(n / q); grid node i sits at (x, y) = (i % q, i // q) and layers
  are addressed by a base-q word z = (z_0 .. z_{t-1}), z_0 most significant
  in the linear index;
* per layer, the *uncoupled* symbols U(i; z) across the q*t grid nodes form
  one codeword of a systematic RS code with q parities (ops/gf8.py);
* the *stored* symbols C come from U via an invertible 2x2 product matrix
  across symbol pairs: for x != z_y the symbols at (x, y; z) and
  (z_y, y; z') with z' = z(y -> x) couple as

      [C ]   [1      gamma] [U ]
      [C*] = [gamma  1    ] [U*]          gamma^2 != 1

  while diagonal symbols (x == z_y) store uncoupled (C = U).

Data nodes store their coupled symbols AS the raw striped volume bytes, so
data shard files are byte-identical to plain RS. When n does not fill the
q x t grid the trailing grid nodes are virtual all-zero shards.

Repair of node (x0, y0) reads, from each of the n-1 survivors, only the
alpha/q layers with z_{y0} = x0 (the "repair planes"). Everything — encode,
d-survivor decode, repair, degraded interval reads — reduces to
`decode_coupled` (score-ordered layered decode, optionally restricted to a
closure layer set) and `repair_decode` (fiber systems over repair planes).

Their GF matrix applies (`_apply`) run on kernel K1's `gf_apply` entry
(csrc/rs_gf.cu through ops/rs_cuda.py) on the coder's device — the plain
PyTorch version for device="cpu" — in place of the reference's
rs_jax.apply_bitmatrix; a failed build or launch raises. On a "numpy"
backend they are gf8.np_gf_apply. The index bookkeeping (multiply-LUT fancy
indexing, the score loop) stays numpy on the host, as in the reference.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import gf8, rs_cuda
from .coder import ErasureCoder, get_coder, register_coder

# coupling coefficient: any gamma with gamma^2 != 1 keeps the 2x2
# product matrix invertible over GF(2^8)
GAMMA = 2


@functools.lru_cache(maxsize=32)
def _grid(d: int, p: int) -> "_Grid":
    return _Grid(d, p)


class _Grid:
    """Geometry + index precomputation shared by every (d, p) instance."""

    def __init__(self, d: int, p: int):
        self.d = d
        self.p = p
        self.n = d + p
        self.q = q = max(1, p)
        self.t = t = -(-self.n // q)  # ceil
        self.nbar = q * t
        self.alpha = q ** t
        g2 = gf8.gf_mul(GAMMA, GAMMA)
        self.inv_1g2 = gf8.gf_inv(1 ^ g2)
        # 256-entry multiply LUTs: scalar-by-vector in one fancy index
        self.mul_gamma = gf8.GF_MUL[GAMMA]
        self.mul_inv = gf8.GF_MUL[self.inv_1g2]
        self.mul_1g2 = gf8.GF_MUL[1 ^ g2]
        # digits[y, Z] = column-y (most-significant-first) base-q digit
        zs = np.arange(self.alpha)
        self.digits = np.stack(
            [(zs // q ** (t - 1 - y)) % q for y in range(t)])
        self.xs = np.arange(self.nbar) % q
        self.ys = np.arange(self.nbar) // q
        # pairing tables [nbar, alpha]
        zy = self.digits[self.ys]                     # own-column digit
        self.unpaired = zy == self.xs[:, None]
        self.pair_node = self.ys[:, None] * q + zy    # grid node (z_y, y)
        step = (q ** (t - 1 - self.ys))[:, None]
        self.pair_layer = zs[None, :] + (self.xs[:, None] - zy) * step
        # per-layer scalar code: parity-check H = [P | I_q] of the
        # systematic RS [nbar, nbar-q] code (any q columns of an MDS
        # parity-check matrix are invertible)
        kbar = self.nbar - q
        self.H = np.concatenate(
            [gf8.parity_matrix(kbar, q), np.eye(q, dtype=np.uint8)], axis=1)

    def coords(self, i: int) -> tuple[int, int]:
        return i % self.q, i // self.q

    def col_step(self, y: int) -> int:
        """Linear-index stride of column y's digit."""
        return self.q ** (self.t - 1 - y)

    def repair_planes(self, f: int) -> np.ndarray:
        """Ascending layer ids with digit y0 fixed at x0 (alpha/q)."""
        x0, y0 = self.coords(f)
        return np.nonzero(self.digits[y0] == x0)[0]

    def fiber(self, f: int, planes: np.ndarray) -> np.ndarray:
        """fiber[x, j] = plane j with digit y0 replaced by x."""
        x0, y0 = self.coords(f)
        step = self.col_step(y0)
        base = planes - x0 * step
        return base[None, :] + np.arange(self.q)[:, None] * step

    def plane_of(self, f: int, layers: np.ndarray) -> np.ndarray:
        """Each layer's fiber representative (digit y0 set to x0)."""
        x0, y0 = self.coords(f)
        step = self.col_step(y0)
        return layers + (x0 - self.digits[y0][layers]) * step

    @functools.lru_cache(maxsize=64)
    def solve_matrices(self, used: tuple) -> tuple:
        """(erased ids, known ids, M) with U_erased = M (x) U_known per
        layer: M = inv(H[:, erased]) (x) H[:, known]."""
        known = sorted(set(used) | set(range(self.n, self.nbar)))
        erased = tuple(i for i in range(self.nbar) if i not in known)
        inv = gf8.gf_mat_inv(self.H[:, list(erased)])
        m = gf8.gf_matmul(inv, self.H[:, known])
        m.setflags(write=False)
        return erased, tuple(known), m

    @functools.lru_cache(maxsize=64)
    def repair_matrices(self, f: int) -> tuple:
        """Single-loss fiber system (col0 real helpers, off-column grid
        ids, M = inv(A) (x) B).

        Per repair plane z the parity checks reduce to A U_fiber = B r:
        column x0 of A is H[:, f] and column x != x0 is gamma-scaled
        H[:, (x, y0)] (their U substitutes C + gamma U_fiber through the
        product matrix, virtual col0 nodes contributing C = 0); r stacks
        the off-column nodes' uncoupled U's then the real col0 helpers'
        raw C's.
        """
        x0, y0 = self.coords(f)
        col0 = [y0 * self.q + x for x in range(self.q)]
        col0_real = tuple(i for i in col0 if i < self.n and i != f)
        others = tuple(i for i in range(self.nbar) if i not in col0)
        a = np.zeros((self.q, self.q), dtype=np.uint8)
        for x in range(self.q):
            i = y0 * self.q + x
            a[:, x] = self.H[:, f] if i == f else self.mul_gamma[self.H[:, i]]
        b = np.concatenate(
            [self.H[:, list(others)], self.H[:, list(col0_real)]], axis=1)
        m = gf8.gf_matmul(gf8.gf_mat_inv(a), b)
        m.setflags(write=False)
        return col0_real, others, m


@dataclass
class IntervalPlan:
    """Fetch spec for a degraded read of [offset, offset+length) of one
    lost shard: per-survivor layer lists at a common inner window."""
    mode: str                            # "repair" | "general"
    f: int
    offset: int
    length: int
    shard_size: int
    alpha: int
    inner: tuple[int, int]               # [u0, u1) within each layer
    fetch: "dict[int, list[int]]"        # sid -> ascending layer ids
    planes: "np.ndarray | None" = None   # repair mode: fiber representatives
    used: tuple = ()                     # general mode: d survivors decoded
    closure: "np.ndarray | None" = None  # general mode: processed layers

    def byte_ranges(self, sid: int) -> "list[tuple[int, int]]":
        """(file offset, length) reads realizing this plan for `sid`."""
        s = self.shard_size // self.alpha
        u0, u1 = self.inner
        return [(z * s + u0, u1 - u0) for z in self.fetch.get(sid, ())]

    def bytes_total(self) -> int:
        u0, u1 = self.inner
        return sum(len(v) for v in self.fetch.values()) * (u1 - u0)


class ProductMatrixCoder(ErasureCoder):
    """MSR product-matrix regenerating code over a pluggable GF backend.

    Array semantics: the last axis is one shard's FULL byte range (or a
    same-width slice of every sub-symbol — any length divisible by
    alpha); sub-symbol ell of a row occupies bytes [ell*S, (ell+1)*S).
    encode / reconstruct accept [d, L] and batched [B, d, L] like every
    other coder.
    """

    codec = "msr"
    async_dispatch = False  # host-orchestrated; GF matmuls batch on device

    def __init__(self, d: int, p: int, backend: str = "torch", device="cuda"):
        super().__init__(d, p)
        self.backend = backend
        self.inner = get_coder(backend, d, p, device=device)
        # the torch.device of the GF applies; None on a host backend
        self.device = getattr(self.inner, "device", None)
        self.grid = _grid(d, p)

    @property
    def alpha(self) -> int:
        return self.grid.alpha

    @property
    def beta_layers(self) -> int:
        """Sub-symbols each survivor ships for a single-loss repair."""
        return self.grid.alpha // self.grid.q

    def _check_len(self, length: int) -> int:
        if length % self.alpha:
            raise ValueError(
                f"msr needs a length divisible by alpha={self.alpha} "
                f"(q^t for q={self.grid.q}, t={self.grid.t}), got {length}; "
                "shard files are block multiples, so pick a power-of-two p "
                "or a small_block divisible by alpha")
        return length // self.alpha

    # -- GF matrix application (kernel K1 on the card) ----------------------
    def _apply(self, mat: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """mat [m, k] (x) rows [k, L] -> [m, L]: rs_cuda.gf_apply on the
        coder's device (K1 on CUDA, the plain version on the CPU), or
        gf8.np_gf_apply on a host backend. No fallback: a failed build or
        launch raises."""
        if rows.shape[-1] == 0 or mat.shape[0] == 0 or mat.shape[1] == 0:
            return np.zeros((mat.shape[0], rows.shape[-1]), dtype=np.uint8)
        if self.device is None:
            return gf8.np_gf_apply(mat, rows)
        x = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.uint8))
        return rs_cuda.gf_apply(mat, x.to(self.device)).cpu().numpy()

    # -- core: score-ordered layered decode --------------------------------
    def decode_coupled(self, c: np.ndarray, used: tuple,
                       layers: "np.ndarray | None" = None) -> np.ndarray:
        """Fill the erased rows of c [nbar, alpha, W] in place.

        `c` carries coupled symbols for the `used` real nodes (the first
        d of them decide) and zeros for virtual nodes; the other q real
        nodes are recovered. `layers` restricts processing to a closure
        set (degraded interval reads): the set must be closed under
        digit substitution at the erased nodes' columns, and c must also
        be populated at the pair slices read_closure() lists.
        """
        g = self.grid
        used = tuple(sorted(used))[: self.d]
        erased, known, m = g.solve_matrices(used)
        known_a = np.asarray(known)
        erased_a = np.asarray(erased)
        ls = np.arange(g.alpha) if layers is None else np.asarray(layers)
        if len(ls) == 0:
            return c
        score = np.zeros(len(ls), dtype=np.int64)
        for e in erased:
            score += g.digits[g.ys[e]][ls] == g.xs[e]
        erased_mask = np.zeros(g.nbar, dtype=bool)
        erased_mask[erased_a] = True
        u = np.zeros_like(c)
        # survivor U where the symbol is uncoupled or its pair is known:
        # one vectorized 2x2 product-matrix inversion
        kn = known_a[:, None]
        unp = g.unpaired[kn, ls]
        pn, pl = g.pair_node[kn, ls], g.pair_layer[kn, ls]
        uk = np.where(unp[..., None], c[kn, ls],
                      g.mul_inv[c[kn, ls] ^ g.mul_gamma[c[pn, pl]]])
        pair_known = ~erased_mask[pn]
        u[kn, ls] = np.where((unp | pair_known)[..., None], uk, 0)
        rule3 = ~unp & ~pair_known  # survivor coupled with an erased node
        w = c.shape[-1]
        for s in range(int(score.max()) + 1):
            sel = score == s
            if not sel.any():
                continue
            zsel = ls[sel]
            r3 = rule3[:, sel]
            if r3.any():
                # pair is erased: its U at the score-(s-1) pair layer is
                # already solved, so U = C + gamma U_pair
                ki, li = np.nonzero(r3)
                nodes, lz = known_a[ki], zsel[li]
                u[nodes, lz] = (c[nodes, lz]
                                ^ g.mul_gamma[u[g.pair_node[nodes, lz],
                                                g.pair_layer[nodes, lz]]])
            rhs = u[known_a[:, None], zsel].reshape(len(known), -1)
            sol = self._apply(m, rhs)
            u[erased_a[:, None], zsel] = sol.reshape(len(erased),
                                                     len(zsel), w)
        # stored symbols of the erased nodes from the now-complete U
        en = erased_a[:, None]
        unp_e = g.unpaired[en, ls]
        pn_e, pl_e = g.pair_node[en, ls], g.pair_layer[en, ls]
        c[en, ls] = np.where(unp_e[..., None], u[en, ls],
                             u[en, ls] ^ g.mul_gamma[u[pn_e, pl_e]])
        return c

    def read_closure(self, used: tuple, wanted_layers: np.ndarray,
                     ) -> "tuple[np.ndarray, dict[int, np.ndarray]]":
        """(closure, fetch) for a restricted decode_coupled: closure is
        wanted_layers closed under digit substitution at the erased
        columns; fetch[sid] adds each known node's pair slices."""
        g = self.grid
        used = tuple(sorted(used))[: self.d]
        erased, known, _ = g.solve_matrices(used)
        closure = np.unique(np.asarray(wanted_layers))
        for yc in sorted({int(g.ys[e]) for e in erased}):
            step = g.col_step(yc)
            base = closure - g.digits[yc][closure] * step
            closure = np.unique(
                (base[None, :] + np.arange(g.q)[:, None] * step).ravel())
        fetch: dict[int, set] = {i: set(closure.tolist())
                                 for i in used}
        # pair slices: every known node's U (virtual grid nodes included
        # — their own C is zero but their coupling partner's is not)
        for i in known:
            paired = ~g.unpaired[i, closure]
            for z in closure[paired]:
                pnode = int(g.pair_node[i, z])
                if pnode < self.n and pnode not in erased:
                    fetch.setdefault(pnode, set()).add(int(g.pair_layer[i, z]))
        return closure, {i: np.asarray(sorted(v)) for i, v in fetch.items()}

    def encode_subsymbols(self, data_sub: np.ndarray) -> np.ndarray:
        """data_sub [d, alpha, W] -> parity [p, alpha, W]."""
        g = self.grid
        c = np.zeros((g.nbar, g.alpha, data_sub.shape[-1]), dtype=np.uint8)
        c[: self.d] = data_sub
        self.decode_coupled(c, tuple(range(self.d)))
        return c[self.d: self.n].copy()

    # -- ErasureCoder contract ---------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        squeeze = data.ndim == 2
        if squeeze:
            data = data[None]
        b, k, L = data.shape
        if L == 0:
            out = np.zeros((b, self.p, 0), dtype=np.uint8)
            return out[0] if squeeze else out
        s = self._check_len(L)
        # batch elements are independent stripes and every relation is
        # elementwise along the inner axis, so fold B into it
        sub = data.reshape(b, k, self.alpha, s).transpose(1, 2, 0, 3)
        par = self.encode_subsymbols(sub.reshape(k, self.alpha, b * s))
        par = par.reshape(self.p, self.alpha, b, s).transpose(2, 0, 1, 3)
        par = par.reshape(b, self.p, L)
        return par[0] if squeeze else par

    def reconstruct(self, survivors: np.ndarray, present: tuple,
                    wanted: tuple) -> np.ndarray:
        survivors = np.asarray(survivors, dtype=np.uint8)
        squeeze = survivors.ndim == 2
        if squeeze:
            survivors = survivors[None]
        b, k, L = survivors.shape
        if k < self.d:
            raise ValueError(f"need {self.d} survivors, got {k}")
        wanted = tuple(wanted)
        if L == 0:
            out = np.zeros((b, len(wanted), 0), dtype=np.uint8)
            return out[0] if squeeze else out
        s = self._check_len(L)
        used = tuple(sorted(present))[: self.d]
        g = self.grid
        sub = survivors[:, : self.d].reshape(b, self.d, self.alpha, s)
        sub = sub.transpose(1, 2, 0, 3).reshape(self.d, self.alpha, b * s)
        c = np.zeros((g.nbar, g.alpha, b * s), dtype=np.uint8)
        c[np.asarray(used)] = sub
        self.decode_coupled(c, used)
        out = c[np.asarray(wanted, dtype=np.int64)]
        out = out.reshape(len(wanted), self.alpha, b, s).transpose(2, 0, 1, 3)
        out = out.reshape(b, len(wanted), L)
        return out[0] if squeeze else out

    # -- single-loss repair: the MSR fast path -----------------------------
    def repair_supported(self, present: tuple, wanted: tuple,
                         shard_size: int) -> bool:
        """True when the (n-1)-helper repair-plane path applies."""
        if len(wanted) != 1 or self.grid.q < 2:
            return False
        if shard_size <= 0 or shard_size % self.alpha:
            return False
        f = wanted[0]
        if not 0 <= f < self.n:
            return False
        return (set(range(self.n)) - {f}) <= set(present)

    def repair_fragment_ranges(self, f: int, shard_size: int,
                               ) -> "list[tuple[int, int]]":
        """Coalesced (offset, length) byte runs of the repair planes —
        identical for every helper. Runs are maximal: consecutive layer
        ids merge, so a failed node at a high grid column costs one
        contiguous range and a low column alpha/q of them."""
        s = shard_size // self.alpha
        runs: list[tuple[int, int]] = []
        for z in self.grid.repair_planes(f):
            off = int(z) * s
            if runs and runs[-1][0] + runs[-1][1] == off:
                runs[-1] = (runs[-1][0], runs[-1][1] + s)
            else:
                runs.append((off, s))
        return runs

    def repair_plan(self, present: tuple, wanted: tuple, shard_size: int):
        """Byte-range view of the fragment plan (the coder-seam contract
        and the planner's byte costing): every helper contributes its
        repair planes — (n-1)/p shard-equivalents total, for data AND
        parity losses alike. None when the repair-plane path cannot run
        (multi-loss, a missing helper, q < 2, alpha-unaligned shard);
        the executor then streams the general coupled decode over d
        full survivors, reading each exactly once."""
        if not self.repair_supported(present, wanted, shard_size):
            return None
        f = wanted[0]
        runs = self.repair_fragment_ranges(f, shard_size)
        return [(sid, off, ln)
                for sid in range(self.n) if sid != f
                for off, ln in runs]

    def repair_decode(self, c: np.ndarray, f: int,
                      planes: "np.ndarray | None" = None) -> np.ndarray:
        """Recover the failed node from repair-plane symbols.

        c [nbar, alpha, W] carries helper symbols at the repair planes
        (plus, when `planes` restricts to a subset, the off-column pair
        slices interval_plan lists); virtual rows are zeros. Returns the
        failed node's [alpha, W] — only the processed fibers are
        populated when restricted.
        """
        g = self.grid
        x0, y0 = g.coords(f)
        if planes is None:
            planes = g.repair_planes(f)
        planes = np.asarray(planes)
        col0_real, others, m = g.repair_matrices(f)
        others_a = np.asarray(others)
        w = c.shape[-1]
        # off-column U at the repair planes: both product-matrix inputs
        # are helper (or virtual zero) symbols at repair planes
        on = others_a[:, None]
        unp = g.unpaired[on, planes]
        pn, pl = g.pair_node[on, planes], g.pair_layer[on, planes]
        u_oth = np.where(unp[..., None], c[on, planes],
                         g.mul_inv[c[on, planes] ^ g.mul_gamma[c[pn, pl]]])
        rows = [u_oth]
        if col0_real:
            rows.append(c[np.asarray(col0_real)[:, None], planes])
        rhs = np.concatenate(rows, axis=0).reshape(-1, len(planes) * w)
        u_fiber = self._apply(m, rhs).reshape(g.q, len(planes), w)
        fib = g.fiber(f, planes)              # [q, planes] layer ids
        u_f = np.zeros((g.alpha, w), dtype=np.uint8)
        u_f[fib.reshape(-1)] = u_fiber.reshape(-1, w)
        out = np.zeros((g.alpha, w), dtype=np.uint8)
        out[planes] = u_f[planes]             # diagonal: stored uncoupled
        for x in range(g.q):
            if x == x0:
                continue
            zs = fib[x]                       # non-repair fiber layers:
            i = y0 * g.q + x                  # C = (1+g^2) U + g C_pair
            pair_c = c[i, planes] if i < self.n else np.uint8(0)
            out[zs] = g.mul_1g2[u_f[zs]] ^ g.mul_gamma[pair_c]
        return out

    # -- degraded interval reads -------------------------------------------
    def interval_plan(self, present: tuple, f: int, offset: int,
                      length: int, shard_size: int) -> IntervalPlan:
        """Cheapest correct fetch spec for a degraded read of
        [offset, offset+length) of lost shard f: the repair-plane path
        when every other shard is reachable (~2(n-1) layer slices vs
        plain RS's d), else a closure-restricted general decode over d
        survivors."""
        g = self.grid
        s = shard_size // self.alpha
        if shard_size % self.alpha or length <= 0:
            raise ValueError(f"bad msr interval (shard {shard_size}, "
                             f"alpha {self.alpha}, len {length})")
        lo, hi = offset // s, (offset + length - 1) // s
        inner = (offset - lo * s, offset + length - hi * s) if lo == hi \
            else (0, s)
        want = np.arange(lo, hi + 1)
        helpers = set(range(self.n)) - {f}
        if g.q >= 2 and helpers <= set(present):
            reps = np.unique(g.plane_of(f, want))
            fetch: dict[int, set] = {i: set(reps.tolist()) for i in helpers}
            x0, y0 = g.coords(f)
            for i in helpers | set(range(self.n, g.nbar)):
                if g.ys[i] == y0:
                    continue
                paired = ~g.unpaired[i, reps]
                for z in reps[paired]:
                    pnode = int(g.pair_node[i, z])
                    if pnode < self.n:
                        fetch[pnode].add(int(g.pair_layer[i, z]))
            return IntervalPlan("repair", f, offset, length, shard_size,
                                self.alpha, inner,
                                {i: sorted(v) for i, v in fetch.items()},
                                planes=reps)
        used = tuple(sorted(set(present) - {f}))[: self.d]
        if len(used) < self.d:
            raise ValueError(
                f"need {self.d} survivors for a degraded msr read, "
                f"have {len(used)}")
        closure, fetch_a = self.read_closure(used, want)
        return IntervalPlan("general", f, offset, length, shard_size,
                            self.alpha, inner,
                            {i: v.tolist() for i, v in fetch_a.items()},
                            used=used, closure=closure)

    def interval_decode(self, plan: IntervalPlan,
                        fetched: "dict[int, bytes]") -> bytes:
        """fetched[sid] = the plan's layer slices for that survivor,
        concatenated in plan.fetch[sid] order (each slice u1-u0 wide).
        Returns the lost shard's [offset, offset+length) bytes.

        The dense decode state is [nbar, alpha, window]: the inner span
        is processed in chunks that cap it near 8 MB (every relation is
        elementwise along the inner axis, so chunking is exact)."""
        g = self.grid
        u0, u1 = plan.inner
        w = u1 - u0
        s = plan.shard_size // self.alpha
        wmax = max(1, (8 << 20) // (g.nbar * g.alpha))
        end = plan.offset + plan.length
        lo, hi = plan.offset // s, (end - 1) // s
        res = np.empty(plan.length, dtype=np.uint8)
        for c0 in range(0, w, wmax):
            cw = min(wmax, w - c0)
            c = np.zeros((g.nbar, g.alpha, cw), dtype=np.uint8)
            for sid, layer_ids in plan.fetch.items():
                buf = np.frombuffer(fetched[sid], dtype=np.uint8)
                if len(buf) != len(layer_ids) * w:
                    raise ValueError(f"short fragment from shard {sid}")
                sl = buf.reshape(len(layer_ids), w)[:, c0:c0 + cw]
                c[sid, np.asarray(layer_ids, dtype=np.int64)] = sl
            if plan.mode == "repair":
                row = self.repair_decode(c, plan.f, planes=plan.planes)
            else:
                self.decode_coupled(c, plan.used, layers=plan.closure)
                row = c[plan.f]
            # copy each wanted layer's overlap with this inner chunk —
            # O(layers) slice arithmetic, no per-byte index arrays
            for z in range(lo, hi + 1):
                a = max(max(plan.offset, z * s) - z * s, u0 + c0)
                b = min(min(end, (z + 1) * s) - z * s, u0 + c0 + cw)
                if a < b:
                    res[z * s + a - plan.offset:
                        z * s + b - plan.offset] = \
                        row[z, a - (u0 + c0):b - (u0 + c0)]
        return res.tobytes()


register_coder("msr", ProductMatrixCoder)
