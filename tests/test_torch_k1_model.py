"""A numpy model of kernel K1's arithmetic (seaweedfs_tpu_torch/csrc/rs_gf.cu)
held against the JAX package's GF(2^8) field and its Pallas kernel (in
interpret mode). K1 itself runs only on the card; this checks, on the CPU,
the word arithmetic it runs and the tables ops/rs_cuda.field_tables builds.

K1 writes a byte x as a | b << 3 | e << 6 (a, b < 8, e < 4) and takes a
product c*x as TA[a] ^ TB[b] ^ TC[e]. Each table has at most 8 entries and
sits in two registers; one PTX prmt.b32 looks up four bytes at once, its
3-bit selectors being the fields of a word compacted into nibbles.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu.ops import rs_pallas
from seaweedfs_tpu_torch.ops import gf8, rs_cuda, rs_torch

GEOMETRIES = [(10, 4), (14, 2), (4, 2), (5, 3)]
U32 = np.uint32


def prmt(x, y, s):
    """prmt.b32 (x, y, s): byte n of the result is byte (s >> 4n) & 7 of
    the eight bytes y:x, x the low word. K1 never sets a selector's bit 3
    (the sign-replicate mode), and the model refuses it."""
    x, y, s = (np.asarray(v, dtype=np.uint64) for v in (x, y, s))
    assert not np.any(s & 0x8888), "selector with bit 3 set"
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, s).shape, dtype=np.uint64)
    for n in range(4):
        idx = (s >> np.uint64(4 * n)) & np.uint64(7)
        out |= ((both >> (np.uint64(8) * idx)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(U32)


def selector(f):
    """K1's selector(): nibble n of the result is byte n of f (bytes < 8)."""
    f = np.asarray(f, dtype=U32)
    assert not np.any(f & ~U32(0x07070707))
    return prmt(f | (f >> U32(4)), 0, 0x0020) & U32(0xFFFF)


def gf_mul_word(w, tab, seed=0):
    """K1's per-word step: words w (any shape) ^ seed times the coefficient
    whose 32 table bytes are tab, four bytes at once."""
    t = np.ascontiguousarray(tab, dtype=np.uint8).view("<u4")
    x = np.asarray(w, dtype=U32) ^ U32(seed * 0x01010101)
    sa = selector(x & U32(0x07070707))
    sb = selector((x >> U32(3)) & U32(0x07070707))
    sc = selector((x >> U32(6)) & U32(0x03030303))
    return (prmt(t[0], t[1], sa) ^ prmt(t[2], t[3], sb)
            ^ prmt(t[4], 0, sc))


def k1_model(mat, data, seed=0):
    """K1 on [B, k, C] uint8 as it runs for 16-byte aligned rows: whole
    32-byte spans through the word step, the rest of each row byte by byte
    (the ragged path, which reads the same tables)."""
    tab = rs_cuda.field_tables(mat)
    m, k = tab.shape[:2]
    B, _, C = data.shape
    out = np.zeros((B, m, C), dtype=np.uint8)
    full = C // 32 * 32 if C % 16 == 0 else 0
    if full:
        words = np.ascontiguousarray(data[:, :, :full]).view("<u4")
        acc = np.zeros((B, m, full // 4), dtype=U32)
        for j in range(m):
            for i in range(k):
                acc[:, j] ^= gf_mul_word(words[:, i], tab[j, i], seed)
        out[:, :, :full] = acc.view(np.uint8)
    x = data[:, :, full:] ^ np.uint8(seed)
    for j in range(m):
        for i in range(k):
            t, xi = tab[j, i], x[:, i].astype(np.intp)
            out[:, j, full:] ^= t[xi & 7] ^ t[8 + ((xi >> 3) & 7)] ^ t[16 + (xi >> 6)]
    return out


def test_prmt_and_selector_model():
    lo, hi = 0x33221100, 0x77665544
    assert prmt(lo, hi, 0x3210) == lo
    assert prmt(lo, hi, 0x7654) == hi
    assert prmt(lo, hi, 0x0123) == 0x00112233
    assert prmt(lo, hi, 0x4071) == 0x44007711
    assert selector(0x07050301) == 0x7531
    assert selector(0x00060002) == 0x0602


@pytest.mark.parametrize("seed", [0, 0x5A, 0xFF])
def test_word_step_is_field_product(seed):
    """Every coefficient times every byte value, in every byte lane."""
    v = np.arange(256, dtype=U32)
    lanes = np.stack([v, v ^ 0x55, (v + 85) & 0xFF, 0xFF - v])  # each a bijection
    words = lanes[0] | lanes[1] << 8 | lanes[2] << 16 | lanes[3] << 24
    coef = np.arange(256, dtype=np.uint8)
    tabs = rs_cuda.field_tables(coef[:, None])[:, 0]               # [256, 32]
    t = tabs.view("<u4")                                          # [256, 8]
    x = words[None, :] ^ U32(seed * 0x01010101)
    sa = selector(x & U32(0x07070707))
    sb = selector((x >> U32(3)) & U32(0x07070707))
    sc = selector((x >> U32(6)) & U32(0x03030303))
    got = (prmt(t[:, :1], t[:, 1:2], sa) ^ prmt(t[:, 2:3], t[:, 3:4], sb)
           ^ prmt(t[:, 4:5], 0, sc))                         # [256 c, 256 v]
    for lane in range(4):
        want = ref_gf8.GF_MUL[coef[:, None], (lanes[lane] ^ seed)[None, :]]
        np.testing.assert_array_equal((got >> U32(8 * lane)) & U32(0xFF), want,
                                      err_msg=f"lane {lane}")
    # the per-coefficient helper agrees with the vectorised step
    np.testing.assert_array_equal(gf_mul_word(words, tabs[0x8E], seed), got[0x8E])


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_field_tables_are_field_products(d, p):
    """All 32 slots of every coefficient, for encode and decode matrices."""
    rng = np.random.default_rng(d * 100 + p)
    lost = sorted(rng.choice(d + p, size=p, replace=False).tolist())
    present = [i for i in range(d + p) if i not in lost]
    part = np.arange(8)
    for mat in (gf8.parity_matrix(d, p), rs_torch.decode_rows(d, p, present, lost)):
        tab = rs_cuda.field_tables(mat)
        assert tab.shape == mat.shape + (32,) and tab.dtype == np.uint8
        c = mat[:, :, None]
        np.testing.assert_array_equal(tab[:, :, 0:8], ref_gf8.GF_MUL[c, part])
        np.testing.assert_array_equal(tab[:, :, 8:16], ref_gf8.GF_MUL[c, part << 3])
        np.testing.assert_array_equal(tab[:, :, 16:20],
                                      ref_gf8.GF_MUL[c, part[:4] << 6])
        assert not tab[:, :, 20:].any()
        x = np.arange(256)
        got = tab[:, :, x & 7] ^ tab[:, :, 8 + ((x >> 3) & 7)] ^ tab[:, :, 16 + (x >> 6)]
        np.testing.assert_array_equal(got, ref_gf8.GF_MUL[c, x[None, None, :]])


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_k1_model_matches_pallas(d, p):
    """The whole kernel's arithmetic at the widths that hit a 32-byte span's
    edges, against the Pallas kernel (interpret mode) and the numpy oracle."""
    rng = np.random.default_rng(d * 10 + p)
    seed = int(rng.integers(1, 256))
    lost = tuple(sorted(rng.choice(d + p, size=p, replace=False).tolist()))
    present = tuple(i for i in range(d + p) if i not in lost)
    rec = rs_torch.decode_rows(d, p, present, lost)
    for C in (16, 48, 100, 4112):
        data = rng.integers(0, 256, (2, d, C), dtype=np.uint8)
        enc = k1_model(gf8.parity_matrix(d, p), data)
        np.testing.assert_array_equal(
            enc, np.asarray(rs_pallas.encode_jit(data, d, p, interpret=True)))
        np.testing.assert_array_equal(
            k1_model(gf8.parity_matrix(d, p), data, seed),
            np.asarray(rs_pallas.encode_seeded_jit(
                data, jnp.full((1,), seed, jnp.int32), d, p, interpret=True)))
        np.testing.assert_array_equal(
            k1_model(rec, data, seed),
            np.stack([ref_gf8.np_gf_apply(rec, s ^ np.uint8(seed)) for s in data]))
        shards = np.concatenate([data, enc], axis=1)
        surv = shards[:, sorted(present)[:d]]
        np.testing.assert_array_equal(k1_model(rec, surv), shards[:, list(lost)])
