"""A numpy model of kernel K3's arithmetic (seaweedfs_tpu_torch/csrc/crc32c.cu)
held against the host CRC32C and the JAX package's device_crc_states. K3
itself runs only on the card; this checks, on the CPU, the steps it runs
over the tables ops/crc_cuda.py builds:

- lane CRC: the raw zero-init state of 16 bytes, XOR_k S_{15-k}[b_k];
- a 32x32 GF(2) map as four byte-table lookups (A^n v);
- the chunk step acc = A^512 acc ^ lane_crc, per lane, across chunks;
- the 5-level shuffle tree with A^(16 * 2^j) on the left partner;
- the row split: S segments folded by Horner's rule with A^(512 q).
"""

import jax
import numpy as np
import pytest

from seaweedfs_tpu.ops import crc32c as ref
from seaweedfs_tpu_torch.ops import crc32c, crc_cuda

U32 = np.uint32


def raw_crc(data: bytes, state: int = 0) -> int:
    """Raw CRC32C state (no init, no final xor), the per-byte loop."""
    t = crc32c._table()
    for b in data:
        state = (state >> 8) ^ int(t[(state ^ b) & 0xFF])
    return state


def shift(tables, v):
    """K3's shift(): A^n v as four lookups in the byte tables of A^n."""
    v = np.asarray(v, dtype=U32)
    return (tables[0][v & U32(0xFF)] ^ tables[1][(v >> U32(8)) & U32(0xFF)]
            ^ tables[2][(v >> U32(16)) & U32(0xFF)] ^ tables[3][v >> U32(24)])


def lane_crc(pieces):
    """K3's lane_crc(): pieces [..., 16] uint8 -> raw states [...]."""
    sl = crc_cuda.slice_tables()
    out = np.zeros(pieces.shape[:-1], dtype=U32)
    for k in range(16):
        out ^= sl[15 - k][pieces[..., k]]
    return out


def tree(acc):
    """K3's shuffle tree over the lane axis (last, 32 lanes)."""
    lanes = np.arange(32)
    for j, n in enumerate(crc_cuda.TREE_SHIFTS):
        other = acc[..., lanes ^ (1 << j)]
        right = ((lanes >> j) & 1).astype(bool)
        left = np.where(right, other, acc)
        rgt = np.where(right, acc, other)
        acc = shift(crc_cuda.shift_tables(n), left) ^ rgt
    return acc


def k3_model(blocks):
    """The whole kernel (both of its launches) on [B, L] uint8."""
    b, length = blocks.shape
    if length == 0:
        return np.zeros(b, dtype=U32)
    chunks = length // crc_cuda.CHUNK
    s = crc_cuda.segments(b, chunks)
    q = chunks // s
    lc = lane_crc(blocks.reshape(b, s, q, 32, 16))       # [B, S, q, 32]
    acc = np.zeros((b, s, 32), dtype=U32)
    for c in range(q):
        acc = shift(crc_cuda.shift_tables(crc_cuda.CHUNK), acc) ^ lc[:, :, c]
    seg = tree(acc)
    assert np.all(seg == seg[..., :1]), "the tree leaves every lane the sum"
    seg = seg[..., 0]
    if s == 1:
        return seg[:, 0]
    row = np.zeros(b, dtype=U32)
    for k in range(s):
        row = shift(crc_cuda.shift_tables(crc_cuda.CHUNK * q), row) ^ seg[:, k]
    return row


def test_lane_crc_is_the_raw_crc_of_16_bytes():
    rng = np.random.default_rng(0)
    pieces = rng.integers(0, 256, (300, 16), dtype=np.uint8)
    pieces[0] = 0
    pieces[1] = 0xFF
    got = lane_crc(pieces)
    assert [int(v) for v in got] == [raw_crc(p.tobytes()) for p in pieces]


@pytest.mark.parametrize("n", [1, 4, 16, 32, 64, 128, 256, 512, 4096, 8192])
def test_shift_tables_are_n_zero_bytes(n):
    """A^n v through the four byte tables equals feeding n zero bytes to
    a raw CRC in state v, and the matrix power A^n."""
    rng = np.random.default_rng(n)
    vs = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(U32)
    got = shift(crc_cuda.shift_tables(n), vs)
    assert [int(v) for v in got] == [raw_crc(bytes(n), int(v)) for v in vs]
    np.testing.assert_array_equal(
        got, crc_cuda.apply_matrix(crc_cuda.pow_matrix(n), vs))


def test_pow_matrix_matches_reference_powers():
    a, _ = ref._a_d()
    cur = np.eye(32, dtype=np.uint8)
    for n in range(1, 20):
        cur = ref._m2mul(a, cur)
        np.testing.assert_array_equal(crc_cuda.pow_matrix(n), cur)
    s512, _ = ref.chunk_matrices(512)
    np.testing.assert_array_equal(crc_cuda.pow_matrix(512), s512)


def test_chunk_step_across_chunks():
    """Per-lane accumulation with A^512 then the tree equals the raw CRC
    of a whole multi-chunk row (one segment)."""
    rng = np.random.default_rng(1)
    row = rng.integers(0, 256, 4 * 512, dtype=np.uint8)
    lc = lane_crc(row.reshape(4, 32, 16))
    acc = np.zeros(32, dtype=U32)
    for c in range(4):
        acc = shift(crc_cuda.shift_tables(512), acc) ^ lc[c]
    assert int(tree(acc)[0]) == raw_crc(row.tobytes())


def test_tree_combines_a_chunk():
    """The 5-level tree over 32 lane states of one chunk is the chunk's
    raw CRC, in every lane."""
    rng = np.random.default_rng(2)
    chunk = rng.integers(0, 256, 512, dtype=np.uint8)
    out = tree(lane_crc(chunk.reshape(32, 16)))
    assert set(int(v) for v in out) == {raw_crc(chunk.tobytes())}


@pytest.mark.parametrize("rows,chunks,want", [
    (4096, 4, 1), (16384, 8, 1), (64, 2048, 128), (1, 2048, 512),
    (3, 128, 32), (3, 1, 1), (3, 2, 1), (3, 8, 2), (8192, 64, 1)])
def test_segments_rule(rows, chunks, want):
    s = crc_cuda.segments(rows, chunks)
    assert s == want
    assert chunks % s == 0 and (s == 1 or chunks // s >= 4)


def test_kernel_table_layout():
    """The flat image the kernel copies to shared memory: 16 slice tables,
    the five tree shifts, the chunk step — 10240 words, 40 KB."""
    tab = crc_cuda.kernel_tables()
    assert tab.dtype == U32 and tab.size == 10240
    np.testing.assert_array_equal(tab[:4096], crc_cuda.slice_tables().ravel())
    for i, n in enumerate(crc_cuda.TREE_SHIFTS):
        np.testing.assert_array_equal(tab[4096 + 1024 * i:5120 + 1024 * i],
                                      crc_cuda.shift_tables(n).ravel())
    np.testing.assert_array_equal(tab[-1024:], crc_cuda.shift_tables(512).ravel())
    np.testing.assert_array_equal(crc_cuda.slice_tables()[0], crc32c._table())


@pytest.mark.parametrize("rows,length", [(3, 512), (5, 2048), (2, 65536),
                                         (1, 1 << 17), (7, 4096)])
def test_k3_model_matches_host_crc_and_reference(rows, length):
    """Whole-kernel model on left-padded needles: finalized, the host CRC;
    raw, the JAX package's device_crc_states (split rows included)."""
    rng = np.random.default_rng(rows * length)
    lengths = rng.integers(0, length + 1, rows)
    lengths[0] = length
    blocks = np.zeros((rows, length), dtype=np.uint8)
    msgs = []
    for i, n in enumerate(lengths):
        m = rng.integers(0, 256, n, dtype=np.uint8)
        msgs.append(m)
        blocks[i, length - n:] = m
    raw = k3_model(blocks)
    vals = crc32c.finalize(raw, lengths)
    assert [int(v) for v in vals] == [crc32c.crc32c(m.tobytes()) for m in msgs]
    if length <= 4096:
        want = np.asarray(jax.jit(lambda b: ref.device_crc_states(b, 512))(blocks))
        np.testing.assert_array_equal(raw, want.astype(U32))


def test_k3_model_zero_length_rows():
    assert k3_model(np.zeros((4, 0), np.uint8)).tolist() == [0, 0, 0, 0]
