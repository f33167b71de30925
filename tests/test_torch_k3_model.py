"""A numpy model of kernel K3's arithmetic (seaweedfs_tpu_torch/csrc/crc32c.cu)
held against the host CRC32C and the JAX package's device_crc_states. K3
itself runs only on the card; this checks, on the CPU, the steps it runs
over the tables ops/crc_cuda.py builds, read from the shared-memory image
the kernel writes, at the kernel's own addresses:

- a linear map cut into w-bit fields: field i of the input indexes table i,
  entry e of lane l's copy at byte i * (128 << w) + (((v >> s) & mask) |
  l << 2), a funnel shift where the field spans two words;
- lane CRC: the raw state of 16 bytes, 26 lookups of 5-bit fields;
- the chunk step acc = A^512 acc ^ lane_crc, per lane, in 5-bit fields;
- the fold: lane l's own map A^(16 (31 - l)) in 4-bit fields, then the
  XOR butterfly;
- a 32x32 GF(2) map as four byte tables (the segment fold of the second
  launch), and the row split: S segments folded by Horner's rule with
  A^(512 q).
"""

import jax
import numpy as np
import pytest

from seaweedfs_tpu.ops import crc32c as ref
from seaweedfs_tpu_torch.ops import crc32c, crc_cuda

U32 = np.uint32
LANES = np.arange(32, dtype=U32)
WIDTHS = (crc_cuda.LANE_BITS, crc_cuda.STEP_BITS, crc_cuda.FOLD_BITS)
#: crc_cuda.target_tasks on an H100: 132 SMs x 32 warps, rounded down
H100_TASKS = 4096


def raw_crc(data: bytes, state: int = 0) -> int:
    """Raw CRC32C state (no init, no final xor), the per-byte loop."""
    t = crc32c._table()
    for b in data:
        state = (state >> 8) ^ int(t[(state ^ b) & 0xFF])
    return state


def entries(bits, w):
    """Entries of all the tables of a `bits`-bit input in w-bit fields."""
    return (bits // w) * (1 << w) + ((1 << bits % w) if bits % w else 0)


class Image:
    """Shared memory as the kernel writes it from the compact image: the
    lane and step tables 32-fold (word i holds compact[i >> 5]), then the
    fold tables (one value per lane already) as they are; with the byte
    offsets of the three regions."""

    def __init__(self):
        self.lane_bits, self.step_bits, self.fold_bits = WIDTHS
        tab = crc_cuda.kernel_tables()
        shared = entries(128, self.lane_bits) + entries(32, self.step_bits)
        self.words = np.concatenate([np.repeat(tab[:shared], 32), tab[shared:]])
        self.step_base = entries(128, self.lane_bits) * 128
        self.fold_base = shared * 128

    def address(self, base, width, bits, i, words, lanes=LANES):
        """Byte address of the lookup of field i (of a `bits`-bit input in
        `width`-bit fields, held in words[..., k]) of the tables at `base`,
        lane by lane (the lane axis is the one before the words)."""
        p = width * i
        w = min(width, bits - p)
        word, bit = divmod(p, 32)
        v = words[..., word]
        if bit + w > 32:  # the kernel's funnel shift
            v = ((v.astype(np.uint64) | (words[..., word + 1].astype(np.uint64) << np.uint64(32)))
                 >> np.uint64(bit - 7)).astype(U32)
        elif bit >= 7:
            v = v >> U32(bit - 7)
        else:
            v = v << U32(7 - bit)
        mask = U32(((1 << w) - 1) << 7)
        return U32(base + i * (128 << width)) + ((v & mask) | (lanes << U32(2)))

    def lookup(self, base, width, bits, words):
        out = np.zeros(words.shape[:-1], dtype=U32)
        for i in range(-(-bits // width)):
            out ^= self.words[self.address(base, width, bits, i, words) >> U32(2)]
        return out

    def lane_crc(self, pieces):
        """K3's lane_crc(): pieces [..., 32 lanes, 16] uint8 -> raw states."""
        words = np.ascontiguousarray(pieces).view("<u4").astype(U32)
        return self.lookup(0, self.lane_bits, 128, words)

    def step(self, acc):
        return self.lookup(self.step_base, self.step_bits, 32, acc[..., None])

    def fold(self, acc):
        """Lane l's map A^(16 (31 - l)), then the butterfly over the lanes."""
        acc = self.lookup(self.fold_base, self.fold_bits, 32, acc[..., None])
        for j in (1, 2, 4, 8, 16):
            acc = acc ^ acc[..., LANES ^ U32(j)]
        return acc


def shift(tables, v):
    """crc_combine_kernel's shift(): A^n v as four byte-table lookups."""
    v = np.asarray(v, dtype=U32)
    return (tables[0][v & U32(0xFF)] ^ tables[1][(v >> U32(8)) & U32(0xFF)]
            ^ tables[2][(v >> U32(16)) & U32(0xFF)] ^ tables[3][v >> U32(24)])


def k3_model(blocks):
    """The whole kernel (both of its launches) on [B, L] uint8, split as on
    an H100."""
    b, length = blocks.shape
    if length == 0:
        return np.zeros(b, dtype=U32)
    img = Image()
    chunks = length // crc_cuda.CHUNK
    s = crc_cuda.segments(b, chunks, H100_TASKS)
    q = chunks // s
    lc = img.lane_crc(blocks.reshape(b, s, q, 32, 16))   # [B, S, q, 32]
    acc = lc[:, :, 0]
    for c in range(1, q):
        acc = img.step(acc) ^ lc[:, :, c]
    seg = img.fold(acc)
    assert np.all(seg == seg[..., :1]), "the butterfly leaves every lane the sum"
    seg = seg[..., 0]
    if s == 1:
        return seg[:, 0]
    row = np.zeros(b, dtype=U32)
    for k in range(s):
        row = shift(crc_cuda.shift_tables(crc_cuda.CHUNK * q), row) ^ seg[:, k]
    return row


def test_lane_crc_is_the_raw_crc_of_16_bytes():
    rng = np.random.default_rng(0)
    pieces = rng.integers(0, 256, (10, 32, 16), dtype=np.uint8)
    pieces[0, 0] = 0
    pieces[0, 1] = 0xFF
    got = Image().lane_crc(pieces)
    assert [int(v) for v in got.ravel()] == [
        raw_crc(p.tobytes()) for p in pieces.reshape(-1, 16)]


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


@pytest.mark.parametrize("n", [1, 4, 16, 32, 64, 128, 256, 512, 4096, 8192])
def test_field_tables_are_n_zero_bytes(n):
    """A^n v through the tables of its 4-, 5- and 6-bit fields equals
    feeding n zero bytes to a raw CRC in state v (the form of the chunk
    step and the fold)."""
    rng = np.random.default_rng(n + 1)
    vs = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(U32)
    want = [raw_crc(bytes(n), int(v)) for v in vs]
    for width in (4, 5, 6):
        tabs = crc_cuda.field_tables(crc_cuda.bit_images(crc_cuda.pow_matrix(n)), width)
        got = np.zeros_like(vs)
        for i, lo in enumerate(range(0, 32, width)):
            w = min(width, 32 - lo)
            got ^= tabs[i * (1 << width) + ((vs >> U32(lo)) & U32((1 << w) - 1))]
        assert [int(v) for v in got] == want, width


def test_chunk_step_across_chunks():
    """Per-lane accumulation with A^512 in 5-bit fields, then the fold,
    equals the raw CRC of a whole multi-chunk row (one segment)."""
    img = Image()
    rng = np.random.default_rng(1)
    row = rng.integers(0, 256, 4 * 512, dtype=np.uint8)
    lc = img.lane_crc(row.reshape(4, 32, 16))
    acc = lc[0]
    for c in range(1, 4):
        acc = img.step(acc) ^ lc[c]
    assert set(int(v) for v in img.fold(acc)) == {raw_crc(row.tobytes())}


def test_fold_combines_a_chunk():
    """The lane maps and the butterfly over 32 lane states of one chunk
    give the chunk's raw CRC, in every lane."""
    img = Image()
    rng = np.random.default_rng(2)
    chunk = rng.integers(0, 256, 512, dtype=np.uint8)
    out = img.fold(img.lane_crc(chunk.reshape(32, 16)))
    assert set(int(v) for v in out) == {raw_crc(chunk.tobytes())}


def test_fold_tables_are_each_lanes_map():
    """Lane l's fold tables, read at its own addresses, apply
    A^(16 (31 - l)): its state followed by the 16 (31 - l) bytes of the
    lanes after it, as zeros."""
    img = Image()
    rng = np.random.default_rng(6)
    vs = rng.integers(0, 1 << 32, (4, 32), dtype=np.uint64).astype(U32)
    got = img.lookup(img.fold_base, img.fold_bits, 32, vs[..., None])
    for lane in range(32):
        assert [int(v) for v in got[:, lane]] == [
            raw_crc(bytes(16 * (31 - lane)), int(v)) for v in vs[:, lane]]


def test_shared_image_lookups_are_conflict_free():
    """In the image the kernel writes, every warp-wide lookup (each lane
    its own data) touches 32 distinct banks, and finds the compact table's
    entry: lane tables (fields that span two words included), step tables
    and the lane-specific fold tables."""
    img = Image()
    assert img.words.nbytes == (808 + 196 + 128) * 128      # 141.5 KB
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, (64, 32, 4), dtype=np.uint64).astype(U32)
    words[0] = 0
    words[1] = 0xFFFFFFFF
    lane_tab = crc_cuda.field_tables(crc_cuda.lane_bit_images(), img.lane_bits)
    step_tab = crc_cuda.field_tables(crc_cuda.bit_images(crc_cuda.pow_matrix(512)),
                                     img.step_bits)
    fold_tab = crc_cuda.fold_tables()
    for base, width, bits, tab in ((0, img.lane_bits, 128, lane_tab),
                                   (img.step_base, img.step_bits, 32, step_tab),
                                   (img.fold_base, img.fold_bits, 32, fold_tab)):
        v = words if bits == 128 else words[..., :1]
        for i in range(-(-bits // width)):
            addr = img.address(base, width, bits, i, v)       # [64 warps, 32 lanes]
            banks = (addr >> U32(2)) % U32(32)
            assert all(len(set(row.tolist())) == 32 for row in banks)
            big = np.concatenate([v, np.zeros_like(v[..., :1])], axis=-1)
            value = sum(big[..., k].astype(object) << (32 * k) for k in range(v.shape[-1]))
            p, w = width * i, min(width, bits - width * i)
            e = np.vectorize(lambda x: (x >> p) & ((1 << w) - 1), otypes=[np.int64])(value)
            idx = i * (1 << width) + e
            want = tab[idx, LANES[None, :]] if base == img.fold_base else tab[idx]
            np.testing.assert_array_equal(img.words[addr >> U32(2)], want)


@pytest.mark.parametrize("rows,chunks,want", [
    (4096, 4, 1), (16384, 8, 1), (64, 2048, 64), (1, 2048, 512),
    (3, 128, 32), (3, 1, 1), (3, 2, 1), (3, 8, 2), (8192, 64, 1)])
def test_segments_rule(rows, chunks, want):
    s = crc_cuda.segments(rows, chunks, H100_TASKS)
    assert s == want
    assert chunks % s == 0 and (s == 1 or chunks // s >= 4)


def test_kernel_table_layout():
    """The compact image the kernel reads: 26 lane tables of 5-bit fields
    (the last 3 bits wide), 7 chunk-step tables of 5-bit fields (the last
    2 bits), the fold tables [entry, lane] of 4-bit fields — 5100 words."""
    tab = crc_cuda.kernel_tables()
    assert WIDTHS == (5, 5, 4)
    assert tab.dtype == U32 and tab.size == 808 + 196 + 128 * 32 == 5100
    np.testing.assert_array_equal(
        tab[:808], crc_cuda.field_tables(crc_cuda.lane_bit_images(), 5))
    np.testing.assert_array_equal(
        tab[808:1004], crc_cuda.field_tables(crc_cuda.bit_images(crc_cuda.pow_matrix(512)), 5))
    np.testing.assert_array_equal(tab[1004:], crc_cuda.fold_tables().ravel())
    # the last byte: bits 120..124 (field 24) and 125..127 (field 25) are
    # the byte table itself
    t = crc32c._table()
    np.testing.assert_array_equal(tab[24 * 32:25 * 32], t[:32])
    np.testing.assert_array_equal(tab[25 * 32:808], t[np.arange(8) << 5])
    # lane 31 is last in the chunk: its fold is the identity
    np.testing.assert_array_equal(
        crc_cuda.fold_tables()[:, 31],
        (np.arange(16, dtype=U32)[None, :] << (U32(4) * np.arange(8, dtype=U32)[:, None])).ravel())


@pytest.mark.parametrize("rows,length", [(3, 512), (5, 2048), (2, 65536),
                                         (1, 1 << 17), (7, 4096), (4225, 512),
                                         (1, 1 << 20), (64, 8192), (9, 1536)])
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


def test_kernel_source_constants_match_the_wrapper():
    """csrc/crc32c.cu defines the chunk, the field widths and the warps per
    SM that this model and ops/crc_cuda.py build tables and split rows
    for."""
    import re
    from pathlib import Path
    src = (Path(crc_cuda.__file__).parent.parent / "csrc" / "crc32c.cu").read_text()
    got = {m[0]: m[1] for m in re.findall(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert (int(got["kChunk"]), int(got["kLaneBits"]), int(got["kStepBits"]),
            int(got["kFoldBits"])) == (crc_cuda.CHUNK, *WIDTHS)
    assert (got["kThreads"].split()[0], got["kWarps"]) == ("1024", "kThreads / 32")
    assert crc_cuda.WARPS_PER_SM == 1024 // 32


def test_k3_model_zero_length_rows():
    assert k3_model(np.zeros((4, 0), np.uint8)).tolist() == [0, 0, 0, 0]
