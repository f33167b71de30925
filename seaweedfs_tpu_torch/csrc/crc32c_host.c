/* Host CRC32-Castagnoli (reflected polynomial 0x82F63B78) for the needle
 * read/write path and the scrub's host loop.
 *
 * The port's own copy of the fast host CRC the JAX package keeps in its C++
 * sidecar (seaweedfs_tpu/native/gf8.cpp, crc32c_update). Built by the host
 * C compiler at first use (seaweedfs_tpu_torch/ops/_build.py, build_host),
 * loaded with ctypes (ops/crc32c.py), which calls crc32c_init() once.
 * With -msse4.2 (ops/_build.py adds it when /proc/cpuinfo lists sse4_2) the
 * loop is the CPU's crc32 instruction, 8 bytes at a time; otherwise a
 * slicing-by-8 table loop.
 *
 * State convention: raw, as the tables run it. crc32c(data) is
 * crc32c_update(0xFFFFFFFF, data, n) ^ 0xFFFFFFFF, and a running value v
 * chains as crc32c_update(v ^ 0xFFFFFFFF, ...) ^ 0xFFFFFFFF.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__SSE4_2__)
#include <nmmintrin.h>

int crc32c_hw(void) { return 1; }

void crc32c_init(void) {}

uint32_t crc32c_update(uint32_t state, const uint8_t* buf, size_t n) {
  size_t off = 0;
  uint64_t s = state;
  for (; off + 8 <= n; off += 8) {
    uint64_t v;
    memcpy(&v, buf + off, 8);
    s = _mm_crc32_u64(s, v);
  }
  state = (uint32_t)s;
  for (; off < n; off++) state = _mm_crc32_u8(state, buf[off]);
  return state;
}

#else

static uint32_t tbl[8][256];

/* Fills the tables; the loader calls it once, before any update. */
void crc32c_init(void) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int j = 0; j < 8; j++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
    tbl[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int k = 1; k < 8; k++)
      tbl[k][i] = (tbl[k - 1][i] >> 8) ^ tbl[0][tbl[k - 1][i] & 0xFF];
}

int crc32c_hw(void) { return 0; }

uint32_t crc32c_update(uint32_t state, const uint8_t* buf, size_t n) {
  size_t off = 0;
  for (; off + 8 <= n; off += 8) {
    uint32_t lo, hi;
    memcpy(&lo, buf + off, 4);
    memcpy(&hi, buf + off + 4, 4);
    lo ^= state; /* little-endian hosts: byte 0 in the low bits */
    state = tbl[7][lo & 0xFF] ^ tbl[6][(lo >> 8) & 0xFF] ^
            tbl[5][(lo >> 16) & 0xFF] ^ tbl[4][lo >> 24] ^
            tbl[3][hi & 0xFF] ^ tbl[2][(hi >> 8) & 0xFF] ^
            tbl[1][(hi >> 16) & 0xFF] ^ tbl[0][hi >> 24];
  }
  for (; off < n; off++) state = (state >> 8) ^ tbl[0][(state ^ buf[off]) & 0xFF];
  return state;
}

#endif
