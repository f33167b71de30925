// Native GF(2^8) Reed-Solomon + CRC32C kernels (CPU), the port's own copy
// of the JAX package's native/gf8.cpp.
//
// Role: the CPU baseline the card is measured against — the reference
// relies on klauspost/reedsolomon's AVX2 assembly (VPSHUFB split tables)
// and Go's SSE4.2 crc32, and this file provides the equivalent native CPU
// paths (ops/native.py::NativeCoder, native.crc32c).
//
// Technique: gf_mul(c, x) via two 16-entry nibble tables,
//   c*x = T_lo[c][x & 15] ^ T_hi[c][x >> 4],
// vectorized 32 bytes at a time with _mm256_shuffle_epi8 — the same split
// -table trick klauspost's galMulAVX2 assembly uses. The scalar loop keeps
// the library portable to hosts without AVX2.
//
// Build: ops/_build.build_host("gf8") at first use, with the host C++
// compiler and the SIMD flags the CPU lists in /proc/cpuinfo, into
// build/kernels/; loaded with ctypes.

#include <cstdint>
#include <cstring>

#if defined(__AVX2__)
#include <immintrin.h>
#endif
#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// GF(2^8) tables, poly 0x11D (same field as ops/gf8.py; built once).
// ---------------------------------------------------------------------------
static uint8_t GF_MUL[256][256];
static bool gf_ready = false;

static void gf_init() {
    if (gf_ready) return;
    uint8_t exp[512];
    int log[256] = {0};
    int x = 1;
    for (int i = 0; i < 255; i++) {
        exp[i] = (uint8_t)x;
        log[x] = i;
        x <<= 1;
        if (x & 0x100) x ^= 0x11D;
    }
    for (int i = 255; i < 510; i++) exp[i] = exp[i - 255];
    for (int a = 1; a < 256; a++)
        for (int b = 1; b < 256; b++)
            GF_MUL[a][b] = exp[log[a] + log[b]];
    gf_ready = true;
}

// Split nibble tables for one coefficient.
static void make_tables(uint8_t c, uint8_t lo[16], uint8_t hi[16]) {
    for (int v = 0; v < 16; v++) {
        lo[v] = GF_MUL[c][v];
        hi[v] = GF_MUL[c][v << 4];
    }
}

// out[m][L] ^= or = matrix[m][k] (x) in[k][L]   (GF(2^8) matrix apply)
// Rows are contiguous length-L byte arrays. This is the hot loop the
// reference runs per 256 KB batch (ec_encoder.go:183 enc.Encode).
void rs_apply(const uint8_t* in, uint8_t* out, const uint8_t* matrix,
              int k, int m, int64_t L) {
    gf_init();
    for (int j = 0; j < m; j++) {
        uint8_t* dst = out + (int64_t)j * L;
        std::memset(dst, 0, (size_t)L);
        for (int i = 0; i < k; i++) {
            uint8_t c = matrix[j * k + i];
            if (c == 0) continue;
            const uint8_t* src = in + (int64_t)i * L;
            uint8_t lo[16], hi[16];
            make_tables(c, lo, hi);
            int64_t off = 0;
#if defined(__AVX2__)
            __m256i vlo = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)lo));
            __m256i vhi = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)hi));
            __m256i mask = _mm256_set1_epi8(0x0F);
            for (; off + 32 <= L; off += 32) {
                __m256i v = _mm256_loadu_si256((const __m256i*)(src + off));
                __m256i l = _mm256_and_si256(v, mask);
                __m256i h = _mm256_and_si256(_mm256_srli_epi64(v, 4), mask);
                __m256i prod = _mm256_xor_si256(_mm256_shuffle_epi8(vlo, l),
                                                _mm256_shuffle_epi8(vhi, h));
                __m256i acc = _mm256_loadu_si256((const __m256i*)(dst + off));
                _mm256_storeu_si256((__m256i*)(dst + off),
                                    _mm256_xor_si256(acc, prod));
            }
#endif
            const uint8_t* mul = GF_MUL[c];
            for (; off < L; off++) dst[off] ^= mul[src[off]];
        }
    }
}

// Batched form: B independent stripes, data [B][k][L] -> out [B][m][L].
void rs_apply_batch(const uint8_t* in, uint8_t* out, const uint8_t* matrix,
                    int k, int m, int64_t L, int64_t B) {
    for (int64_t b = 0; b < B; b++)
        rs_apply(in + b * k * L, out + b * m * L, matrix, k, m, L);
}

// ---------------------------------------------------------------------------
// CRC32C: raw-state update (no init/final xor — the Python wrapper handles
// convention), SSE4.2 hardware instruction when available.
// ---------------------------------------------------------------------------
static uint32_t CRC_TBL[256];
static bool crc_ready = false;

static void crc_init() {
    if (crc_ready) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int j = 0; j < 8; j++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
        CRC_TBL[i] = c;
    }
    crc_ready = true;
}

uint32_t crc32c_update(uint32_t state, const uint8_t* buf, int64_t n) {
    int64_t off = 0;
#if defined(__SSE4_2__)
    uint64_t s = state;
    for (; off + 8 <= n; off += 8) {
        uint64_t v;
        std::memcpy(&v, buf + off, 8);
        s = _mm_crc32_u64(s, v);
    }
    state = (uint32_t)s;
    for (; off < n; off++) state = _mm_crc32_u8(state, buf[off]);
    return state;
#else
    crc_init();
    uint32_t s32 = state;
    for (; off < n; off++) s32 = (s32 >> 8) ^ CRC_TBL[(s32 ^ buf[off]) & 0xFF];
    return s32;
#endif
}

// Batched CRC over B equal-length rows -> states[B] (scrub fallback path).
void crc32c_batch(const uint8_t* rows, int64_t L, int64_t B,
                  uint32_t init, uint32_t* states) {
    for (int64_t b = 0; b < B; b++)
        states[b] = crc32c_update(init, rows + b * L, L);
}

int native_features() {
    int f = 0;
#if defined(__AVX2__)
    f |= 1;
#endif
#if defined(__SSE4_2__)
    f |= 2;
#endif
    return f;
}

}  // extern "C"
