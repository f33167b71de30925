// K1: GF(2^8) matrix apply for Reed-Solomon encode and reconstruct on Hopper.
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/rs_pallas.py::_make_kernel
// (launched by _apply; entries encode_jit, encode_seeded_jit, reconstruct_jit,
// reconstruct_seeded_jit). Same contract: out[b, j, c] = XOR_i M[j, i] * (in[b, i, c] ^ seed)
// over GF(2^8) (polynomial 0x11D) for ANY [m, k] matrix M, input [B, k, C]
// uint8, output [B, m, C] uint8. Encode passes the parity matrix, reconstruct
// the wanted rows of the decode matrix; the seed byte lets a timing loop make
// every launch differ without an extra pass over memory.
//
// The first design looked each product up in split nibble tables in shared
// memory: two data-dependent byte loads per input byte and coefficient, 8 per
// input byte at RS(10,4), 2.68 G lane-loads at [32, 10, 1 MiB]. At about one
// warp-wide shared load per clock per SM that alone is ~0.36 ms; it measured
// 0.494 ms, 28% of the HBM bound (NVIDIA H100 80GB HBM3, 700.00 W).
//
// This design does no data-dependent load. Write a byte x = a | b<<3 | e<<6
// (a, b < 8, e < 4). Multiplication by c distributes over XOR, so
//     c*x = TA[a] ^ TB[b] ^ TC[e],  TA[a] = c*a, TB[b] = c*(b<<3), TC[e] = c*(e<<6).
// No table has more than 8 entries, so each fits in two registers and one
// prmt.b32 looks up four bytes at once with 3-bit selectors.
// Per input word the three fields are split off and compacted into selectors
// (nibble n = field of byte n) once for all outputs; each coefficient then
// costs 3 prmt and 2 lop3 per 4 bytes. A coefficient's tables are 32 B,
// words [A0 A1 B0 B1 C0 0 0 0] (tables[j][i], m*k*32 bytes). A block copies
// them to shared memory once; each (row, output) step reads its coefficient
// with two warp-uniform loads, which broadcast.
//
// Each thread owns 32 consecutive bytes (two uint4) of one stripe column span
// and keeps up to kMG outputs in registers; more outputs take further passes
// over the input. Input rows are read through a ring of kRing spans, so the
// loads of the next rows are in flight while a row is computed; loads and
// stores stream (evict-first), since each byte is read or written once.
// Widths not a multiple of 16, unaligned rows and the last <32 bytes of a row
// take a byte-wise path over the same tables.
//
// Bound on an H100 SXM (3.35 TB/s HBM): encode of [32, 10, 1 MiB] reads
// 335,544,320 B and writes 134,217,728 B, 0.1402 ms at the memory rate. The
// count above is ~8.75 integer ops per input byte at RS(10,4), 0.176 ms at
// 64 integer ops per clock per SM and 1980 MHz. Measured by chip_smoke.py
// on an NVIDIA H100 80GB HBM3, 700.00 W: encode and reconstruct 0.199 ms,
// 70% of the HBM bound (the first design 0.496 ms in the same run); RS(14,2)
// [32, 14, 1 MiB] 0.201 ms, 80% of its 0.1603 ms bound. At 4 outputs the
// integer issue limits it (time falls with the outputs: 0.151 ms at 2,
// 0.132 ms at 1), at 1-2 outputs the memory (a device copy reaches ~2.99
// TB/s there). ptxas: 114 registers, no spills.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (seaweedfs_tpu_torch/ops/_build.py, ops/rs_cuda.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMG = 4;                        // outputs per register pass
constexpr int kSpan = 32;                     // bytes of a row per thread
constexpr int kWords = kSpan / 4;
constexpr int kRing = 3;                      // input rows held per thread
constexpr int kMaxTableBytes = 48 * 1024;     // static shared-memory limit

struct Span {
  uint4 lo, hi;
};

__device__ __forceinline__ void load_span(Span& s, const uint8_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  s.lo = __ldcs(q);
  s.hi = __ldcs(q + 1);
}

// prmt.b32 in its default mode: byte n of the result is byte (sel >> 4n) & 7
// of hi:lo, or that byte's sign replicated where bit 4n+3 of sel is set.
// K1's selectors never set that bit. __byte_perm would mask every selector
// to 3 bits before each lookup, one integer op more per prmt.
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// prmt selector whose nibble n is byte n of f (every byte of f below 8).
__device__ __forceinline__ uint32_t selector(uint32_t f) {
  return prmt(f | (f >> 4), 0, 0x0020);
}

// Row i of the span held in s: split its words into selectors, refill s with
// row i + kRing, then fold the row into the outputs j0 .. j0+kMG-1.
__device__ __forceinline__ void row_step(uint32_t (&acc)[kMG][kWords], Span& s,
                                         const uint8_t* src, long long C, int i,
                                         int k, int m, int j0, uint32_t seed4,
                                         const uint4* tab4) {
  const uint32_t w[kWords] = {s.lo.x, s.lo.y, s.lo.z, s.lo.w,
                              s.hi.x, s.hi.y, s.hi.z, s.hi.w};
  uint32_t sa[kWords], sb[kWords], sc[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const uint32_t x = w[q] ^ seed4;
    sa[q] = selector(x & 0x07070707u);
    sb[q] = selector((x >> 3) & 0x07070707u);
    sc[q] = selector((x >> 6) & 0x03030303u);
  }
  if (i + kRing < k) load_span(s, src + (i + kRing) * C);
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(tab4);
#pragma unroll
  for (int jj = 0; jj < kMG; ++jj) {
    if (j0 + jj < m) {
      const int co = (j0 + jj) * k + i;
      const uint4 ab = tab4[2 * co];
      const uint32_t tc = tab[8 * co + 4];
#pragma unroll
      for (int q = 0; q < kWords; ++q)
        acc[jj][q] ^= prmt(ab.x, ab.y, sa[q]) ^ prmt(ab.z, ab.w, sb[q]) ^
                      prmt(tc, 0, sc[q]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
rs_gf_apply_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   const uint8_t* __restrict__ tables, int k, int m,
                   long long C, uint32_t seed, int vec) {
  extern __shared__ uint4 smem4[];
  const int nvec = m * k * 2;                 // 32 B per coefficient
  const uint4* tables4 = reinterpret_cast<const uint4*>(tables);
  for (int t = threadIdx.x; t < nvec; t += blockDim.x) smem4[t] = tables4[t];
  __syncthreads();

  const long long b = blockIdx.y;
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kSpan;
  if (c0 >= C) return;
  const uint8_t* src = in + b * k * C + c0;
  uint8_t* dst = out + b * m * C + c0;

  if (vec && c0 + kSpan <= C) {
    const uint32_t seed4 = seed * 0x01010101u;
    for (int j0 = 0; j0 < m; j0 += kMG) {
      uint32_t acc[kMG][kWords];
#pragma unroll
      for (int jj = 0; jj < kMG; ++jj)
#pragma unroll
        for (int q = 0; q < kWords; ++q) acc[jj][q] = 0;
      Span s0, s1{}, s2{};                    // the ring: rows i, i+1, i+2
      load_span(s0, src);
      if (k > 1) load_span(s1, src + C);
      if (k > 2) load_span(s2, src + 2 * C);
      for (int i = 0; i < k; i += kRing) {
        row_step(acc, s0, src, C, i, k, m, j0, seed4, smem4);
        if (i + 1 < k) row_step(acc, s1, src, C, i + 1, k, m, j0, seed4, smem4);
        if (i + 2 < k) row_step(acc, s2, src, C, i + 2, k, m, j0, seed4, smem4);
      }
#pragma unroll
      for (int jj = 0; jj < kMG; ++jj) {
        if (j0 + jj < m) {
          uint4* o = reinterpret_cast<uint4*>(dst + (j0 + jj) * C);
          __stcs(o, make_uint4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]));
          __stcs(o + 1, make_uint4(acc[jj][4], acc[jj][5], acc[jj][6], acc[jj][7]));
        }
      }
    }
    return;
  }

  // Ragged edge, or rows that are not 16-byte aligned: one byte at a time,
  // masked against C, over the same tables.
  const uint8_t* tab = reinterpret_cast<const uint8_t*>(smem4);
  const int n = static_cast<int>(C - c0 < kSpan ? C - c0 : kSpan);
  const uint8_t s8 = static_cast<uint8_t>(seed);
  for (int j = 0; j < m; ++j) {
    for (int e = 0; e < n; ++e) {
      uint8_t acc = 0;
      for (int i = 0; i < k; ++i) {
        const uint8_t x = src[i * C + e] ^ s8;
        const uint8_t* t = tab + (j * k + i) * 32;
        acc ^= t[x & 7] ^ t[8 + ((x >> 3) & 7)] ^ t[16 + (x >> 6)];
      }
      dst[j * C + e] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Largest table block (m*k*32 bytes) the kernel accepts.
int rs_gf_max_table_bytes() { return kMaxTableBytes; }

// in: [B, k, C] uint8, out: [B, m, C] uint8, tables: [m, k, 32] uint8, all
// device pointers, contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int rs_gf_apply(const void* in, void* out, const void* tables, int B, int k,
                int m, long long C, int seed, void* stream) {
  if (B <= 0 || m <= 0 || C <= 0) return 0;
  const int smem = m * k * 32;
  if (k <= 0 || smem > kMaxTableBytes || B > 65535) return cudaErrorInvalidValue;
  const long long cols = (C + kSpan - 1) / kSpan;
  const dim3 grid(static_cast<unsigned>((cols + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  const uintptr_t ip = reinterpret_cast<uintptr_t>(in);
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  const int vec = (C % 16 == 0) && (ip % 16 == 0) && (op % 16 == 0);
  rs_gf_apply_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(tables), k, m, C,
      static_cast<uint32_t>(seed) & 0xFFu, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
