// K3: batched raw CRC32C states on Hopper.
//
// Replaces the JAX package's device function
// seaweedfs_tpu/ops/crc32c.py::device_crc_states (an XLA lax.scan of two
// GF(2) bit-matmuls per 512-byte chunk), the compute of the needle-CRC scrub
// (storage/scrub.py). Same contract: in [B, L] uint8, rows LEFT-padded with
// zeros, L % 512 == 0 -> out[b] = raw CRC32C state of row b (init 0, no final
// xor, Castagnoli reflected polynomial 0x82F63B78), written as a uint64 of
// the 32-bit value. The host's crc32c.finalize adds the 0xFFFFFFFF init back
// per needle length; leading zeros leave a zero-init state unchanged.
//
// Algebra. For zero-init raw states, state(XY) = A^|Y| state(X) ^ state(Y),
// where A^n is the 32x32 GF(2) map of n zero bytes. A 32x32 map M applies to
// a state v as four lookups, M v = T0[v0] ^ T1[v1] ^ T2[v2] ^ T3[v3] over the
// bytes of v, with Tm[x] = M (x << 8m) ("shift tables", 4 KB each).
//
// Design (simple first; bound and measured times in PERF.md):
// - A warp walks one segment of a row, 512 bytes (one chunk) per step. Lane
//   i loads bytes [16i, 16i+16) of the chunk as one uint4, so the warp's
//   load is one coalesced 512-byte read; the next chunk's load is issued
//   before the current one is folded.
// - Lane CRC: the raw state of 16 bytes b0..b15 is XOR_k S_{15-k}[b_k], with
//   S_j[x] = A^j T[x] (slicing by 16; 16 KB of tables, 16 independent
//   lookups, no carried dependence).
// - Across chunks each lane keeps its own running state,
//   acc = A^512 acc ^ lane_crc, so no shuffle runs per chunk. Lane i's acc
//   then covers its 16-byte pieces of every chunk, each followed by the
//   512-byte stride; the segment's state is XOR_i A^(16(31-i)) acc_i.
// - That sum is a 5-level __shfl_xor_sync tree: at level j the left
//   partner (lower lanes, earlier bytes) is shifted by A^(16 * 2^j) and
//   xored into the right. Same value as combining per chunk, since every
//   map is linear: tree(A^512 acc ^ c) = A^512 tree(acc) ^ tree(c).
// - Rows split into S segments of q chunks when the batch is too short to
//   fill the card (long rows: [64, 1 MiB] runs 2048 chunks per row). Each
//   warp then stores its segment state, and a second kernel folds a row's S
//   states by Horner's rule with A^(512 q): acc = A^(512q) acc ^ seg_s.
// All tables (16 slice + 5 tree + 1 chunk-step shift table, 40 KB) are built
// on the host (ops/crc_cuda.py) and copied to shared memory once per block;
// the blocks are persistent (grid-stride over warp tasks) so that copy is
// paid ~2x per SM, not per row.
//
// Bound on an H100 SXM: every input byte read once at 3.35 TB/s (the
// 8-byte outputs are noise): [4096, 2048] 8.39 MB -> 2.50 us,
// [16384, 4096] and [64, 1 MiB] 67.1 MB -> 20.0 us. The design runs below
// that: ~1.25 data-dependent shared-memory lookups per input byte, with bank
// conflicts, is its own ceiling. Measured by chip_smoke.py on an NVIDIA H100
// 80GB HBM3, 700.00 W: 9.6 us (26% of the bound), 46.4 us (43%) and 53.5 us
// (38%); a device copy of the same inputs takes 6.8, 47.6 and 47.6 us.
// ptxas: 29 registers, no spills.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (seaweedfs_tpu_torch/ops/_build.py, ops/crc_cuda.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;                   // bytes per warp step
constexpr int kSlices = 16;                   // slicing-by-16 tables
constexpr int kTreeLevels = 5;                // 32 lanes
constexpr int kTableWords = (kSlices + 4 * kTreeLevels + 4) * 256;
constexpr int kTableBytes = kTableWords * 4;  // 40 KB, dynamic shared memory
constexpr int kBlocksPerSM = 2;               // persistent blocks per SM

// M v for a map M given by its four byte tables t[0..1023].
__device__ __forceinline__ uint32_t shift(const uint32_t* t, uint32_t v) {
  return t[v & 0xFF] ^ t[256 + ((v >> 8) & 0xFF)] ^
         t[512 + ((v >> 16) & 0xFF)] ^ t[768 + (v >> 24)];
}

// Raw zero-init state of the 16 bytes of x (byte 0 = low byte of x.x).
__device__ __forceinline__ uint32_t lane_crc(const uint32_t* slice, uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = 4 * j + b;  // byte k, followed by 15 - k more
      r ^= slice[(15 - k) * 256 + ((w[j] >> (8 * b)) & 0xFF)];
    }
  }
  return r;
}

// One warp per (row, segment) task, grid-stride. Segment s of row r covers
// chunks [s q, (s + 1) q). With S == 1 the state goes to row_out as uint64;
// otherwise to seg_out[r S + s] for crc_combine_kernel.
__global__ void __launch_bounds__(kThreads)
crc_segments_kernel(const uint8_t* __restrict__ in,
                    const uint32_t* __restrict__ tables,
                    uint32_t* __restrict__ seg_out,
                    unsigned long long* __restrict__ row_out, long long B,
                    long long L, int S, int q) {
  extern __shared__ uint4 smem4[];
  const uint4* g4 = reinterpret_cast<const uint4*>(tables);
  for (int i = threadIdx.x; i < kTableWords / 4; i += kThreads) smem4[i] = g4[i];
  __syncthreads();
  const uint32_t* slice = reinterpret_cast<const uint32_t*>(smem4);
  const uint32_t* tree = slice + kSlices * 256;
  const uint32_t* step = tree + kTreeLevels * 1024;

  const int lane = threadIdx.x & 31;
  const long long tasks = B * S;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long task = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
       task < tasks; task += stride) {
    const long long row = task / S;
    const long long seg = task - row * S;
    const uint4* p = reinterpret_cast<const uint4*>(
                         in + row * L + seg * static_cast<long long>(q) * kChunk) + lane;
    uint32_t acc = 0;
    uint4 cur = __ldcs(p);
    for (int c = 0; c < q; ++c) {
      uint4 nxt = make_uint4(0, 0, 0, 0);
      if (c + 1 < q) nxt = __ldcs(p + (c + 1) * (kChunk / 16));
      acc = shift(step, acc) ^ lane_crc(slice, cur);
      cur = nxt;
    }
#pragma unroll
    for (int j = 0; j < kTreeLevels; ++j) {
      const uint32_t other = __shfl_xor_sync(0xffffffffu, acc, 1 << j);
      const bool right = (lane >> j) & 1;
      const uint32_t left = right ? other : acc;
      const uint32_t rgt = right ? acc : other;
      acc = shift(tree + j * 1024, left) ^ rgt;
    }
    if (lane == 0) {
      if (S == 1) row_out[row] = acc;
      else seg_out[task] = acc;
    }
  }
}

// One thread per row: fold the row's S segment states with A^(512 q).
__global__ void __launch_bounds__(kThreads)
crc_combine_kernel(const uint32_t* __restrict__ seg,
                   const uint32_t* __restrict__ seg_shift,
                   unsigned long long* __restrict__ out, long long B, int S) {
  __shared__ uint32_t op[1024];
  for (int i = threadIdx.x; i < 1024; i += kThreads) op[i] = seg_shift[i];
  __syncthreads();
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= B) return;
  uint32_t acc = 0;
  for (int s = 0; s < S; ++s) acc = shift(op, acc) ^ seg[row * S + s];
  out[row] = acc;
}

}  // namespace

extern "C" {

int crc32c_chunk_bytes() { return kChunk; }
int crc32c_table_words() { return kTableWords; }

// in: [B, L] uint8, 16-byte aligned, L % 512 == 0, L / 512 == S * q.
// out: [B] uint64. seg: [B * S] uint32 scratch (unused when S == 1).
// tables: kTableWords uint32 (slice, tree, chunk-step tables); seg_shift:
// 1024 uint32, the shift tables of A^(512 q) (unused when S == 1). All device
// pointers. Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise.
int crc32c_states(const void* in, void* out, void* seg, const void* tables,
                  const void* seg_shift, long long B, long long L, int S,
                  void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (L % kChunk != 0 || S <= 0 || (L / kChunk) % S != 0) return cudaErrorInvalidValue;
  const int q = static_cast<int>(L / kChunk / S);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tasks = B * S;
  long long blocks = (tasks + kWarps - 1) / kWarps;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSM)
    blocks = static_cast<long long>(sms) * kBlocksPerSM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  crc_segments_kernel<<<static_cast<unsigned>(blocks), kThreads, kTableBytes, st>>>(
      static_cast<const uint8_t*>(in), static_cast<const uint32_t*>(tables),
      static_cast<uint32_t*>(seg), static_cast<unsigned long long*>(out), B, L,
      S, q);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  crc_combine_kernel<<<static_cast<unsigned>((B + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const uint32_t*>(seg), static_cast<const uint32_t*>(seg_shift),
      static_cast<unsigned long long*>(out), B, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
