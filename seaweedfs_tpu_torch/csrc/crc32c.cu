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
// where A^n is the 32x32 GF(2) map of n zero bytes. The raw state is linear
// in the message bits, so any such map, and the state of a 16-byte piece,
// is an XOR of one table lookup per w-bit field of its input:
// M v = XOR_i T_i[field i of v] with T_i[e] = M (e << w i).
//
// Design (times and what bounds them in PERF.md):
// - Work is a stream of (row, segment) tasks, one warp each, grid-stride.
//   A segment is q 512-byte chunks; lane i takes bytes [16i, 16i+16) of
//   each chunk (one coalesced 512-byte warp load of uint4s). Each lane keeps
//   kQueue chunks of loads in flight (a register ring) and refills a slot as
//   it consumes it, across task boundaries.
// - Lane CRC of 16 bytes: 26 lookups of 5-bit fields (the last 3 bits
//   wide; 3 fields span two words and take a funnel shift). Chunk step of
//   the lane's running state, acc = A^512 acc ^ lane_crc: 7 lookups of
//   5-bit fields. Then lane i applies its own map A^(16 (31 - i)) to acc
//   (8 lookups of 4-bit fields in tables whose values differ per lane) and
//   a 5-step __shfl_xor_sync butterfly XORs the lanes into the segment's
//   state. No shuffle tree of shifts, and nothing per byte beyond the 33
//   lookups a lane makes per 16 bytes.
// - Every table is lane-private: lane l's copy of entry e sits at byte
//   e * 128 + l * 4 of its table, always bank l, so each warp-wide lookup is
//   one shared-memory wavefront whatever the data. The address is a shift
//   and one LOP3, ((w >> s) & mask) | la, where la is the tables' shared
//   address (aligned to 4 KB, so the OR is an add) with lane * 4 in it; the
//   table's offset rides in the load's immediate.
// - Shared memory: 26 lane tables (101 KB), 7 step tables (24.5 KB), 8 fold
//   tables (16 KB), 141.5 KB in all, one persistent 1024-thread block per SM
//   (the attribute for more than 48 KB is set once per device). The host
//   image is compact (5100 words: the distinct values only); each block
//   loads it in one round trip to L2 and writes the 32-fold copies itself,
//   while its first loads of input are already in flight.
// - Rows split into S segments (ops/crc_cuda.segments) when the batch is
//   too short to fill the card's resident warps; a second kernel folds a
//   row's S states by Horner's rule with A^(512 q) in byte tables.
//
// Bound on an H100 SXM: every input byte read once at 3.35 TB/s (the
// 8-byte outputs are noise): [4096, 2048] 8.39 MB -> 2.50 us,
// [16384, 4096] and [64, 1 MiB] 67.1 MB -> 20.0 us. What holds the kernel
// at 56-68% of it is the lookup work, not its loads of input (a deeper
// load queue is no faster): a warp issues 33 shared-memory loads and ~110
// other instructions per 512 B, and the card sustained about one shared
// load every two clocks per SM and ~2.4 instructions a clock. Nibble
// fields (40 lookups) measured 9-12% slower at the large shapes; 6-bit lane
// fields (22 lookups, 222 KB of tables) 1-3% faster there but 13-17% slower
// at the scrub's [4096, 2048], where building the tables weighs more.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (seaweedfs_tpu_torch/ops/_build.py, ops/crc_cuda.py).

#include <atomic>
#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;                // one block per SM
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;                   // bytes per warp step
constexpr int kQueue = 2;                     // chunks of loads in flight per lane
// Field widths (bits a lookup consumes) of the three kinds of tables: the
// lane CRC over 128 data bits, the chunk step and the fold over 32 state
// bits. A field of w bits indexes a table of 2^w entries, each 32-fold
// (one word per lane, 128 B), so a table takes 128 << w bytes; the last
// field of an input may be narrower.
constexpr int kLaneBits = 5;
constexpr int kStepBits = 5;
constexpr int kFoldBits = 4;
__host__ __device__ constexpr int fields(int bits, int w) { return (bits + w - 1) / w; }
__host__ __device__ constexpr int entries(int bits, int w) {  // all tables of an input
  return (bits / w) * (1 << w) + (bits % w ? 1 << (bits % w) : 0);
}
constexpr int kWideBits = kLaneBits > kStepBits ? (kLaneBits > kFoldBits ? kLaneBits : kFoldBits)
                                                : (kStepBits > kFoldBits ? kStepBits : kFoldBits);
// compact host image: lane tables, step tables (one value per entry), then
// the fold tables with one value per lane
constexpr int kLaneEntries = entries(128, kLaneBits);
constexpr int kStepEntries = entries(32, kStepBits);
constexpr int kCompactShared = kLaneEntries + kStepEntries;
constexpr int kCompactWords = kCompactShared + entries(32, kFoldBits) * 32;
// shared memory: every table 32-fold; byte offsets of the three regions
constexpr int kStepBase = kLaneEntries * 128;
constexpr int kFoldBase = kStepBase + kStepEntries * 128;
constexpr int kSmemBytes = kFoldBase + entries(32, kFoldBits) * 128;
// the tables' base is aligned so that an entry's offset ORs into it
constexpr int kAlign = 128 << kWideBits;
constexpr int kSmemAlloc = kSmemBytes + kAlign - 16;
constexpr int kMaxDevices = 64;
static_assert(kCompactShared % 4 == 0, "the fold tables start on a uint4");
static_assert(kSmemAlloc <= 232448, "more shared memory than a Hopper block may take");

// 32-bit shared-memory load at `addr + kOff`: the offset rides in the
// instruction's immediate. Volatile, so it stays after the compiler
// barrier that follows the tables' build.
template <int kOff>
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1+%2];" : "=r"(v) : "r"(addr), "n"(kOff));
  return v;
}

// Lookup of field kI (kW bits wide, of an input of kBits bits held in
// words w[]) in its table, in this lane's copy: the field's tables start at
// byte kBase, table kI at kBase + kI * (128 << kW), entry e at e * 128 +
// lane * 4. `la` is the aligned shared address of the tables OR lane * 4,
// so one shift (a funnel shift where the field spans two words) and one
// LOP3 put the entry in.
template <int kBase, int kW, int kBits, int kI>
__device__ __forceinline__ uint32_t field(const uint32_t* w, uint32_t la) {
  constexpr int p = kW * kI;                         // the field's first bit
  constexpr int width = kBits - p < kW ? kBits - p : kW;
  constexpr int word = p / 32, bit = p % 32;
  constexpr uint32_t mask = ((1u << width) - 1) << 7;
  uint32_t f;
  if constexpr (bit + width > 32)
    f = __funnelshift_r(w[word], w[word + 1], bit - 7);
  else if constexpr (bit >= 7)
    f = w[word] >> (bit - 7);
  else
    f = w[word] << (7 - bit);
  return lds<kBase + kI * (128 << kW)>((f & mask) | la);
}

template <int kBase, int kW, int kBits, int... kI>
__device__ __forceinline__ uint32_t apply(const uint32_t* w, uint32_t la,
                                          std::integer_sequence<int, kI...>) {
  return (field<kBase, kW, kBits, kI>(w, la) ^ ...);
}

// XOR of the lookups of every field of the kBits-bit input in w[].
template <int kBase, int kW, int kBits>
__device__ __forceinline__ uint32_t lookup(const uint32_t* w, uint32_t la) {
  return apply<kBase, kW, kBits>(w, la, std::make_integer_sequence<int, fields(kBits, kW)>{});
}

// Raw zero-init state of the 16 bytes of x (byte 0 = low byte of x.x).
__device__ __forceinline__ uint32_t lane_crc(uint4 x, uint32_t la) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  return lookup<0, kLaneBits, 128>(w, la);
}

// A^512 v (the chunk step) and lane l's A^(16 (31 - l)) v (the fold).
__device__ __forceinline__ uint32_t step(uint32_t v, uint32_t la) {
  return lookup<kStepBase, kStepBits, 32>(&v, la);
}
__device__ __forceinline__ uint32_t fold(uint32_t v, uint32_t la) {
  return lookup<kFoldBase, kFoldBits, 32>(&v, la);
}

// One warp per (row, segment) task, grid-stride. Segment s of row r covers
// chunks [s q, (s + 1) q), so task t starts at byte t * q * 512. With S == 1
// the state goes to row_out as uint64; otherwise to seg_out[t] for
// crc_combine_kernel.
__global__ void __launch_bounds__(kThreads, 1)
crc_segments_kernel(const uint8_t* __restrict__ in,
                    const uint32_t* __restrict__ tables,
                    uint32_t* __restrict__ seg_out,
                    unsigned long long* __restrict__ row_out, long long tasks,
                    int q, int split) {
  extern __shared__ __align__(16) uint4 smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  uint4* smem4 = smem_raw + (base - raw) / 16;
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t la = base | (lane << 2);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const long long task_quads = static_cast<long long>(q) * (kChunk / 16);
  const uint4* in4 = reinterpret_cast<const uint4*>(in) + lane;

  // This warp's tasks are task0, task0 + stride, ...: `total` chunks in
  // all, in one stream. A task's chunks are contiguous; the next task
  // starts `jump` uint4s after the end of the last.
  // A warp past the last task has none, but still helps build the tables.
  const long long task0 = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int total = task0 < tasks ? static_cast<int>((tasks - 1 - task0) / stride + 1) * q : 0;
  const long long jump = (stride - 1) * task_quads;

  // The load side of the ring: chunk ld of the stream, ld_c of its task.
  const uint4* ld_p = in4 + task0 * task_quads;
  int ld = 0, ld_c = 0;
  uint4 ring[kQueue];
#pragma unroll
  for (int u = 0; u < kQueue; ++u) {
    if (ld < total) ring[u] = __ldcs(ld_p);
    ++ld;
    ld_p += kChunk / 16;
    if (++ld_c == q) {
      ld_c = 0;
      ld_p += jump;
    }
  }

  // Tables, while those loads fly: the lane and step tables 32-fold, the
  // fold tables (already one value per lane) as they are. Pass k of the
  // 32-fold copy writes uint4 i = threadIdx.x + 1024 k, which holds compact
  // word i / 8: a warp's pass needs 4 words, 128 apart from one pass to the
  // next. Lane l loads word 4 warp + (l & 3) + 128 (l >> 2) + 1024 h of
  // the passes 8 h .. 8 h + 7, so two loads, both issued before any store,
  // serve every pass through a shuffle: one round trip to L2.
  constexpr int kRepWords = kCompactShared;                       // 32-fold words
  constexpr int kPasses = (kRepWords * 8 + kThreads - 1) / kThreads;
  static_assert(kPasses <= 16, "two loads a lane cover 16 passes");
  constexpr int kFold4 = (kCompactWords - kCompactShared) / 4;
  static_assert(kFold4 <= kThreads, "one fold uint4 per thread");
  const int warp = threadIdx.x / 32;
  uint32_t word[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int w = 4 * warp + (lane & 3) + 128 * (lane >> 2) + 1024 * h;
    if (w < kRepWords) word[h] = __ldg(tables + w);
  }
  const uint4* fold4 = reinterpret_cast<const uint4*>(tables + kCompactShared);
  uint4 f4 = make_uint4(0, 0, 0, 0);
  if (threadIdx.x < kFold4) f4 = __ldg(fold4 + threadIdx.x);
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const uint32_t v = __shfl_sync(0xffffffffu, word[k / 8], 4 * (k % 8) + (lane >> 3));
    const int i = threadIdx.x + k * kThreads;
    if (i < kRepWords * 8) smem4[i] = make_uint4(v, v, v, v);
  }
  if (threadIdx.x < kFold4) smem4[kRepWords * 8 + threadIdx.x] = f4;
  __syncthreads();
  // lds() reads the tables through asm the compiler cannot see into: keep
  // every such read after the stores above.
  asm volatile("" ::: "memory");

  long long task = task0;
  int c = 0;
  uint32_t acc = 0;
  for (int i = 0; i < total;) {
#pragma unroll
    for (int u = 0; u < kQueue; ++u, ++i) {
      if (i == total) return;  // warp-uniform
      const uint32_t crc = lane_crc(ring[u], la);
      if (ld < total) ring[u] = __ldcs(ld_p);  // the slot's next chunk
      ++ld;
      ld_p += kChunk / 16;
      if (++ld_c == q) {
        ld_c = 0;
        ld_p += jump;
      }
      acc = c ? step(acc, la) ^ crc : crc;
      if (++c == q) {
        acc = fold(acc, la);
#pragma unroll
        for (int j = 1; j < 32; j <<= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, j);
        if (lane == 0) {
          if (split) seg_out[task] = acc;
          else row_out[task] = acc;
        }
        acc = 0;
        c = 0;
        task += stride;
      }
    }
  }
}

// M v for a map M given by its four byte tables t[0..1023].
__device__ __forceinline__ uint32_t shift(const uint32_t* t, uint32_t v) {
  return t[v & 0xFF] ^ t[256 + ((v >> 8) & 0xFF)] ^
         t[512 + ((v >> 16) & 0xFF)] ^ t[768 + (v >> 24)];
}

constexpr int kCombineThreads = 256;

// One thread per row: fold the row's S segment states with A^(512 q).
__global__ void __launch_bounds__(kCombineThreads)
crc_combine_kernel(const uint32_t* __restrict__ seg,
                   const uint32_t* __restrict__ seg_shift,
                   unsigned long long* __restrict__ out, long long B, int S) {
  __shared__ uint32_t op[1024];
  for (int i = threadIdx.x; i < 1024; i += kCombineThreads) op[i] = seg_shift[i];
  __syncthreads();
  const long long row = static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (row >= B) return;
  uint32_t acc = 0;
  for (int s = 0; s < S; ++s) acc = shift(op, acc) ^ seg[row * S + s];
  out[row] = acc;
}

// Devices whose crc_segments_kernel may take kSmemAlloc of shared memory.
std::atomic<unsigned long long> g_smem_set{0};

}  // namespace

extern "C" {

int crc32c_chunk_bytes() { return kChunk; }
int crc32c_table_words() { return kCompactWords; }
int crc32c_shared_bytes() { return kSmemAlloc; }

// in: [B, L] uint8, 16-byte aligned, L % 512 == 0, L / 512 == S * q.
// out: [B] uint64. seg: [B * S] uint32 scratch (unused when S == 1).
// tables: kCompactWords uint32, 16-byte aligned (lane, step and fold
// tables, ops/crc_cuda.kernel_tables); seg_shift: 1024 uint32, the byte
// tables of A^(512 q) (unused when S == 1). All device pointers. Launches on
// `stream` and returns the first CUDA error (0 on success); does not
// synchronise.
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
  const unsigned long long bit = dev < kMaxDevices ? 1ull << dev : 0;
  if (!(g_smem_set.load() & bit)) {
    err = cudaFuncSetAttribute(crc_segments_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set.fetch_or(bit);
  }
  const long long tasks = B * S;
  long long blocks = (tasks + kWarps - 1) / kWarps;
  if (blocks > sms) blocks = sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  crc_segments_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemAlloc, st>>>(
      static_cast<const uint8_t*>(in), static_cast<const uint32_t*>(tables),
      static_cast<uint32_t*>(seg), static_cast<unsigned long long*>(out), tasks, q,
      S > 1);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  crc_combine_kernel<<<static_cast<unsigned>((B + kCombineThreads - 1) / kCombineThreads),
                       kCombineThreads, 0, st>>>(
      static_cast<const uint32_t*>(seg), static_cast<const uint32_t*>(seg_shift),
      static_cast<unsigned long long*>(out), B, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
