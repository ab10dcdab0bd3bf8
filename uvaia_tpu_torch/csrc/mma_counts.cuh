// The shared tile routine of the counter kernels (score.cu, acgt.cu) and
// of the ambiguity corrections (corr.cu): (B, Q) integer counters of
// small-integer feature planes, summed over sites, as int8 tensor-core
// products — the TPU kernels' own formulation
// (uvaia_tpu/ops/pallas_score.py:_features and the int8 MXU `_dot`s).
//
// Every counter is a sum over products p and sites s of R_p[b, s] *
// Q_p[q, s] with R_p, Q_p in {0, 1} (corr.cu: R_p also -1): one int8
// tensor-core product per plane pair (`wgmma.mma_async.m64n64k32.s32.s8.s8`, sm_90a).  A plane is
// a SWAR function of a 32-bit word of four codes (swar.cuh), and a word
// of four consecutive sites is exactly what one register of an int8 A
// fragment holds (four consecutive k), so reference fragments are built
// in registers straight from staged code words: no feature plane of the
// references is ever written to memory.
//
// A CTA (256 threads: 2 warpgroups of 4 warps) computes a 128-reference x
// 64-query tile over a range of 64-site chunks:
//   * staging: a ring of 4 raw slots filled by cp.async keeps three
//     chunks' loads in flight; while the last k-step's products of a
//     chunk run, each thread converts its part of the next chunk (its
//     reference words, 8 of one row, and its query quad) into the other
//     of two compute buffers; one barrier a chunk.  Packed reference rows
//     are unpacked into natural site order there (sites past the row
//     read code 0);
//   * references are staged raw plus one flag word (pure | nonzero << 1),
//     rows padded to 20 words so fragment loads hit 32 distinct banks;
//   * queries are staged as their feature planes, each plane of a k-step
//     a K-major 64 x 32-byte tile of 8 x 16-byte core matrices, which
//     the products read straight from shared memory: each query plane is
//     built once per CTA, not once per warp;
//   * each warp owns 16 references x 64 queries: it builds each
//     reference plane's A fragment in registers, and its warpgroup
//     multiplies the 64 rows against the staged plane with one
//     asynchronous wgmma.m64n64k32 s8 product, accumulating in int32
//     registers (32 a thread per counter);
//   * the site loop is split across CTAs (gridDim.z) when the tiles alone
//     would leave SMs idle; the splits add into zeroed outputs with int32
//     atomics, which are exact and order-free, so results are
//     bit-identical from run to run;
//   * the consensus counters (query-independent) come from the
//     blockIdx.y == 0 CTAs, by SWAR masks on the staged words summed per
//     byte (one horizontal add a chunk, not a popcount a word), from the
//     staged reference words and flags and the chunk's consensus words
//     and masks staged beside them, while the first k-step's products
//     run.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "swar.cuh"

namespace uvt {
namespace mma {

constexpr int kRows = 128;           // references per CTA (2 warpgroups)
constexpr int kCols = 64;            // queries per CTA (the wgmma N)
constexpr int kThreads = 256;        // 8 warps, 16 reference rows each
constexpr int kChunk = 64;           // sites per stage
constexpr int kWords = kChunk / 4;   // code words per staged row
constexpr int kRowStride = kWords + 4;  // staged reference row, in words
constexpr int kKSteps = kChunk / 32;  // k32 steps per chunk
constexpr int kRefPerThread = kRows * kWords / kThreads;
constexpr int kRefWords = kRows * kRowStride;
constexpr int kKStepWords = kCols * 32 / 4;           // one plane, one k-step
constexpr int kQPlaneWords = kKSteps * kKStepWords;   // one plane, one stage
constexpr int kAcc = kCols / 2;      // accumulators a thread, per counter
// byte offsets between the 8-row x 16-byte core matrices of a staged
// query plane (K-major, no swizzle): next along K (leading), next along
// the queries (stride)
constexpr uint64_t kLeadBytes = 128, kStrideBytes = 256;

// Full mode: aa = 4 pure one-hot planes, mm = 4 mask-bit planes,
// vv = the non-zero plane; consensus (acgt_c, text_c, part_c, valid_c,
// valid_sites).
struct FullMode {
  static constexpr int kQOps = 1, kQPlanes = 9, kCounters = 3;
  // product p multiplies reference plane p with query plane qindex(p)
  static constexpr int kProducts = kQPlanes;
  // kRagged: the site count need not be a multiple of the chunk (the
  // tail is zero-filled in staging)
  static constexpr bool kRagged = false;
  // the fewest chunks a site split may hold
  static constexpr int kMinSplitChunks = 4;
  __device__ __forceinline__ static int qindex(int p) { return p; }
  __device__ __forceinline__ static int counter(int j) {
    return j < 4 ? 0 : (j < 8 ? 1 : 2);
  }
  // reference plane j from the raw word x and its flag word f
  __device__ __forceinline__ static uint32_t rplane(int j, uint32_t x,
                                                    uint32_t f) {
    if (j < 4) return (x >> j) & f & kLow;
    if (j < 8) return (x >> (j - 4)) & kLow;
    return (f >> 1) & kLow;
  }
  // query plane j from the query words y[operand]
  __device__ __forceinline__ static uint32_t qplane(int j,
                                                    const uint32_t* y) {
    uint32_t x = y[0];
    if (j < 4) return (x >> j) & pure_bytes(x);
    if (j < 8) return (x >> (j - 4)) & kLow;
    return nz_bytes(x);
  }
  // consensus masks of one word (0x01 a byte), added per byte into a[]:
  // reference word x with its flag word f, consensus word c with its
  // pure and non-zero masks cp, cn
  __device__ __forceinline__ static void cons(uint32_t x, uint32_t f,
                                              uint32_t c, uint32_t cp,
                                              uint32_t cn, uint32_t* a) {
    uint32_t xn = (f >> 1) & kLow, e = eq_bytes(x, c);
    a[0] += e & cp;
    a[1] += e & cn;
    a[2] += nz_bytes(x & c);
    a[3] += xn & cn;
    a[4] += xn;
  }
};

// --acgt: against each of q_full and q_poly, the pure plane (pp, ppp) and
// the 4 pure one-hot planes (aa, aap); consensus (mm_c, va_c, 0, 0,
// valid_sites).
struct AcgtMode {
  static constexpr int kQOps = 2, kQPlanes = 10, kCounters = 4;
  static constexpr int kProducts = kQPlanes;
  static constexpr bool kRagged = false;
  static constexpr int kMinSplitChunks = 4;
  __device__ __forceinline__ static int qindex(int p) { return p; }
  __device__ __forceinline__ static int counter(int j) {
    return 2 * (j / 5) + (j % 5 != 0);
  }
  __device__ __forceinline__ static uint32_t rplane(int j, uint32_t x,
                                                    uint32_t f) {
    int b = j % 5;
    if (b == 0) return f & kLow;
    return (x >> (b - 1)) & f & kLow;
  }
  __device__ __forceinline__ static uint32_t qplane(int j,
                                                    const uint32_t* y) {
    uint32_t x = y[j / 5];
    int b = j % 5;
    if (b == 0) return pure_bytes(x);
    return (x >> (b - 1)) & pure_bytes(x);
  }
  __device__ __forceinline__ static void cons(uint32_t x, uint32_t f,
                                              uint32_t c, uint32_t cp,
                                              uint32_t cn, uint32_t* a) {
    uint32_t both = f & cp;  // f's low bits: x pure
    a[0] += both & ~eq_bytes(x, c);
    a[1] += both;
    a[4] += (f >> 1) & kLow;
  }
};

// 1 where a byte holds code c (0..15), per byte
__device__ __forceinline__ uint32_t code_bytes(uint32_t x, int c) {
  const uint32_t b0 = (c & 1) ? x : ~x, b1 = (c & 2) ? x >> 1 : ~(x >> 1);
  const uint32_t b2 = (c & 4) ? x >> 2 : ~(x >> 2);
  const uint32_t b3 = (c & 8) ? x >> 3 : ~(x >> 3);
  return b0 & b1 & b2 & b3 & kLow;
}

// The full-mode ambiguity corrections (corr.cu) over the ambiguity codes
// (two or more bases: 3, 5, 6, 7, 9..15), 22 products of 16 query planes:
//   corr_t = sum_c [r == c][q == c]                         (11 products)
//   corr_p = [r amb][q amb] - sum_k [r amb, bit k][q amb, bit k]
//            - sum_{c of two bases} [r == c][q == 15 - c]   (1 + 4 + 6)
// since for two ambiguous codes [(r & q) != 0] fails only when both hold
// two bases and are complements.  A subtracted product carries its sign
// in the reference plane (bytes of -1), so it adds into the same
// accumulator.  Query planes: 0..10 the one-hot planes of the ambiguity
// codes, 11..14 the mask bits on ambiguous codes, 15 the ambiguous plane.
struct CorrMode {
  static constexpr int kQOps = 1, kQPlanes = 16, kCounters = 2;
  static constexpr int kProducts = 22;
  static constexpr bool kRagged = true;
  // a 64-query pack has a few hundred ambiguity columns: four chunks on
  // 32 of the 132 SMs unless each chunk may be a split
  static constexpr int kMinSplitChunks = 1;
  // the k-th ambiguity code, k in 0..10, and its inverse
  __host__ __device__ static constexpr int code(int k) {
    return k >= 4 ? k + 5 : (k == 0 ? 3 : k + 4);
  }
  __host__ __device__ static constexpr int index_of(int c) {
    return c >= 9 ? c - 5 : (c == 3 ? 0 : c - 4);
  }
  // the k-th code of two bases, k in 0..5: 3, 5, 6, 9, 10, 12
  __host__ __device__ static constexpr int pair_code(int k) {
    return k < 3 ? (k == 0 ? 3 : k + 4) : (k == 3 ? 9 : (k == 4 ? 10 : 12));
  }
  __device__ __forceinline__ static int counter(int p) { return p >= 11; }
  __device__ __forceinline__ static int qindex(int p) {
    return p < 16 ? p : index_of(15 - pair_code(p - 16));
  }
  __device__ __forceinline__ static uint32_t rplane(int p, uint32_t x,
                                                    uint32_t f) {
    const uint32_t amb = (f >> 1) & ~f & kLow;   // non-zero and not pure
    if (p < 11) return code_bytes(x, code(p));
    if (p < 15) return ((x >> (p - 11)) & amb) * 0xFFu;
    if (p == 15) return amb;
    return code_bytes(x, pair_code(p - 16)) * 0xFFu;
  }
  __device__ __forceinline__ static uint32_t qplane(int j,
                                                    const uint32_t* y) {
    const uint32_t x = y[0];
    if (j < 11) return code_bytes(x, code(j));
    const uint32_t amb = nz_bytes(x) & ~pure_bytes(x);
    if (j < 15) return (x >> (j - 11)) & amb;
    return amb;
  }
  // no consensus counters
  __device__ __forceinline__ static void cons(uint32_t, uint32_t, uint32_t,
                                              uint32_t, uint32_t, uint32_t*) {
  }
};

// d += A (64 x 32 s8: this warp's 16 rows in registers, the m16n8k32 A
// layout) * B (32 x 64 s8: a staged query plane, K-major, in shared
// memory, described by `desc`) for the warpgroup; asynchronous until
// wgmma_wait
__device__ __forceinline__ void wgmma_s8(int (&d)[kAcc],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
__device__ __forceinline__ void fence_regs(int (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared-memory matrix descriptor of a K-major tile without swizzle
__device__ __forceinline__ uint64_t kmajor_desc(const uint32_t* tile) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((addr >> 4) & 0x3FFF) | ((kLeadBytes >> 4) << 16) |
         ((kStrideBytes >> 4) << 32);
}

// raw staging ring: slot bytes (references, query operands, consensus)
constexpr int kStages = 4;
constexpr int kRawRef = kRows * kChunk;
constexpr int kRawQ = kCols * kChunk;
template <class M>
__host__ __device__ constexpr int raw_stage_bytes() {
  return kRawRef + M::kQOps * kRawQ + kChunk;
}

template <class M>
constexpr size_t smem_bytes() {
  return 2 * (2 * kRefWords + M::kQPlanes * kQPlaneWords + 3 * kWords) *
             sizeof(uint32_t) +
         kStages * raw_stage_bytes<M>();
}

// 16 bytes global -> shared, asynchronous (cp.async), the bytes past the
// first n (0 <= n <= 16) zero-filled; pieces of 8 or 4 bytes where `src`
// is less aligned, and a plain copy below 4-byte alignment.  With n == 0
// nothing is read, and `valid` (any global address) stands in for `src`.
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src,
                                       int n, const uint8_t* valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (n == 0) src = valid;
  if ((a & 15) == 0 || n == 0) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 16; i += 8) {
      int m = min(max(n - i, 0), 8);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                       d + i),
                   "l"(m ? src + i : src), "r"(m)
                   : "memory");
    }
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      int m = min(max(n - i, 0), 4);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       d + i),
                   "l"(m ? src + i : src), "r"(m)
                   : "memory");
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = i < n ? src[i] : 0;
  }
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the bytes of a 16-byte piece at column `col` that lie inside a row of W
__device__ __forceinline__ int piece_bytes(long col, int W) {
  const long left = W - col;
  return (int)(left < 0 ? 0 : (left < 16 ? left : 16));
}

// r: (B, rw) codes (packed: 2 * rw sites); q[o]: (Q, W) query operands;
// cons: (W,); sites [64 * chunk0, 64 * chunk1) of this CTA's split.
// out[k]: (B, Q) int32; cons5: (B, 5) int32.  `atomic`: add into zeroed
// outputs (site splits) instead of storing.
template <class M, bool kPacked, bool kCons>
__global__ void __launch_bounds__(kThreads, 1)
counters_kernel(const uint8_t* __restrict__ r, long rw,
                const uint8_t* __restrict__ q0, const uint8_t* __restrict__ q1,
                const uint8_t* __restrict__ cons, int B, int Q, int W,
                int chunks_per_split, int atomic, int32_t* __restrict__ o0,
                int32_t* __restrict__ o1, int32_t* __restrict__ o2,
                int32_t* __restrict__ o3, int32_t* __restrict__ cons5) {
  extern __shared__ uint4 smem_u4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_u4);
  uint32_t* r_raw = smem;                        // [2][kRefWords]
  uint32_t* r_flag = smem + 2 * kRefWords;       // [2][kRefWords]
  uint32_t* q_pl = smem + 4 * kRefWords;         // [2][kQPlanes][kQPlaneWords]
  constexpr int kQStage = M::kQPlanes * kQPlaneWords;
  // [2][3][kWords]: consensus words, their pure and their non-zero masks
  uint32_t* c_sm = q_pl + 2 * kQStage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * kRows, qbase = blockIdx.y * kCols;
  const int nchunks = (W + kChunk - 1) / kChunk;
  const int c0 = blockIdx.z * chunks_per_split;
  const int c1 = min(nchunks, c0 + chunks_per_split);
  const bool do_cons = kCons && blockIdx.y == 0;
  const uint8_t* qops[2] = {q0, q1};

  // raw staging ring: kStages slots, each the chunk's bytes as they are
  // in global memory, every thread's part copied by cp.async and read back
  // by the same thread only (no barrier between them): its reference row
  // `sr`, sites [32 * half, 32 * half + 32) of the chunk, as two 16-byte
  // parts (one packed); its query quad (tid) of each operand; threads < 4
  // a 16-byte part of the consensus
  uint8_t* ring = reinterpret_cast<uint8_t*>(c_sm + 6 * kWords);
  const int sr = tid >> 1, half = tid & 1;
  // the query quad of this thread, in the core-matrix order of a staged
  // plane (index bits: query in an 8-row group, K half, query group,
  // k-step), so 32 threads store 512 consecutive bytes of a plane
  const int qrow = qbase + ((tid >> 4) & 7) * 8 + (tid & 7);
  const int qword = (tid >> 7) * 8 + ((tid >> 3) & 1) * 4;
  int cacc[5] = {0, 0, 0, 0, 0};
  int acc[M::kCounters][kAcc];
#pragma unroll
  for (int k = 0; k < M::kCounters; ++k)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[k][i] = 0;

  // global -> ring slot: chunk c's bytes of this thread
  auto fetch = [&](int c, int slot) {
    uint8_t* st = ring + slot * raw_stage_bytes<M>();
    const long site = (long)c * kChunk;
    const int b = b0 + sr;
    if (!kPacked) {
      const long col = site + 32 * half;
      const uint8_t* src = r + (long)b * rw + col;
      const int live = b < B ? 16 : 0;
      copy16(st + 16 * tid, src,
             M::kRagged ? min(live, piece_bytes(col, W)) : live, r);
      copy16(st + kRawRef / 2 + 16 * tid, src + 16,
             M::kRagged ? min(live, piece_bytes(col + 16, W)) : live, r);
    } else {
      const long k0 = site / 2 + 16 * half;
      const long left = rw - k0;
      const int n = b < B ? (int)(left < 0 ? 0 : (left < 16 ? left : 16)) : 0;
      copy16(st + 16 * tid, r + (long)b * rw + k0, n, r);
    }
    const int qlive = qrow < Q ? 16 : 0;
#pragma unroll
    for (int o = 0; o < M::kQOps; ++o)
      copy16(st + kRawRef + o * kRawQ + 16 * tid,
             qops[o] + (long)qrow * W + site + 4 * qword,
             M::kRagged ? min(qlive, piece_bytes(site + 4 * qword, W))
                        : qlive,
             qops[o]);
    if (do_cons && tid < kChunk / 16)
      copy16(st + kRawRef + M::kQOps * kRawQ + 16 * tid,
             cons + site + 16 * tid, 16, cons);
  };

  // ring slot -> compute buffer `buf`: the reference words and flags, the
  // query planes and the consensus words
  auto convert = [&](int slot, int buf) {
    const uint8_t* st = ring + slot * raw_stage_bytes<M>();
    uint32_t x[kRefPerThread];
    if (!kPacked) {
      uint4 v0 = *reinterpret_cast<const uint4*>(st + 16 * tid);
      uint4 v1 = *reinterpret_cast<const uint4*>(st + kRawRef / 2 + 16 * tid);
      x[0] = v0.x, x[1] = v0.y, x[2] = v0.z, x[3] = v0.w;
      x[4] = v1.x, x[5] = v1.y, x[6] = v1.z, x[7] = v1.w;
    } else {
      // byte k holds site 2k (high nibble) and 2k + 1: word m is bytes
      // 2m and 2m + 1 in natural site order
      uint4 v = *reinterpret_cast<const uint4*>(st + 16 * tid);
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < kRefPerThread; ++m) {
        uint32_t pair = (w[m >> 1] >> (16 * (m & 1))) & 0xFFFFu;
        uint32_t b0 = pair & 0xFFu, b1 = pair >> 8;
        x[m] = (b0 >> 4) | ((b0 & 15u) << 8) | ((b1 >> 4) << 16) |
               ((b1 & 15u) << 24);
      }
    }
    uint4* rr = reinterpret_cast<uint4*>(r_raw + buf * kRefWords +
                                         sr * kRowStride + half * 8);
    uint4* rf = reinterpret_cast<uint4*>(r_flag + buf * kRefWords +
                                         sr * kRowStride + half * 8);
    uint32_t f[kRefPerThread];
#pragma unroll
    for (int j = 0; j < kRefPerThread; ++j)
      f[j] = pure_bytes(x[j]) | (nz_bytes(x[j]) << 1);
    rr[0] = make_uint4(x[0], x[1], x[2], x[3]);
    rr[1] = make_uint4(x[4], x[5], x[6], x[7]);
    rf[0] = make_uint4(f[0], f[1], f[2], f[3]);
    rf[1] = make_uint4(f[4], f[5], f[6], f[7]);
    uint32_t y[4][2];
#pragma unroll
    for (int o = 0; o < M::kQOps; ++o) {
      uint4 v = *reinterpret_cast<const uint4*>(st + kRawRef + o * kRawQ +
                                                16 * tid);
      y[0][o] = v.x, y[1][o] = v.y, y[2][o] = v.z, y[3][o] = v.w;
    }
    uint32_t* qp = q_pl + buf * kQStage + 4 * tid;
#pragma unroll
    for (int p = 0; p < M::kQPlanes; ++p)
      *reinterpret_cast<uint4*>(qp + p * kQPlaneWords) =
          make_uint4(M::qplane(p, y[0]), M::qplane(p, y[1]),
                     M::qplane(p, y[2]), M::qplane(p, y[3]));
    if (do_cons && tid < kChunk / 16) {
      uint4 c = *reinterpret_cast<const uint4*>(st + kRawRef +
                                                M::kQOps * kRawQ + 16 * tid);
      uint4* cs = reinterpret_cast<uint4*>(c_sm + buf * 3 * kWords) + tid;
      cs[0] = c;
      cs[kWords / 4] = make_uint4(pure_bytes(c.x), pure_bytes(c.y),
                                  pure_bytes(c.z), pure_bytes(c.w));
      cs[kWords / 2] = make_uint4(nz_bytes(c.x), nz_bytes(c.y),
                                  nz_bytes(c.z), nz_bytes(c.w));
    }
    // make the generic-proxy stores visible to the products' async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // the consensus counters of the staged buffer `buf` (this thread's
  // row and words): SWAR masks summed per byte (each byte <= 8), folded
  // into the counters once a chunk, so no popcount per word
  auto consensus = [&](int buf) {
    const int o = buf * kRefWords + sr * kRowStride + half * 8;
    const uint4* x4 = reinterpret_cast<const uint4*>(r_raw + o);
    const uint4* f4 = reinterpret_cast<const uint4*>(r_flag + o);
    const uint4* c4 =
        reinterpret_cast<const uint4*>(c_sm + buf * 3 * kWords + half * 8);
    uint32_t bytes[5] = {0, 0, 0, 0, 0};
#pragma unroll
    for (int h = 0; h < kRefPerThread / 4; ++h) {
      uint4 x = x4[h], f = f4[h], c = c4[h], cp = c4[h + kWords / 4],
            cn = c4[h + kWords / 2];
      M::cons(x.x, f.x, c.x, cp.x, cn.x, bytes);
      M::cons(x.y, f.y, c.y, cp.y, cn.y, bytes);
      M::cons(x.z, f.z, c.z, cp.z, cn.z, bytes);
      M::cons(x.w, f.w, c.w, cp.w, cn.w, bytes);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) cacc[k] += (bytes[k] * kLow) >> 24;
  };

  // the products of buffer `buf`: per k-step, every reference plane's A
  // fragment (this warp's 16 rows) built in registers, then one
  // m64n64k32 product a plane against the staged query plane.  While the
  // products run, the consensus counters of `buf` (first k-step) and the
  // staging of the next chunk into buffer `next` (last k-step, if
  // next >= 0) keep the warps busy.
  auto compute = [&](int buf, int next, int next_slot) {
    const uint32_t* rr = r_raw + buf * kRefWords;
    const uint32_t* rf = r_flag + buf * kRefWords;
    const uint32_t* qp = q_pl + buf * kQStage;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      // A fragment words: (row g, word t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      uint32_t xr[4], fr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int o = (warp * 16 + g + (i & 1) * 8) * kRowStride + ks * 8 +
                (i >> 1) * 4 + t;
        xr[i] = rr[o];
        fr[i] = rf[o];
      }
      uint32_t a[M::kProducts][4];
#pragma unroll
      for (int p = 0; p < M::kProducts; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[p][i] = M::rplane(p, xr[i], fr[i]);
#pragma unroll
      for (int k = 0; k < M::kCounters; ++k) fence_regs(acc[k]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < M::kProducts; ++p)
        wgmma_s8(acc[M::counter(p)], a[p],
                 kmajor_desc(qp + M::qindex(p) * kQPlaneWords +
                             ks * kKStepWords));
      wgmma_commit();
      if (ks == 0 && do_cons) consensus(buf);
      if (ks == kKSteps - 1 && next >= 0) {
        copy_wait<kStages - 2>();  // this thread's part of the next chunk
        convert(next_slot, next);
      }
      wgmma_wait();
#pragma unroll
      for (int k = 0; k < M::kCounters; ++k) fence_regs(acc[k]);
      // the A registers stay allocated until the products have read them
#pragma unroll
      for (int p = 0; p < M::kProducts; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(a[p][i]));
    }
  };

  const int n = c1 - c0;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n) fetch(c0 + k, k);
    copy_commit();
  }
  if (n > 0) {
    copy_wait<kStages - 2>();
    convert(0, 0);
  }
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n)
      fetch(c0 + i + kStages - 1, (i + kStages - 1) % kStages);
    copy_commit();
    const int buf = i & 1;
    compute(buf, i + 1 < n ? buf ^ 1 : -1, (i + 1) % kStages);
    __syncthreads();
  }

  // accumulator 4 nb + i: row g + 8 (i >> 1), query 8 nb + 2t + (i & 1)
  int32_t* outs[4] = {o0, o1, o2, o3};
#pragma unroll
  for (int k = 0; k < M::kCounters; ++k)
#pragma unroll
    for (int nb = 0; nb < kCols / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int b = b0 + warp * 16 + g + (i >> 1) * 8;
        int qi = qbase + nb * 8 + 2 * t + (i & 1);
        if (b < B && qi < Q) {
          int32_t* o = outs[k] + (long)b * Q + qi;
          if (atomic)
            atomicAdd(o, acc[k][4 * nb + i]);
          else
            *o = acc[k][4 * nb + i];
        }
      }
  if (do_cons) {
#pragma unroll
    for (int k = 0; k < 5; ++k) cacc[k] += __shfl_xor_sync(0xffffffffu, cacc[k], 1);
    const int b = b0 + sr;
    if (half == 0 && b < B) {
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        if (atomic)
          atomicAdd(cons5 + (long)b * 5 + k, cacc[k]);
        else
          cons5[(long)b * 5 + k] = cacc[k];
      }
    }
  }
}

// Site splits for `tiles` CTAs on `slots` resident CTA slots: 1 when the
// tiles fill the card, else the least split whose CTAs fill at least 85%
// of the slots of their last wave (at most one split per `min_chunks`
// chunks, and none below two such splits).
inline int choose_splits(long tiles, int slots, int nchunks, int min_chunks) {
  if (tiles >= slots || nchunks < 2 * min_chunks) return 1;
  int best = 1;
  double best_eff = 0.0;
  for (int s = 1; s <= 32 && s * min_chunks <= nchunks; ++s) {
    long ctas = tiles * s;
    long waves = (ctas + slots - 1) / slots;
    double eff = double(ctas) / double(waves * slots);
    if (eff >= 0.85) return s;
    if (eff > best_eff) best_eff = eff, best = s;
  }
  return best;
}

// Launch on `s`: outs[0 .. M::kCounters) (B, Q) int32, cons5 (B, 5) int32
// (kCons only); W % 64 == 0 unless M::kRagged.  Returns cudaGetLastError().
template <class M, bool kPacked, bool kCons>
int launch(const uint8_t* r, long rw, const uint8_t* q0, const uint8_t* q1,
           const uint8_t* cons, int B, int Q, int W, int32_t* const* outs,
           int32_t* cons5, cudaStream_t s) {
  auto kern = counters_kernel<M, kPacked, kCons>;
  constexpr size_t smem = smem_bytes<M>();
  static int slots = 0;  // resident CTAs on the card, per instantiation
  if (slots == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch reports its own
      return (int)e;
    }
    int dev = 0, nsm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                  smem);
    slots = nsm * (per_sm > 0 ? per_sm : 1);
  }
  const int nchunks = (W + kChunk - 1) / kChunk;
  dim3 grid((B + kRows - 1) / kRows, (Q + kCols - 1) / kCols, 1);
  int splits = choose_splits((long)grid.x * grid.y, slots, nchunks,
                             M::kMinSplitChunks);
  const int per = (nchunks + splits - 1) / splits;
  splits = per > 0 ? (nchunks + per - 1) / per : 1;
  grid.z = splits;
  const int atomic = splits > 1;
  if (atomic) {
    for (int k = 0; k < M::kCounters; ++k)
      cudaMemsetAsync(outs[k], 0, sizeof(int32_t) * (size_t)B * Q, s);
    if (kCons) cudaMemsetAsync(cons5, 0, sizeof(int32_t) * (size_t)B * 5, s);
  }
  int32_t* o[4] = {outs[0], outs[1],
                   M::kCounters > 2 ? outs[2] : nullptr,
                   M::kCounters > 3 ? outs[3] : nullptr};
  kern<<<grid, kThreads, smem, s>>>(r, rw, q0, q1, cons, B, Q, W,
                                    per > 0 ? per : 1, atomic, o[0], o[1],
                                    o[2], o[3], cons5);
  return (int)cudaGetLastError();
}

}  // namespace mma
}  // namespace uvt
