// Sparse-delta row rebuild: the hand-written Hopper kernel that replaces
// uvaia_tpu/ops/pallas_recon.py:_kernel together with the zero-run
// unmask pass uvaia_tpu/ops/scan.py:_unmask_runs.
//
// Each database row arrives as E (pos, val) entries against a shared
// base genome of L sites holding codes 0-15 (ops/host.delta_encode):
// val 0-15 is a code, 16 starts a run of zeros, 32 + c ends one (the
// site after the run holds code c), and pos >= L marks padding.  The
// result row is the base with the entries painted over it and every
// site at which the running sum of (starts - ends) is positive zeroed
// (scan.py:867-873).
//
// What bounds it on the H100: the (B, w) output write (126 MB at
// B=4096, w=30720: 38 us at 3.35 TB/s; a fill of those bytes takes
// 39.5 us on the card).  Everything else is made small beside it:
//   * persistent CTAs, each looping over rows: a row image in shared
//     memory is filled from the base in 16-byte loads (the base stays in
//     L2: re-reading it a row costs nothing beside the store, while
//     taking the painted sites back one by one cost a third of the
//     kernel), the row's entries are painted into it, and the row
//     leaves in 16-byte stores; a row that does not start on a 16-byte
//     boundary (w % 16 != 0) stores a ragged head and tail by the byte
//     and funnel-shifts the body out of 4-byte shared words;
//   * entries are read eight at a time (16- and 8-byte loads) where E
//     and the pointers allow;
//   * a row without markers (one __syncthreads_or over its entries)
//     skips the unmask;
//   * a row with markers whose real entries ascend in position, as both
//     producers emit them, gets its runs from a prefix sum over its E
//     entries, not its w sites: the running sum changes only at a
//     marker, so the sites from a marker at positive sum to the next
//     marker (or the row end) are zero-filled with wide stores, and a
//     marker at non-positive sum keeps its own code;
//   * a row with markers in any other order takes a prefix sum over the
//     sites, as the plain version does, so the kernel is exact for any
//     order of unique positions.
//
// The TPU kernel painted rows with a hi/lo one-hot MXU product because
// XLA's scatter there was slow and dropped updates; on Hopper a per-row
// scatter into shared memory is direct.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// CTAs an SM: four keep the store pipe busy across one another's
// barriers (eight measure the same, two 1.5 times slower)
constexpr int kCtasPerSm = 4;

__device__ __forceinline__ int run_delta(int v) {
  return (v >= 16 && v < 32) - (v >= 32);
}

__device__ __forceinline__ int marker_code(int v) {
  return v >= 32 ? v - 32 : 0;
}

// row[0, wpad) = base, zeros from L on
__device__ void init_row(uint8_t* row, const uint8_t* __restrict__ base,
                         int L, int wpad) {
  const int tid = threadIdx.x;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    done = L & ~15;
    for (int s = 16 * tid; s < done; s += 16 * kThreads)
      *reinterpret_cast<uint4*>(row + s) =
          __ldg(reinterpret_cast<const uint4*>(base + s));
  }
  for (int s = done + tid; s < wpad; s += kThreads)
    row[s] = s < L ? __ldg(base + s) : 0;
}

// dst[0, w) = row[0, w): 16-byte stores wherever dst allows them.  row
// is 16-byte aligned and readable up to w + 16.
__device__ void store_row(const uint8_t* row, uint8_t* __restrict__ dst,
                          int w) {
  const int tid = threadIdx.x;
  const int h = min(
      static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15),
      w);
  const int chunks = (w - h) >> 4;
  if (h == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
    uint4* out = reinterpret_cast<uint4*>(dst);
    for (int c = tid; c < chunks; c += kThreads) out[c] = src[c];
  } else {
    for (int s = tid; s < h; s += kThreads) dst[s] = row[s];
    const int sh = (h & 3) * 8;
    for (int c = tid; c < chunks; c += kThreads) {
      const int s = h + 16 * c;
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(row) + (s >> 2);
      const uint32_t a0 = wp[0], a1 = wp[1], a2 = wp[2], a3 = wp[3],
                     a4 = wp[4];
      uint4 o;
      o.x = __funnelshift_r(a0, a1, sh);
      o.y = __funnelshift_r(a1, a2, sh);
      o.z = __funnelshift_r(a2, a3, sh);
      o.w = __funnelshift_r(a3, a4, sh);
      *reinterpret_cast<uint4*>(dst + s) = o;
    }
  }
  for (int s = h + 16 * chunks + tid; s < w; s += kThreads) dst[s] = row[s];
}

// row[a, b) = 0 by one warp: bytes up to a 16-byte boundary, 16-byte
// stores, bytes again
__device__ __forceinline__ void zero_fill(uint8_t* row, int a, int b,
                                          int lane) {
  const int a16 = min((a + 15) & ~15, b);
  const int b16 = max(b & ~15, a16);
  for (int s = a + lane; s < a16; s += 32) row[s] = 0;
  for (int s = a16 + 16 * lane; s < b16; s += 512)
    *reinterpret_cast<uint4*>(row + s) = make_uint4(0, 0, 0, 0);
  for (int s = b16 + lane; s < b; s += 32) row[s] = 0;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix of `mine` over the block's threads; *total gets the
// block's sum.  `part` holds kWarps ints.  Ends on a barrier.
__device__ int block_exclusive_sum(int mine, int* part, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int incl = warp_inclusive_sum(mine, lane);
  if (lane == 31) part[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int t = warp_inclusive_sum(lane < kWarps ? part[lane] : 0, lane);
    if (lane < kWarps) part[lane] = t;
    if (lane == kWarps - 1) *total = t;
  }
  __syncthreads();
  return incl - mine + (wid > 0 ? part[wid - 1] : 0);
}

// Entries 8c .. 8c + 7 of a row; `wide`: E % 8 == 0 and the row's
// positions and values sit on 16- and 8-byte boundaries.  Slots from E
// on read as padding.
template <typename P>
__device__ __forceinline__ void load8(const P* __restrict__ prow,
                                      const uint8_t* __restrict__ vrow,
                                      int c, int E, bool wide,
                                      unsigned (&p)[8], int (&v)[8]) {
  if (wide) {
    const uint4* ps = reinterpret_cast<const uint4*>(prow + 8 * c);
    const uint4 lo = ps[0];
    if constexpr (sizeof(P) == 2) {
      const unsigned w[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = (w[k >> 1] >> (16 * (k & 1))) & 0xffffu;
    } else {
      const uint4 hi = ps[1];
      p[0] = lo.x; p[1] = lo.y; p[2] = lo.z; p[3] = lo.w;
      p[4] = hi.x; p[5] = hi.y; p[6] = hi.z; p[7] = hi.w;
    }
    const uint2 vv = *reinterpret_cast<const uint2*>(vrow + 8 * c);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = ((k < 4 ? vv.x : vv.y) >> (8 * (k & 3))) & 255;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = 8 * c + k;
      p[k] = e < E ? static_cast<unsigned>(prow[e]) : 0xffffffffu;
      v[k] = e < E ? vrow[e] : 0;
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
delta_rebuild_kernel(const P* __restrict__ pos,
                     const uint8_t* __restrict__ val,
                     const uint8_t* __restrict__ base, int B, int E, int L,
                     int w, int wpad, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* row = smem;                                   // wpad bytes
  int* mpos = reinterpret_cast<int*>(smem + wpad);       // E marker sites
  int* minfo = mpos + E;                                 // E: inside << 8 | val
  __shared__ int part[kWarps];
  __shared__ int total;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned uL = static_cast<unsigned>(L);

  const int nchunks = (E + 7) >> 3;
  const bool wide = (E & 7) == 0
      && (reinterpret_cast<uintptr_t>(pos) & 15) == 0
      && (reinterpret_cast<uintptr_t>(val) & 7) == 0;
  // a thread's span of entry chunks in the prefix sum over the entries
  const int span = (nchunks + kThreads - 1) / kThreads;
  const int c0 = min(tid * span, nchunks), c1 = min(c0 + span, nchunks);
  unsigned p[8];
  int v[8];

  for (long b = blockIdx.x; b < B; b += gridDim.x) {
    const P* prow = pos + b * E;
    const uint8_t* vrow = val + b * E;
    init_row(row, base, L, wpad);
    __syncthreads();

    // paint the plain entries; note markers and whether the real
    // entries ascend (a negative int32 position is dropped like padding)
    int marker = 0, unsorted = 0;
    for (int c = tid; c < nchunks; c += kThreads) {
      load8(prow, vrow, c, E, wide, p, v);
      unsigned prev = c > 0 ? static_cast<unsigned>(prow[8 * c - 1]) : 0u;
      bool first = c == 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (p[k] < uL) {
          if (v[k] < 16) row[p[k]] = static_cast<uint8_t>(v[k]);
          else marker = 1;
          if (!first && prev >= p[k]) unsorted = 1;
        }
        prev = p[k];
        first = false;
      }
    }
    if (__syncthreads_or(marker)) {
      if (__syncthreads_or(unsorted)) {
        // any order: running sum over the sites, as the plain version
        for (int e = tid; e < E; e += kThreads) {
          const unsigned q = static_cast<unsigned>(prow[e]);
          if (q < uL && vrow[e] >= 16) row[q] = vrow[e];
        }
        __syncthreads();
        const int per = (w + kThreads - 1) / kThreads;
        const int s0 = min(tid * per, w), s1 = min(s0 + per, w);
        int local = 0;
        for (int s = s0; s < s1; ++s) local += run_delta(row[s]);
        int run = block_exclusive_sum(local, part, &total);
        for (int s = s0; s < s1; ++s) {
          const int x = row[s];
          run += run_delta(x);
          const int o = x >= 16 ? marker_code(x) : x;
          row[s] = static_cast<uint8_t>(run > 0 ? 0 : o);
        }
      } else {
        // ascending: running sum over the entries, the sum in the high
        // half of a word and the marker count in the low
        int local = 0;
        for (int c = c0; c < c1; ++c) {
          load8(prow, vrow, c, E, wide, p, v);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (p[k] < uL && v[k] >= 16) local += run_delta(v[k]) * 65536 + 1;
        }
        int run = block_exclusive_sum(local, part, &total);
        for (int c = c0; c < c1; ++c) {
          load8(prow, vrow, c, E, wide, p, v);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (p[k] < uL && v[k] >= 16) {
              run += run_delta(v[k]) * 65536 + 1;
              const int m = (run & 0xffff) - 1;
              mpos[m] = static_cast<int>(p[k]);
              minfo[m] = ((run >> 16) > 0 ? 256 : 0) | v[k];
            }
          }
        }
        __syncthreads();
        const int n_marker = total & 0xffff;
        for (int m = wid; m < n_marker; m += kWarps) {
          const int at = mpos[m], info = minfo[m];
          if (info & 256)
            zero_fill(row, at, m + 1 < n_marker ? mpos[m + 1] : L, lane);
          else if (lane == 0)
            row[at] = static_cast<uint8_t>(marker_code(info & 255));
        }
      }
      __syncthreads();
    }

    store_row(row, out + b * w, w);
    __syncthreads();
  }
}

template <typename P>
int launch(const void* pos, const void* val, const void* base, int B, int E,
           int L, int w, void* out, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto kernel = delta_rebuild_kernel<P>;
  // the row image, 16 readable bytes past it, then the marker lists
  const int wpad = ((w + 15) & ~15) + 16;
  const size_t smem = static_cast<size_t>(wpad) + 8 * static_cast<size_t>(E);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int fit = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_sm = max(1, min(fit, kCtasPerSm));
  const int grid = min(B, sms * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const P*>(pos), static_cast<const uint8_t*>(val),
      static_cast<const uint8_t*>(base), B, E, L, w, wpad,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos: (B, E) uint16 (pos_bytes == 2) or int32 (pos_bytes == 4);
// val: (B, E) uint8; base: (L,) uint8, codes 0-15; out: (B, w) uint8
// with L <= w and B >= 1.  Launches on `stream`; returns cudaGetLastError()
// (or the attribute error when w + 8 E needs more shared memory than
// the card allows).
extern "C" int uvt_delta_rebuild(const void* pos, int pos_bytes,
                                 const void* val, const void* base, int B,
                                 int E, int L, int w, void* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos_bytes == 2)
    return launch<uint16_t>(pos, val, base, B, E, L, w, out, s);
  return launch<int32_t>(pos, val, base, B, E, L, w, out, s);
}
