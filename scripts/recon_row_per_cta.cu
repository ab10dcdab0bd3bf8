// The delta rebuild as one CTA a row (the design that
// uvaia_tpu_torch/csrc/recon.cu's persistent kernel replaced), kept as
// the yardstick scripts/tune_recon_torch.py and chip_smoke.py time
// beside it in the same run.  The port never calls it.
//
// One CTA rebuilds one row of width w >= L in shared memory:
//   1. copy the base, zeros past L;
//   2. scatter the entries with pos < L (positions are unique per row);
//   3. block prefix sum over sites of d = [16 <= v < 32] - [v >= 32];
//   4. out = inside ? 0 : (v >= 32 ? v - 32 : (v >= 16 ? 0 : v)), with
//      inside = (inclusive prefix > 0).
// Every shared and global access is one byte wide, the row is walked
// five times between five block barriers, and every row re-reads the
// base.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ int run_delta(int v) {
  return (v >= 16 && v < 32) - (v >= 32);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
delta_rebuild_kernel(const P* __restrict__ pos,
                     const uint8_t* __restrict__ val,
                     const uint8_t* __restrict__ base, int E, int L, int w,
                     uint8_t* __restrict__ out) {
  extern __shared__ uint8_t row[];
  __shared__ int warp_sums[kThreads / 32];
  const int tid = threadIdx.x;
  const long b = blockIdx.x;

  for (int s = tid; s < w; s += kThreads) row[s] = s < L ? base[s] : 0;
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    long p = static_cast<long>(pos[b * E + e]);
    if (p < L) row[p] = val[b * E + e];
  }
  __syncthreads();

  // each thread owns one contiguous segment of sites
  const int per = (w + kThreads - 1) / kThreads;
  const int s0 = min(tid * per, w), s1 = min(s0 + per, w);
  int local = 0;
  for (int s = s0; s < s1; ++s) local += run_delta(row[s]);

  // block-wide exclusive scan of the per-thread sums
  const int lane = tid & 31, wid = tid >> 5;
  int x = local;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = t;
  }
  __syncthreads();
  int run = x - local + (wid > 0 ? warp_sums[wid - 1] : 0);

  for (int s = s0; s < s1; ++s) {
    int v = row[s];
    run += run_delta(v);
    int o = v >= 32 ? v - 32 : (v >= 16 ? 0 : v);
    row[s] = static_cast<uint8_t>(run > 0 ? 0 : o);
  }
  __syncthreads();
  for (int s = tid; s < w; s += kThreads) out[b * w + s] = row[s];
}

template <typename P>
int launch(const void* pos, const void* val, const void* base, int B, int E,
           int L, int w, void* out, cudaStream_t stream) {
  auto kernel = delta_rebuild_kernel<P>;
  if (w > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, w);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, kThreads, w, stream>>>(
      static_cast<const P*>(pos), static_cast<const uint8_t*>(val),
      static_cast<const uint8_t*>(base), E, L, w,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos: (B, E) uint16 (pos_bytes == 2) or int32 (pos_bytes == 4);
// val: (B, E) uint8; base: (L,) uint8; out: (B, w) uint8 with L <= w.
// Launches on `stream`; returns cudaGetLastError() (or the attribute
// error when w needs more shared memory than the card allows).
extern "C" int uvt_delta_rebuild_row_per_cta(const void* pos, int pos_bytes,
                                 const void* val, const void* base, int B,
                                 int E, int L, int w, void* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos_bytes == 2)
    return launch<uint16_t>(pos, val, base, B, E, L, w, out, s);
  return launch<int32_t>(pos, val, base, B, E, L, w, out, s);
}
