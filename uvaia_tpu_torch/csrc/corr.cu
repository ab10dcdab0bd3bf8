// Full-mode ambiguity corrections: the hand-written Hopper kernel that
// replaces uvaia_tpu/ops/pallas_score.py:_kernel_corr.
//
// Over the A ambiguity columns of the query pack (reference codes r
// (B, A), query codes q (Q, A)), with amb(c) = (c & (c - 1)) != 0
// (two or more bases, code 15 included):
//   corr_t[b, q] = sum_a [r == q, both ambiguous]
//   corr_p[b, q] = sum_a [both ambiguous] * ([(r & q) != 0] - popc(r & q))
// Pad columns hold code 0 and contribute nothing.
//
// The TPU kernel built 27 one-hot planes per tile and ran 22 MXU dots
// (the derivation at pallas_score.py:210-221).  Here both counters
// come straight from their per-site definitions: each word of four
// codes is masked to its ambiguous bytes once at staging, and a pair
// of words then costs one XOR-equality test and two popcounts.
//
// What bounds it on the H100: integer ALU work, about B * Q * A / 4
// word pairs of ~20 instructions; A is a few hundred columns for a
// 64-query SARS-CoV-2 pack, so at that size the kernel is short next
// to the main counter kernel.  Same 32 x 64 CTA tiling as score.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "swar.cuh"

namespace {

constexpr int kBT = 32;
constexpr int kQT = 64;
constexpr int kSW = 16;
constexpr int kThreads = 256;
constexpr int kRPT = kBT / 16;
constexpr int kQPT = kQT / 16;

__device__ __forceinline__ uint32_t amb_flags(uint32_t x) {
  return uvt::nz_bytes(x) & ~uvt::pure_bytes(x);
}

__device__ __forceinline__ uint32_t load_word(const uint8_t* m, int row,
                                              int rows, int A, int col) {
  if (row >= rows || col >= A) return 0;
  return *reinterpret_cast<const uint32_t*>(m + (long)row * A + col);
}

__global__ void __launch_bounds__(kThreads)
amb_corr_kernel(const uint8_t* __restrict__ r, const uint8_t* __restrict__ q,
                int B, int Q, int A, int32_t* __restrict__ corr_t,
                int32_t* __restrict__ corr_p) {
  __shared__ uint32_t r_amb[kSW][kBT], r_flag[kSW][kBT];
  __shared__ uint32_t q_amb[kSW][kQT];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.x * kBT, q0 = blockIdx.y * kQT;

  int acc_t[kRPT][kQPT] = {}, acc_p[kRPT][kQPT] = {};

  for (int s0 = 0; s0 < A; s0 += 4 * kSW) {
    for (int i = tid; i < kBT * kSW; i += kThreads) {
      int row = i / kSW, w = i % kSW;
      uint32_t x = load_word(r, b0 + row, B, A, s0 + 4 * w);
      uint32_t f = amb_flags(x);
      r_flag[w][row] = f;
      r_amb[w][row] = x & (f * 0x0Fu);
    }
    for (int i = tid; i < kQT * kSW; i += kThreads) {
      int row = i / kSW, w = i % kSW;
      uint32_t x = load_word(q, q0 + row, Q, A, s0 + 4 * w);
      q_amb[w][row] = x & (amb_flags(x) * 0x0Fu);
    }
    __syncthreads();

#pragma unroll
    for (int w = 0; w < kSW; ++w) {
      uint32_t ra[kRPT], rf[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        ra[i] = r_amb[w][ty + 16 * i];
        rf[i] = r_flag[w][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kQPT; ++j) {
        uint32_t qa = q_amb[w][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          // equal masked words at an ambiguous reference byte means the
          // query holds the same ambiguity code there
          acc_t[i][j] += __popc(uvt::eq_bytes(ra[i], qa) & rf[i]);
          uint32_t x = ra[i] & qa;   // non-zero only where both ambiguous
          acc_p[i][j] += __popc(uvt::nz_bytes(x)) - __popc(x);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    int b = b0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kQPT; ++j) {
      int qi = q0 + tx + 16 * j;
      if (b < B && qi < Q) {
        long o = (long)b * Q + qi;
        corr_t[o] = acc_t[i][j];
        corr_p[o] = acc_p[i][j];
      }
    }
  }
}

}  // namespace

// r: (B, A) uint8, q: (Q, A) uint8, A % 4 == 0; outputs corr_t and
// corr_p (B, Q) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int uvt_amb_corr(const void* r, const void* q, int B, int Q,
                            int A, void* corr_t, void* corr_p,
                            void* stream) {
  dim3 grid((B + kBT - 1) / kBT, (Q + kQT - 1) / kQT);
  amb_corr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r), static_cast<const uint8_t*>(q), B, Q,
      A, static_cast<int32_t*>(corr_t), static_cast<int32_t*>(corr_p));
  return static_cast<int>(cudaGetLastError());
}
