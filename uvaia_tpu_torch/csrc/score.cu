// Full-mode pair counters: the hand-written Hopper kernel that replaces
// uvaia_tpu/ops/pallas_score.py:_kernel_full (unpacked reference codes)
// and :_kernel_full_packed (4-bit packed reference codes); with the
// consensus epilogue compiled out (kCons = false) it replaces
// pallas_score.py:_kernel, the pair counters alone.
//
// For every (reference b, query q) over the sites s < W:
//   aa[b, q] = sum_s [r == q, r a pure base]   (ACGT matches)
//   mm[b, q] = sum_s popcount(r & q)           (mask-bit intersections)
//   vv[b, q] = sum_s [r != 0][q != 0]          (valid pairs)
// and for every reference b, against the consensus c:
//   cons5[b] = (acgt_c, text_c, part_c, valid_c, valid_sites)
//     acgt_c      = sum_s [r == c, c pure]
//     text_c      = sum_s [r == c, c != 0]
//     part_c      = sum_s [(r & c) != 0]
//     valid_c     = sum_s [r != 0][c != 0]
//     valid_sites = sum_s [r != 0]
//
// The TPU kernel decoded one-hot feature planes per tile and ran nine
// int8 MXU dots, plus three synthetic query rows for three of the
// consensus counters and a site permutation for the packed layout.
// Here each 32-bit word holds four codes and each counter is one AND
// and one popcount per word (see swar.cuh), so the synthetic rows and
// the permutation are gone: a packed byte unpacks straight into
// natural site order.
//
// What bounds it on the H100: integer ALU work, about
// 3 * B * Q * W / 4 AND+POPC+ADD triples (1.5e10 at B=4096, Q=64,
// W=30720), against a reference read of B * W bytes (126 MB, 38 us at
// 3.35 TB/s).  A CTA stages a 32-reference x 64-query tile of 64 sites
// in shared memory, with the derived words (pure-only, non-zero)
// computed once at staging so the inner loop is AND/POPC/ADD only, and
// every thread accumulates 2 x 4 pairs in registers.  The consensus
// counters come from the blockIdx.y == 0 CTAs (kCons only).

#include <cstdint>
#include <cuda_runtime.h>

#include "swar.cuh"

namespace {

constexpr int kBT = 32;            // references per CTA
constexpr int kQT = 64;            // queries per CTA
constexpr int kSW = 16;            // 32-bit words per site chunk (64 sites)
constexpr int kThreads = 256;      // 16 query lanes x 16 reference lanes
constexpr int kRPT = kBT / 16;     // references per thread
constexpr int kQPT = kQT / 16;     // queries per thread

template <bool kPacked, bool kCons>
__global__ void __launch_bounds__(kThreads)
score_counters_kernel(const uint8_t* __restrict__ r, long rw,
                      const uint8_t* __restrict__ q,
                      const uint8_t* __restrict__ cons, int B, int Q,
                      int W, int32_t* __restrict__ aa,
                      int32_t* __restrict__ mm, int32_t* __restrict__ vv,
                      int32_t* __restrict__ cons5) {
  __shared__ uint32_t r_raw[kSW][kBT], r_pure[kSW][kBT], r_nz[kSW][kBT];
  __shared__ uint32_t q_raw[kSW][kQT], q_pure[kSW][kQT], q_nz[kSW][kQT];
  __shared__ uint32_t c_raw[kSW];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.x * kBT, q0 = blockIdx.y * kQT;
  const bool do_cons = kCons && blockIdx.y == 0;

  int acc_aa[kRPT][kQPT] = {}, acc_mm[kRPT][kQPT] = {},
      acc_vv[kRPT][kQPT] = {};
  int c_acgt[kRPT] = {}, c_text[kRPT] = {}, c_part[kRPT] = {},
      c_valid[kRPT] = {}, c_sites[kRPT] = {};

  for (int s0 = 0; s0 < W; s0 += 4 * kSW) {
    for (int i = tid; i < kBT * kSW; i += kThreads) {
      int row = i / kSW, w = i % kSW;
      uint32_t x =
          uvt::load_ref_word<kPacked>(r, rw, b0 + row, B, s0 + 4 * w);
      r_raw[w][row] = x;
      r_pure[w][row] = uvt::pure_only(x);
      r_nz[w][row] = uvt::nz_bytes(x);
    }
    for (int i = tid; i < kQT * kSW; i += kThreads) {
      int row = i / kSW, w = i % kSW;
      uint32_t x = 0;
      if (q0 + row < Q)
        x = *reinterpret_cast<const uint32_t*>(q + (long)(q0 + row) * W +
                                               s0 + 4 * w);
      q_raw[w][row] = x;
      q_pure[w][row] = uvt::pure_only(x);
      q_nz[w][row] = uvt::nz_bytes(x);
    }
    if (do_cons && tid < kSW)
      c_raw[tid] = *reinterpret_cast<const uint32_t*>(cons + s0 + 4 * tid);
    __syncthreads();

#pragma unroll
    for (int w = 0; w < kSW; ++w) {
      uint32_t rr[kRPT], rp[kRPT], rn[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        rr[i] = r_raw[w][ty + 16 * i];
        rp[i] = r_pure[w][ty + 16 * i];
        rn[i] = r_nz[w][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kQPT; ++j) {
        uint32_t qq = q_raw[w][tx + 16 * j];
        uint32_t qp = q_pure[w][tx + 16 * j];
        uint32_t qn = q_nz[w][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          acc_aa[i][j] += __popc(rp[i] & qp);
          acc_mm[i][j] += __popc(rr[i] & qq);
          acc_vv[i][j] += __popc(rn[i] & qn);
        }
      }
    }

    if (do_cons) {
      // thread (tx, ty) takes word tx of its references
      uint32_t c = c_raw[tx];
      uint32_t cn = uvt::nz_bytes(c), cp = uvt::pure_only(c);
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        uint32_t x = r_raw[tx][ty + 16 * i];
        uint32_t xn = r_nz[tx][ty + 16 * i];
        c_sites[i] += __popc(xn);
        c_valid[i] += __popc(xn & cn);
        c_part[i] += __popc(uvt::nz_bytes(x & c));
        c_text[i] += __popc(uvt::eq_bytes(x, c) & cn);
        c_acgt[i] += __popc(r_pure[tx][ty + 16 * i] & cp);
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
        aa[o] = acc_aa[i][j];
        mm[o] = acc_mm[i][j];
        vv[o] = acc_vv[i][j];
      }
    }
  }
  if (do_cons) {
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      int v0 = uvt::sum16(c_acgt[i]), v1 = uvt::sum16(c_text[i]),
          v2 = uvt::sum16(c_part[i]), v3 = uvt::sum16(c_valid[i]),
          v4 = uvt::sum16(c_sites[i]);
      int b = b0 + ty + 16 * i;
      if (tx == 0 && b < B) {
        int32_t* o = cons5 + (long)b * 5;
        o[0] = v0; o[1] = v1; o[2] = v2; o[3] = v3; o[4] = v4;
      }
    }
  }
}

}  // namespace

// r: (B, rw) uint8 — unpacked codes (rw == W) or packed bytes
// (packed != 0, 2 * rw >= number of real sites); q: (Q, W) uint8;
// cons: (W,) uint8; W % 64 == 0.  Outputs aa/mm/vv (B, Q) int32 and
// cons5 (B, 5) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int uvt_score_counters(const void* r, long rw, int packed,
                                  const void* q, const void* cons, int B,
                                  int Q, int W, void* aa, void* mm, void* vv,
                                  void* cons5, void* stream) {
  dim3 grid((B + kBT - 1) / kBT, (Q + kQT - 1) / kQT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* r8 = static_cast<const uint8_t*>(r);
  const uint8_t* q8 = static_cast<const uint8_t*>(q);
  const uint8_t* c8 = static_cast<const uint8_t*>(cons);
  int32_t* o_aa = static_cast<int32_t*>(aa);
  int32_t* o_mm = static_cast<int32_t*>(mm);
  int32_t* o_vv = static_cast<int32_t*>(vv);
  int32_t* o_c5 = static_cast<int32_t*>(cons5);
  if (packed)
    score_counters_kernel<true, true><<<grid, kThreads, 0, s>>>(
        r8, rw, q8, c8, B, Q, W, o_aa, o_mm, o_vv, o_c5);
  else
    score_counters_kernel<false, true><<<grid, kThreads, 0, s>>>(
        r8, rw, q8, c8, B, Q, W, o_aa, o_mm, o_vv, o_c5);
  return static_cast<int>(cudaGetLastError());
}

// The pair counters alone (pallas_score.py:_kernel, no consensus):
// r: (B, S) uint8 codes; q: (Q, S) uint8; S % 64 == 0.  Outputs aa/mm/vv
// (B, Q) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int uvt_pair_counters(const void* r, const void* q, int B, int Q,
                                 int S, void* aa, void* mm, void* vv,
                                 void* stream) {
  dim3 grid((B + kBT - 1) / kBT, (Q + kQT - 1) / kQT);
  score_counters_kernel<false, false>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(r), S, static_cast<const uint8_t*>(q),
          nullptr, B, Q, S, static_cast<int32_t*>(aa),
          static_cast<int32_t*>(mm), static_cast<int32_t*>(vv), nullptr);
  return static_cast<int>(cudaGetLastError());
}
