// --acgt pair counters: the hand-written Hopper kernel that replaces
// uvaia_tpu/ops/pallas_score.py:_kernel_acgt_main + :_kernel_acgt_poly
// (unpacked reference codes) and :_kernel_acgt_main_packed +
// :_kernel_acgt_poly_packed (4-bit packed reference codes).
//
// For every (reference b, query q) over the sites s < W:
//   pp[b, q]  = sum_s [r pure][q pure]          (pure pairs, q = q_full)
//   aa[b, q]  = sum_s [r == q, r pure]          (ACGT matches, q_full)
//   ppp[b, q] = sum_s [r pure][p pure]          (the same two against
//   aap[b, q] = sum_s [r == p, r pure]           p = q_poly)
// and for every reference b, against the consensus c:
//   cons5[b] = (mm_c, va_c, 0, 0, valid_sites)
//     va_c        = sum_s [r pure][c pure]
//     mm_c        = sum_s [r pure][c pure][r != c]
//     valid_sites = sum_s [r != 0]
// c is 0 outside the consensus sites, so it is pure only there.
//
// The TPU ran two pallas_calls (main and poly; a single kernel with all
// outputs faulted the TPU worker at large query grids), each rebuilding
// the reference features and running five int8 MXU dots per operand,
// and permuted the query operands to match its packed unpack order.
// Here one CTA writes all four (B, Q) outputs and the consensus triple
// from one staging of the reference words, each counter is one AND and
// one popcount per 32-bit word of four codes (swar.cuh), and a packed
// byte unpacks straight into natural site order (load_ref_word), so no
// permutation is carried over.
//
// q_poly is staged as a second (Q, W) operand, not as a per-site mask
// on q_full: the two give the same counts only when q_poly is q_full
// restricted to a site set, which the wrapper could check only with a
// (Q, W) pass of its own, and the operand is read from L2 (2 MB at
// Q = 64), not from device memory, by every CTA row.  The staged words
// are the same either way (pure-only and pure-flag words of each
// operand), so the inner loop does not change.
//
// What bounds it on the H100: integer ALU work, 4 AND+POPC+ADD triples
// per (reference, query, word) — 8.1e9 at B=4096, Q=64, W=30720, 4/3 of
// the full-mode kernel's — against a reference read of B * W bytes
// (126 MB, 38 us at 3.35 TB/s).  A CTA stages a 32-reference x
// 64-query tile of 64 sites in shared memory (rows padded by one word,
// so the staging stores do not collide on a bank), with the derived
// words computed once at staging so the inner loop is AND/POPC/ADD only,
// and every thread accumulates 2 x 4 pairs of each counter in registers.
// The consensus counters come from the blockIdx.y == 0 CTAs.

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

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
acgt_counters_kernel(const uint8_t* __restrict__ r, long rw,
                     const uint8_t* __restrict__ q,
                     const uint8_t* __restrict__ p,
                     const uint8_t* __restrict__ cons, int B, int Q, int W,
                     int32_t* __restrict__ pp, int32_t* __restrict__ aa,
                     int32_t* __restrict__ ppp, int32_t* __restrict__ aap,
                     int32_t* __restrict__ cons5) {
  // *_po: pure-only words (codes of pure bytes, 0 elsewhere);
  // *_pb: pure flags (0x01 per pure byte)
  __shared__ uint32_t r_raw[kSW][kBT + 1], r_po[kSW][kBT + 1],
      r_pb[kSW][kBT + 1];
  __shared__ uint32_t q_po[kSW][kQT + 1], q_pb[kSW][kQT + 1];
  __shared__ uint32_t p_po[kSW][kQT + 1], p_pb[kSW][kQT + 1];
  __shared__ uint32_t c_raw[kSW];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.x * kBT, q0 = blockIdx.y * kQT;
  const bool do_cons = blockIdx.y == 0;

  int acc_pp[kRPT][kQPT] = {}, acc_aa[kRPT][kQPT] = {},
      acc_ppp[kRPT][kQPT] = {}, acc_aap[kRPT][kQPT] = {};
  int c_mm[kRPT] = {}, c_va[kRPT] = {}, c_sites[kRPT] = {};

  for (int s0 = 0; s0 < W; s0 += 4 * kSW) {
    for (int i = tid; i < kBT * kSW; i += kThreads) {
      int row = i / kSW, w = i % kSW;
      uint32_t x =
          uvt::load_ref_word<kPacked>(r, rw, b0 + row, B, s0 + 4 * w);
      uint32_t xb = uvt::pure_bytes(x);
      r_raw[w][row] = x;
      r_pb[w][row] = xb;
      r_po[w][row] = x & (xb * 0x0Fu);
    }
    for (int i = tid; i < kQT * kSW; i += kThreads) {
      int row = i / kSW, w = i % kSW;
      uint32_t x = 0, y = 0;
      if (q0 + row < Q) {
        long o = (long)(q0 + row) * W + s0 + 4 * w;
        x = *reinterpret_cast<const uint32_t*>(q + o);
        y = *reinterpret_cast<const uint32_t*>(p + o);
      }
      uint32_t xb = uvt::pure_bytes(x), yb = uvt::pure_bytes(y);
      q_pb[w][row] = xb;
      q_po[w][row] = x & (xb * 0x0Fu);
      p_pb[w][row] = yb;
      p_po[w][row] = y & (yb * 0x0Fu);
    }
    if (do_cons && tid < kSW)
      c_raw[tid] = *reinterpret_cast<const uint32_t*>(cons + s0 + 4 * tid);
    __syncthreads();

#pragma unroll
    for (int w = 0; w < kSW; ++w) {
      uint32_t ro[kRPT], rb[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        ro[i] = r_po[w][ty + 16 * i];
        rb[i] = r_pb[w][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kQPT; ++j) {
        uint32_t qo = q_po[w][tx + 16 * j], qb = q_pb[w][tx + 16 * j];
        uint32_t po = p_po[w][tx + 16 * j], pb = p_pb[w][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          acc_pp[i][j] += __popc(rb[i] & qb);
          acc_aa[i][j] += __popc(ro[i] & qo);
          acc_ppp[i][j] += __popc(rb[i] & pb);
          acc_aap[i][j] += __popc(ro[i] & po);
        }
      }
    }

    if (do_cons) {
      // thread (tx, ty) takes word tx of its references
      uint32_t c = c_raw[tx];
      uint32_t cb = uvt::pure_bytes(c);
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        uint32_t x = r_raw[tx][ty + 16 * i];
        uint32_t both = r_pb[tx][ty + 16 * i] & cb;
        c_va[i] += __popc(both);
        c_mm[i] += __popc(both & ~uvt::eq_bytes(x, c));
        c_sites[i] += __popc(uvt::nz_bytes(x));
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
        pp[o] = acc_pp[i][j];
        aa[o] = acc_aa[i][j];
        ppp[o] = acc_ppp[i][j];
        aap[o] = acc_aap[i][j];
      }
    }
  }
  if (do_cons) {
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      int v0 = uvt::sum16(c_mm[i]), v1 = uvt::sum16(c_va[i]),
          v4 = uvt::sum16(c_sites[i]);
      int b = b0 + ty + 16 * i;
      if (tx == 0 && b < B) {
        int32_t* o = cons5 + (long)b * 5;
        o[0] = v0; o[1] = v1; o[2] = 0; o[3] = 0; o[4] = v4;
      }
    }
  }
}

}  // namespace

// r: (B, rw) uint8 — unpacked codes (rw == W) or packed bytes
// (packed != 0, 2 * rw >= number of real sites); q, p: (Q, W) uint8
// (q_full, q_poly); cons: (W,) uint8; W % 64 == 0.  Outputs pp/aa/ppp/aap
// (B, Q) int32 and cons5 (B, 5) int32.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int uvt_acgt_counters(const void* r, long rw, int packed,
                                 const void* q, const void* p,
                                 const void* cons, int B, int Q, int W,
                                 void* pp, void* aa, void* ppp, void* aap,
                                 void* cons5, void* stream) {
  dim3 grid((B + kBT - 1) / kBT, (Q + kQT - 1) / kQT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* r8 = static_cast<const uint8_t*>(r);
  const uint8_t* q8 = static_cast<const uint8_t*>(q);
  const uint8_t* p8 = static_cast<const uint8_t*>(p);
  const uint8_t* c8 = static_cast<const uint8_t*>(cons);
  int32_t* o_pp = static_cast<int32_t*>(pp);
  int32_t* o_aa = static_cast<int32_t*>(aa);
  int32_t* o_ppp = static_cast<int32_t*>(ppp);
  int32_t* o_aap = static_cast<int32_t*>(aap);
  int32_t* o_c5 = static_cast<int32_t*>(cons5);
  if (packed)
    acgt_counters_kernel<true><<<grid, kThreads, 0, s>>>(
        r8, rw, q8, p8, c8, B, Q, W, o_pp, o_aa, o_ppp, o_aap, o_c5);
  else
    acgt_counters_kernel<false><<<grid, kThreads, 0, s>>>(
        r8, rw, q8, p8, c8, B, Q, W, o_pp, o_aa, o_ppp, o_aap, o_c5);
  return static_cast<int>(cudaGetLastError());
}
