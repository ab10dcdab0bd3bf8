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
// the reference features, and permuted the query operands to match its
// packed unpack order.  Here one CTA writes all four (B, Q) outputs and
// the consensus triple: the five reference planes (pure, and the four
// pure one-hot planes [code == 1 << k]) are built once per fragment and
// multiplied against the same five planes of q_full and of q_poly — ten
// wgmma.m64n64k32 s8 tensor-core products per 32 sites (mma_counts.cuh)
// — and a packed byte unpacks straight into natural site order, so no
// permutation is carried over.  q_poly stays a second operand (not a
// site mask on q_full, which would hold only when q_poly is q_full
// restricted to a site set).
//
// What bounds it on the H100: int8 tensor-core work, 2 * B * Q * 10W
// operations (1.61e11 at B=4096, Q=64, W=30720: 0.081 ms at the dense
// int8 peak of 1,979 TOP/s), against a reference read of B * W bytes
// (126 MB, 0.038 ms at 3.35 TB/s).  The SWAR AND+POPC version this
// replaces ran on the CUDA cores at ~2.4% of that bound, limited by each
// chunk's unoverlapped staging loads and barriers; the design here is
// score.cu's (the shared tile routine), with two query operands staged.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_counts.cuh"

using uvt::mma::AcgtMode;

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
  int32_t* outs[4] = {static_cast<int32_t*>(pp), static_cast<int32_t*>(aa),
                      static_cast<int32_t*>(ppp),
                      static_cast<int32_t*>(aap)};
  auto r8 = static_cast<const uint8_t*>(r);
  auto q8 = static_cast<const uint8_t*>(q);
  auto p8 = static_cast<const uint8_t*>(p);
  auto c8 = static_cast<const uint8_t*>(cons);
  auto c5 = static_cast<int32_t*>(cons5);
  auto s = static_cast<cudaStream_t>(stream);
  if (packed)
    return uvt::mma::launch<AcgtMode, true, true>(r8, rw, q8, p8, c8, B, Q,
                                                  W, outs, c5, s);
  return uvt::mma::launch<AcgtMode, false, true>(r8, rw, q8, p8, c8, B, Q, W,
                                                 outs, c5, s);
}
