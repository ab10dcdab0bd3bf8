// Full-mode pair counters: the hand-written Hopper kernel that replaces
// uvaia_tpu/ops/pallas_score.py:_kernel_full (unpacked reference codes)
// and :_kernel_full_packed (4-bit packed reference codes); with the
// consensus counters compiled out (kCons = false) it replaces
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
// As the TPU kernel does, the three pair counters are int8 products of
// 0/1 feature planes: aa over the four pure one-hot planes ([code ==
// 1 << k]), mm over the four mask-bit planes, vv over the non-zero plane
// — nine wgmma.m64n64k32 s8 tensor-core products per 32 sites
// (mma_counts.cuh).  The TPU's three synthetic query rows for the
// consensus counters and its packed-layout site permutation are gone:
// the consensus counters are SWAR masks on the staged words, and a
// packed byte unpacks straight into natural site order.
//
// What bounds it on the H100: int8 tensor-core work, 2 * B * Q * 9W
// operations (1.45e11 at B=4096, Q=64, W=30720: 0.073 ms at the dense
// int8 peak of 1,979 TOP/s), against a reference read of B * W bytes
// (126 MB, 0.038 ms at 3.35 TB/s).  The SWAR AND+POPC version this
// replaces ran on the CUDA cores at ~2.3% of that bound, limited by each
// chunk's unoverlapped staging loads and barriers.  Here a ring of
// cp.async stages keeps three chunks' loads in flight, the query planes
// are built once per CTA and read by the tensor cores from shared
// memory, each reference plane's A fragment is built once per warp in
// registers, the next chunk is converted while the products run, and
// the site loop is split across CTAs when the tiles alone would leave
// SMs idle (Q <= 64: 32 tiles for 132 SMs).  What is left is integer
// work on the CUDA cores (the reference decode, the query planes and
// the consensus masks) at one 8-warp CTA an SM (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_counts.cuh"

using uvt::mma::FullMode;

// r: (B, rw) uint8 — unpacked codes (rw == W) or packed bytes
// (packed != 0, 2 * rw >= number of real sites); q: (Q, W) uint8;
// cons: (W,) uint8; W % 64 == 0.  Outputs aa/mm/vv (B, Q) int32 and
// cons5 (B, 5) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int uvt_score_counters(const void* r, long rw, int packed,
                                  const void* q, const void* cons, int B,
                                  int Q, int W, void* aa, void* mm, void* vv,
                                  void* cons5, void* stream) {
  int32_t* outs[3] = {static_cast<int32_t*>(aa), static_cast<int32_t*>(mm),
                      static_cast<int32_t*>(vv)};
  auto r8 = static_cast<const uint8_t*>(r);
  auto q8 = static_cast<const uint8_t*>(q);
  auto c8 = static_cast<const uint8_t*>(cons);
  auto c5 = static_cast<int32_t*>(cons5);
  auto s = static_cast<cudaStream_t>(stream);
  if (packed)
    return uvt::mma::launch<FullMode, true, true>(r8, rw, q8, nullptr, c8, B,
                                                  Q, W, outs, c5, s);
  return uvt::mma::launch<FullMode, false, true>(r8, rw, q8, nullptr, c8, B,
                                                 Q, W, outs, c5, s);
}

// The pair counters alone (pallas_score.py:_kernel, no consensus):
// r: (B, S) uint8 codes; q: (Q, S) uint8; S % 64 == 0.  Outputs aa/mm/vv
// (B, Q) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int uvt_pair_counters(const void* r, const void* q, int B, int Q,
                                 int S, void* aa, void* mm, void* vv,
                                 void* stream) {
  int32_t* outs[3] = {static_cast<int32_t*>(aa), static_cast<int32_t*>(mm),
                      static_cast<int32_t*>(vv)};
  return uvt::mma::launch<FullMode, false, false>(
      static_cast<const uint8_t*>(r), S, static_cast<const uint8_t*>(q),
      nullptr, nullptr, B, Q, S, outs, nullptr,
      static_cast<cudaStream_t>(stream));
}
