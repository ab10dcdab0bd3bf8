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
// As the TPU kernel does (the derivation at pallas_score.py:210-221),
// both counters are int8 tensor-core products of feature planes, on the
// tile routine the counter kernels share (mma_counts.cuh: reference
// planes built in registers from the staged code words, query planes
// read by wgmma.m64n64k32 s8 from shared memory, a cp.async ring, site
// splits when the tiles alone leave SMs idle).  The TPU's 22 dots took
// 11 one-hot query planes and 11 planes of weights in -3..0.  Here the
// 22 products (CorrMode) need 16 query planes, each a few SWAR
// instructions a word — the 11 one-hot planes, the four mask bits on
// ambiguous codes and the ambiguous plane — because [(r & q) != 0] fails
// for two ambiguous codes only when they are complementary pairs of two
// bases: corr_p = [r amb][q amb] - sum_k [r amb, bit k][q amb, bit k]
// - sum_c [r == c][q == 15 - c].  The subtracted products carry their
// sign in the reference planes (bytes of -1), which live in registers.
// Exact on every pair of the 16 codes, not only on reachable ones.
//
// What bounds it on the H100: int8 tensor-core work, 2 * B * Q * 22 A
// operations (1.1 ms at B = 4096, Q = 1000, A = 12,000 at 1,979 TOP/s;
// microseconds at the A = 256 of a 64-query pack, where the launch
// dominates).  A need not be a multiple of the 64-site chunk: the copies
// zero-fill the tail (CorrMode::kRagged).

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_counts.cuh"

using uvt::mma::CorrMode;

// r: (B, A) uint8, q: (Q, A) uint8, A % 4 == 0; outputs corr_t and
// corr_p (B, Q) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int uvt_amb_corr(const void* r, const void* q, int B, int Q,
                            int A, void* corr_t, void* corr_p,
                            void* stream) {
  int32_t* outs[2] = {static_cast<int32_t*>(corr_t),
                      static_cast<int32_t*>(corr_p)};
  return uvt::mma::launch<CorrMode, false, false>(
      static_cast<const uint8_t*>(r), A, static_cast<const uint8_t*>(q),
      nullptr, nullptr, B, Q, A, outs, nullptr,
      static_cast<cudaStream_t>(stream));
}
