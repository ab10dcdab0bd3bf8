// SWAR helpers over 32-bit words that hold four 4-bit IUPAC codes, one
// code (0..15) per byte.  Each helper returns 0x01 in every byte where
// its predicate holds and 0x00 elsewhere; because every byte is below
// 16, no shift below moves a bit across a byte boundary into bit 0 of
// the next byte, so the per-byte tests stay independent.
#pragma once
#include <cstdint>

namespace uvt {

constexpr uint32_t kLow = 0x01010101u;

// code != 0
__device__ __forceinline__ uint32_t nz_bytes(uint32_t x) {
  return (x | (x >> 1) | (x >> 2) | (x >> 3)) & kLow;
}

// popcount(code) == 1, i.e. a pure base A/C/G/T
__device__ __forceinline__ uint32_t pure_bytes(uint32_t x) {
  uint32_t s = (x & kLow) + ((x >> 1) & kLow) + ((x >> 2) & kLow) +
               ((x >> 3) & kLow);          // per-byte popcount, 0..4
  uint32_t t = s ^ kLow;                    // 0 exactly where s == 1; < 8
  return ~(t | (t >> 1) | (t >> 2)) & kLow;
}

// a == b, per byte
__device__ __forceinline__ uint32_t eq_bytes(uint32_t a, uint32_t b) {
  return ~nz_bytes(a ^ b) & kLow;
}

// the word with every non-pure byte cleared: popc(pure_only(r) &
// pure_only(q)) counts the sites where r and q are the same pure base
__device__ __forceinline__ uint32_t pure_only(uint32_t x) {
  return x & (pure_bytes(x) * 0x0Fu);
}

// Four codes at sites [site, site + 4) of reference row b (byte j of
// the word is site + j); rows past B read 0.  Unpacked rows are W bytes
// (site + 4 <= W); packed rows are rw bytes holding sites
// 0 .. 2*rw - 1, even site in the high nibble, and sites past the row
// read code 0 — so a packed byte unpacks straight into natural site
// order.
template <bool kPacked>
__device__ __forceinline__ uint32_t load_ref_word(const uint8_t* r, long rw,
                                                  int b, int B, int site) {
  if (b >= B) return 0;
  const uint8_t* row = r + (long)b * rw;
  if (!kPacked) return *reinterpret_cast<const uint32_t*>(row + site);
  long k = site >> 1;
  uint32_t b0 = k < rw ? row[k] : 0;
  uint32_t b1 = k + 1 < rw ? row[k + 1] : 0;
  return (b0 >> 4) | ((b0 & 15u) << 8) | ((b1 >> 4) << 16) |
         ((b1 & 15u) << 24);
}

// sum over the 16 lanes that share a threadIdx.x / 16 row of a warp
__device__ __forceinline__ int sum16(int v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace uvt
