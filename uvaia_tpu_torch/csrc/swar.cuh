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

}  // namespace uvt
