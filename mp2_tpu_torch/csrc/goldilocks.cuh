// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, as CUDA device functions.
//
// Replaces the in-kernel limb arithmetic of the TPU kernels
// (mp2_tpu/ops/gl_u32.py: add/sub/mul/canon and the lazy set).  The TPU's
// vector unit has no 64-bit integers, so the Pallas kernels carry (lo, hi)
// u32 planes; here every value is one native uint64_t, the 64x64 -> 128
// product is `a * b` plus `__umul64hi(a, b)`, and reduction uses
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
//
// All functions take and return canonical values in [0, p).
#pragma once

#include <stdint.h>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

// Any u64 bit pattern -> [0, p): one subtraction suffices since 2^64 < 2p.
__device__ __forceinline__ uint64_t canon(uint64_t x) {
  return x >= P ? x - P : x;
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // a carry out of 2^64 is worth 2^64 = EPS; a + b - p < p, so no re-carry
  s += (s < a) ? EPS : 0;
  return canon(s);
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  // a borrow of 2^64 is worth -EPS (mod p): d = a - b + p, in [0, p)
  return (a < b) ? d - EPS : d;
}

__device__ __forceinline__ uint64_t dbl(uint64_t a) { return add(a, a); }

// lo + hi * 2^64 mod p.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_lo = hi & 0xFFFFFFFFull;
  uint64_t hi_hi = hi >> 32;
  uint64_t t0 = lo - hi_hi;            // + hi_hi * 2^96 = - hi_hi
  t0 -= (lo < hi_hi) ? EPS : 0;        // borrow: + 2^64 - EPS = + p
  uint64_t t1 = (hi_lo << 32) - hi_lo; // hi_lo * 2^64 = hi_lo * EPS
  uint64_t s = t0 + t1;
  s += (s < t1) ? EPS : 0;             // carry; cannot re-carry (t1 < 2^64 - 2^33 + 2)
  return canon(s);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t exp7(uint64_t x) {
  uint64_t x2 = mul(x, x);
  uint64_t x3 = mul(x2, x);
  uint64_t x4 = mul(x2, x2);
  return mul(x4, x3);
}

}  // namespace gl
