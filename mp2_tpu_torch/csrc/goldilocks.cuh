// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, as CUDA device functions.
//
// Replaces the in-kernel limb arithmetic of the TPU kernels
// (mp2_tpu/ops/gl_u32.py: add/sub/mul/canon and the lazy set).  The TPU's
// vector unit has no 64-bit integers, so the Pallas kernels carry (lo, hi)
// u32 planes; here every value is one native uint64_t, the 64x64 -> 128
// product is four 32-bit limb products (`a * b` plus `__umul64hi(a, b)` in
// the canonical set, a PTX mad chain in the lazy one), and reduction uses
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
//
// Two dialects.  The canonical functions (canon, add, sub, reduce128, mul)
// take and return values in [0, p).  The lazy functions (*_lazy,
// mul_pow2*) take ANY u64 and return a u64 congruent mod p, not necessarily
// below p: a kernel chains them and calls canon once per output word, as the
// TPU kernels' lazy set did (gl_u32.py:96-217).  Each states its ranges.
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

// ---------------------------------------------------------------------------
// Lazy dialect: in [0, 2^64), out [0, 2^64), congruent mod p.
//
// Written as PTX carry chains on 32-bit limbs: an add or sub sets the carry
// flag and `addc`/`subc` read it, where compiled C compares the sum with an
// operand and selects.  A fold by EPS * carry is a 32-bit mask (0 or
// 0xFFFFFFFF: EPS has no high limb): after a sub chain `subc.u32 m, 0, 0`
// is -borrow in one instruction; after an add chain the carry is read as
// `addc.u32 c, 0, 0` and negated (a `subc` reading an add's carry flag
// computes the opposite on sm_90a, so chains never mix the two).  The
// compare-and-select forms they replaced stay in the P1 probe
// (csrc/probe_ops.cu, the *_sel ops), which times both.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lo32(uint64_t x) { return (uint32_t)x; }
__device__ __forceinline__ uint32_t hi32(uint64_t x) { return (uint32_t)(x >> 32); }
__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
}

// a + b.  A carry out of 2^64 is worth EPS; a second carry leaves s < EPS,
// so the second fold cannot carry again.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  uint32_t s0, s1;
  asm("{\n\t.reg .u32 c, m;\n\t"
      "add.cc.u32 %0, %2, %4;\n\t"
      "addc.cc.u32 %1, %3, %5;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "sub.u32 m, 0, c;\n\t"       // EPS * carry
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "sub.u32 m, 0, c;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.u32 %1, %1, 0;\n\t}"
      : "=&r"(s0), "=&r"(s1)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return join(s0, s1);
}

// a + b with one fold, for b < 2^64 - EPS (then a carry leaves
// a + b - 2^64 < b, and the fold cannot carry again).
__device__ __forceinline__ uint64_t add_lazy_once(uint64_t a, uint64_t b) {
  uint32_t s0, s1;
  asm("{\n\t.reg .u32 c, m;\n\t"
      "add.cc.u32 %0, %2, %4;\n\t"
      "addc.cc.u32 %1, %3, %5;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "sub.u32 m, 0, c;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.u32 %1, %1, 0;\n\t}"
      : "=&r"(s0), "=&r"(s1)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return join(s0, s1);
}

// a - b.  A borrow of 2^64 is worth -EPS; a second borrow leaves
// d >= 2^64 - EPS, so the second fold cannot borrow again.
__device__ __forceinline__ uint64_t sub_lazy(uint64_t a, uint64_t b) {
  uint32_t d0, d1;
  asm("{\n\t.reg .u32 m;\n\t"
      "sub.cc.u32 %0, %2, %4;\n\t"
      "subc.cc.u32 %1, %3, %5;\n\t"
      "subc.u32 m, 0, 0;\n\t"      // EPS * borrow
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, 0;\n\t}"
      : "=&r"(d0), "=&r"(d1)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return join(d0, d1);
}

// h * EPS = h * 2^32 - h for h < 2^32: below 2^64 - 2^33 + 2.
__device__ __forceinline__ uint64_t mul_eps(uint64_t h) { return (h << 32) - h; }

// lo + hi * 2^64 for any lo, hi, by 2^64 = EPS and 2^96 = -1:
// lo - hi_hi (a borrow folds -EPS once: lo - hi_hi >= 2^64 - 2^32 after a
// borrow), then + hi_lo * EPS (a carry folds +EPS once: that term is below
// 2^64 - 2^33 + 2).
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t lo, uint64_t hi) {
  const uint32_t h0 = lo32(hi), h1 = hi32(hi);
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 c, m, e0, e1;\n\t"
      "sub.cc.u32 %0, %2, %5;\n\t"  // lo - h1
      "subc.cc.u32 %1, %3, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, 0;\n\t"
      "sub.cc.u32 e0, 0, %4;\n\t"   // h0 * EPS = (h0 << 32) - h0
      "subc.u32 e1, %4, 0;\n\t"
      "add.cc.u32 %0, %0, e0;\n\t"
      "addc.cc.u32 %1, %1, e1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "sub.u32 m, 0, c;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.u32 %1, %1, 0;\n\t}"
      : "=&r"(r0), "=&r"(r1)
      : "r"(lo32(lo)), "r"(hi32(lo)), "r"(h0), "r"(h1));
  return join(r0, r1);
}

// The 128-bit product a * b as (lo, hi): four 32x32 -> 64 limb products
// (mul.lo / mul.hi) summed by mad carry chains.
__device__ __forceinline__ void mul128(uint64_t a, uint64_t b, uint64_t& lo,
                                       uint64_t& hi) {
  const uint32_t a0 = lo32(a), a1 = hi32(a), b0 = lo32(b), b1 = hi32(b);
  uint32_t r0, r1, r2, r3;
  asm("mul.lo.u32 %0, %4, %6;\n\t"
      "mul.hi.u32 %1, %4, %6;\n\t"
      "mad.lo.cc.u32 %1, %4, %7, %1;\n\t"
      "madc.hi.u32 %2, %4, %7, 0;\n\t"
      "mad.lo.cc.u32 %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "madc.hi.u32 %3, %5, %7, 0;\n\t"
      "mad.lo.cc.u32 %2, %5, %7, %2;\n\t"
      "addc.u32 %3, %3, 0;"
      : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3)
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1));
  lo = join(r0, r1);
  hi = join(r2, r3);
}

// a * b for any a, b (the product is below 2^128).
__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  mul128(a, b, lo, hi);
  return reduce128_lazy(lo, hi);
}

// a * a with three 32x32 -> 64 limb products instead of four: the cross
// term lo*hi is formed once and doubled by a shift (gl_u32.sq_lazy).
__device__ __forceinline__ uint64_t sqr_lazy(uint64_t a) {
  const uint32_t al = (uint32_t)a, ah = (uint32_t)(a >> 32);
  const uint64_t ll = (uint64_t)al * al, lh = (uint64_t)al * ah,
                 hh = (uint64_t)ah * ah;
  const uint64_t lo = ll + (lh << 33);             // 2 * lh * 2^32, low bits
  const uint64_t hi = hh + (lh >> 31) + (lo < ll);  // its high bits and the carry
  return reduce128_lazy(lo, hi);
}

// x^7 for any x, lazy intermediates: 2 squarings, 2 products.
__device__ __forceinline__ uint64_t exp7_lazy(uint64_t x) {
  const uint64_t x2 = sqr_lazy(x);
  const uint64_t x3 = mul_lazy(x2, x);
  const uint64_t x4 = sqr_lazy(x2);
  return mul_lazy(x4, x3);
}

// x * 2^e for any x and e in [0, 96), by shifts: no multiply.  Above 63 the
// product first takes one factor 2^32 (its reduce has hi < 2^32), so the
// 128-bit shift below stays under 64.  Branch-free (selects).
__device__ __forceinline__ uint64_t mul_pow2_lt96(uint64_t x, uint32_t e) {
  const bool big = e >= 64;
  x = big ? reduce128_lazy(x << 32, x >> 32) : x;
  e = big ? e - 32 : e;
  return reduce128_lazy(x << e, (x >> 1) >> (63 - e));
}

// x * 2^e for any x and e in [0, 192): 2^96 = -1 (mod p), so e >= 96
// negates.  2 has order 192, and every root of unity of order <= 64 is a
// power of 2, so these are the twiddles of an NTT's first six stages.  On
// the H100 it costs about two products (the P1 probe), so the NTT stages
// multiply from tables instead.
__device__ __forceinline__ uint64_t mul_pow2_lazy(uint64_t x, uint32_t e) {
  const bool neg = e >= 96;
  const uint64_t r = mul_pow2_lt96(x, neg ? e - 96 : e);
  const uint64_t nr = sub_lazy(0, r);
  return neg ? nr : r;
}

// x * 2^e for any x and e in [0, 192), as mul_pow2_lazy but by branches
// where that takes selects: a warp whose threads share e runs one path of
// one or two reductions, as an NTT stage would whose twiddle is the same
// across the warp.  Still ~1.8 products on the H100 (the P1 probe's
// mul_pow2_uniform).
__device__ __forceinline__ uint64_t mul_pow2_uniform_lazy(uint64_t x, uint32_t e) {
  const bool neg = e >= 96;
  if (neg) e -= 96;
  if (e >= 64) {
    x = reduce128_lazy(x << 32, x >> 32);
    e -= 32;
  }
  if (e != 0) x = reduce128_lazy(x << e, x >> (64 - e));
  if (neg) x = sub_lazy(0, x);
  return x;
}

}  // namespace gl
