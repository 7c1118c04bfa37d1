// Lazy radix-4 DIT stages over rows held in shared memory: the device code
// that K2 (csrc/ntt.cu, one row per block) and K2c (csrc/ntt_t.cu, a tile of
// matrix columns per block) share.
//
// A block calls dit_stages after it has loaded each row in bit-reversed
// order; on return (after a barrier) each row holds its transform in natural
// order, as lazy values: any u64 congruent to the result mod p, which the
// caller's epilogue canonicalises once.  Stage s (1-based) has half-width
// h = 2^(s-1) and twiddles w_{2^s}^j, j < h.
//
// What the design does about the cost of a stage (integer issue, not
// bytes, on Hopper; the P1 probe, csrc/probe_ops.cu, gives the costs):
//  * lazy butterflies: add_lazy / sub_lazy and a product without its
//    canonicalisation (goldilocks.cuh); the caller canonicalises once;
//  * two stages per pass (radix 4): a thread takes the four values of one
//    4h-group slot, runs stages s and s+1 in registers, and writes them
//    back, so each value goes through shared memory and a barrier once per
//    two stages; an odd first stage runs alone;
//  * the twiddles of stages 1 and 2 are 1 and w_4: three of their four
//    products per slot are skipped.
// Every other product takes its twiddle from one table of n - 1 values
// (stage s at offset h - 1, mp2_tpu_torch/ops/ntt_cuda.py::_stage_table),
// cached in L1.  The TPU kernel multiplied the stages of length <= 64 by
// shifts instead (their twiddles are powers of 2).  On the H100 a shift-
// multiply costs more than a product, even with the exponent shared by a
// warp, as K2c's interleaved layout shares it: ~35 integer instructions by
// branches (gl::mul_pow2_uniform_lazy), ~38 by selects, against ~19 for
// gl::mul_lazy (the P1 probe on an NVIDIA H100 80GB HBM3, 700 W), and K2c
// with shift stages 1-6 is slower at every shape the prover runs
// (tools/k2c_shift_stages.py; PERF.md gives the times).

#pragma once

#include <stdint.h>

#include "goldilocks.cuh"

namespace ntt {

// i reversed in log_n bits (log_n <= 31)
__device__ __forceinline__ int bitrev(int i, int log_n) {
  return log_n == 0 ? i : (int)(__brev((unsigned)i) >> (32 - log_n));
}

// x * w_{2^s}^j, lazy
__device__ __forceinline__ uint64_t twiddle(uint64_t x, int s, int j,
                                            const uint64_t* __restrict__ stage_tw) {
  return gl::mul_lazy(x, stage_tw[(1 << (s - 1)) - 1 + j]);
}

// (a + t, a - t)
__device__ __forceinline__ void butterfly(uint64_t a, uint64_t t, uint64_t& u,
                                          uint64_t& v) {
  u = gl::add_lazy(a, t);
  v = gl::sub_lazy(a, t);
}

// nrows rows of n = 2^log_n lazy values, row r at sh + r * stride (stride
// >= n: a padded stride keeps K2c's column accesses free of bank
// conflicts).  INTERLEAVE (K2c): nrows = 2^log_rows and neighbouring
// threads take neighbouring rows at the same position; otherwise (K2)
// neighbouring threads walk along a row.  Every thread of the block must
// call it.
template <bool INTERLEAVE>
__device__ __forceinline__ void dit_stages(uint64_t* sh, int nrows, int log_rows,
                                           int log_n, int stride,
                                           const uint64_t* __restrict__ stage_tw) {
  int s = 1;
  if (log_n & 1) {  // stage 1 alone: twiddle 1, no product
    const int half_n = 1 << (log_n - 1);
    const int total = nrows * half_n;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = INTERLEAVE ? (k & (nrows - 1)) : (k >> (log_n - 1));
      const int q = INTERLEAVE ? (k >> log_rows) : (k & (half_n - 1));
      const int i0 = r * stride + 2 * q;
      const uint64_t a = sh[i0], b = sh[i0 + 1];
      sh[i0] = gl::add_lazy(a, b);
      sh[i0 + 1] = gl::sub_lazy(a, b);
    }
    __syncthreads();
    s = 2;
  }
  if (log_n < 2) return;
  const int quarter = 1 << (log_n - 2);
  const int total = nrows * quarter;
  for (; s < log_n; s += 2) {
    const int h = 1 << (s - 1);
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = INTERLEAVE ? (k & (nrows - 1)) : (k >> (log_n - 2));
      const int q = INTERLEAVE ? (k >> log_rows) : (k & (quarter - 1));
      const int j = q & (h - 1);
      const int i0 = r * stride + ((q - j) << 2) + j;
      const uint64_t a0 = sh[i0], a1 = sh[i0 + h], a2 = sh[i0 + 2 * h],
                     a3 = sh[i0 + 3 * h];
      uint64_t t1 = a1, t3 = a3, b0, b1, b2, b3;
      // stage s: pairs (a0, a1) and (a2, a3) at distance h, twiddle w_{2h}^j
      // (1 in stage 1)
      if (s > 1) {
        t1 = twiddle(a1, s, j, stage_tw);
        t3 = twiddle(a3, s, j, stage_tw);
      }
      butterfly(a0, t1, b0, b1);
      butterfly(a2, t3, b2, b3);
      // stage s + 1: pairs (b0, b2) with w_{4h}^j and (b1, b3) with
      // w_{4h}^(j + h), at distance 2h (1 and w_4 in stage 2)
      const uint64_t u2 = s > 1 ? twiddle(b2, s + 1, j, stage_tw) : b2;
      const uint64_t u3 = twiddle(b3, s + 1, j + h, stage_tw);
      uint64_t c0, c1, c2, c3;
      butterfly(b0, u2, c0, c2);
      butterfly(b1, u3, c1, c3);
      sh[i0] = c0;
      sh[i0 + h] = c1;
      sh[i0 + 2 * h] = c2;
      sh[i0 + 3 * h] = c3;
    }
    __syncthreads();
  }
}

}  // namespace ntt
