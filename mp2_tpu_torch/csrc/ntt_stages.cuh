// Radix-2 DIT stages over rows held in shared memory: the device code that
// K2 (csrc/ntt.cu, one row per block) and K2c (csrc/ntt_t.cu, a tile of
// matrix columns per block) share.
//
// A block calls dit_stages after it has loaded each row in bit-reversed
// order; on return (after a barrier) each row holds its transform in natural
// order.  Stage s (1-based) has half-width h = 2^(s-1) and twiddles
// w_{2^s}^j, j < h, read from one table of n - 1 values at offset h - 1
// (mp2_tpu_torch/ops/ntt_cuda.py::_stage_table).

#pragma once

#include <stdint.h>

#include "goldilocks.cuh"

namespace ntt {

// i reversed in log_n bits (log_n <= 31)
__device__ __forceinline__ int bitrev(int i, int log_n) {
  return log_n == 0 ? i : (int)(__brev((unsigned)i) >> (32 - log_n));
}

// nrows rows of n = 2^log_n values, row r at sh + r * stride (stride >= n:
// a padded stride keeps the column accesses of K2c free of bank conflicts).
// Every thread of the block must call it.
__device__ __forceinline__ void dit_stages(uint64_t* sh, int nrows, int log_n,
                                           int stride,
                                           const uint64_t* __restrict__ stage_tw) {
  if (log_n == 0) return;
  const int half_n = 1 << (log_n - 1);
  const int total = nrows * half_n;  // butterflies per stage
  for (int s = 1; s <= log_n; ++s) {
    const int h = 1 << (s - 1);
    const uint64_t* tw = stage_tw + (h - 1);
    // butterfly k: row k / half_n, group kk / h of 2h slots, offset j
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k >> (log_n - 1);
      const int kk = k & (half_n - 1);
      const int j = kk & (h - 1);
      const int i0 = r * stride + ((kk - j) << 1) + j;
      const int i1 = i0 + h;
      const uint64_t a = sh[i0];
      const uint64_t t = gl::mul(sh[i1], tw[j]);
      sh[i0] = gl::add(a, t);
      sh[i1] = gl::sub(a, t);
    }
    __syncthreads();
  }
}

}  // namespace ntt
