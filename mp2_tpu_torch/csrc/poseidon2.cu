// Poseidon2 permutation over Goldilocks, width 12, x^7 S-box, batched.
//
// Replaces the TPU kernel mp2_tpu/ops/poseidon2_pallas.py::_kernel (with its
// _external and _internal layers).  The same permutation as
// mp2_tpu/hash/poseidon2_host.py::permute, bit for bit:
//   state <- M_E(state)
//   4 full rounds:     state <- M_E((state + rc)^7)
//   22 partial rounds: state[0] <- (state[0] + rc)^7; state <- M_I(state)
//   4 full rounds:     state <- M_E((state + rc)^7)
// with M_E = circ(2*M4, M4, M4) and M_I = 1 + diag(mu - 1).
//
// What bounds it on Hopper: 64-bit integer multiplies.  A permutation runs
// 8*12 + 22 = 118 S-boxes of 4 products each, plus 22*12 products by the
// internal diagonal: ~736 64x64 -> 128 products, each a `mul.lo` and a
// `mul.hi` on 64-bit operands that the SMs emulate on the 32-bit multiplier.
// Its memory traffic is 12 * 8 bytes in and out, so it is far from the
// bandwidth bound.
//
// Design: one thread per permutation, the 12 state words in registers, all
// 30 rounds unrolled, the round constants and mu - 1 in __constant__ memory
// (every thread of a warp reads the same word, which constant memory
// broadcasts).  The Pallas kernel's (8, 128) batch folding, u32 limb planes
// and fori_loop are TPU layout choices and are not carried over.  Input and
// output are the planar (12, n) layout of `permute_lanes`: thread b reads
// plane i at offset b, so each warp's loads and stores are coalesced.
// Inputs may be any u64 bit patterns (they are reduced mod p on load);
// outputs are canonical.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"
// Generated at build time from mp2_tpu_torch/hash/constants.py:
//   P2_EXT_RC[8][12], P2_INT_RC[22], P2_DIAG_M1[12] (all canonical).
#include "poseidon2_tables.h"

namespace {

constexpr int WIDTH = 12;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 22;

__constant__ uint64_t c_ext_rc[ROUNDS_F][WIDTH] = P2_EXT_RC;
__constant__ uint64_t c_int_rc[ROUNDS_P] = P2_INT_RC;
__constant__ uint64_t c_diag_m1[WIDTH] = P2_DIAG_M1;

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by its add chain
// (mp2_tpu/hash/poseidon2.py:_external_linear).
__device__ __forceinline__ void m4(uint64_t& c0, uint64_t& c1, uint64_t& c2,
                                   uint64_t& c3) {
  using namespace gl;
  uint64_t t0 = add(c0, c1);
  uint64_t t1 = add(c2, c3);
  uint64_t t2 = add(dbl(c1), t1);
  uint64_t t3 = add(dbl(c3), t0);
  uint64_t t4 = add(dbl(dbl(t1)), t3);
  uint64_t t5 = add(dbl(dbl(t0)), t2);
  c0 = add(t3, t5);
  c1 = t5;
  c2 = add(t2, t4);
  c3 = t4;
}

__device__ __forceinline__ void external_linear(uint64_t s[WIDTH]) {
  m4(s[0], s[1], s[2], s[3]);
  m4(s[4], s[5], s[6], s[7]);
  m4(s[8], s[9], s[10], s[11]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t total = gl::add(gl::add(s[i], s[4 + i]), s[8 + i]);
    s[i] = gl::add(s[i], total);
    s[4 + i] = gl::add(s[4 + i], total);
    s[8 + i] = gl::add(s[8 + i], total);
  }
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl::exp7(gl::add(s[i], c_ext_rc[r][i]));
  external_linear(s);
}

__device__ __forceinline__ void partial_round(uint64_t s[WIDTH], int r) {
  s[0] = gl::exp7(gl::add(s[0], c_int_rc[r]));
  uint64_t sum = s[0];
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) sum = gl::add(sum, s[i]);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl::add(sum, gl::mul(s[i], c_diag_m1[i]));
}

__global__ void __launch_bounds__(128)
poseidon2_planar_kernel(const uint64_t* __restrict__ in,
                        uint64_t* __restrict__ out, long long n) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl::canon(in[(long long)i * n + b]);
  external_linear(s);
#pragma unroll
  for (int r = 0; r < ROUNDS_F / 2; ++r) full_round(s, r);
#pragma unroll
  for (int r = 0; r < ROUNDS_P; ++r) partial_round(s, r);
#pragma unroll
  for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) full_round(s, r);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) out[(long long)i * n + b] = s[i];
}

}  // namespace

// in, out: (12, n) planar u64, contiguous, on the current device.  Launches
// on `stream` and does not synchronise.  Returns cudaGetLastError().
extern "C" int mp2_poseidon2_permute_planar(const void* in, void* out,
                                            long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  poseidon2_planar_kernel<<<(unsigned int)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}
