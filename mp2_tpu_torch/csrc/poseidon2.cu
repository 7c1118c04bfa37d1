// Poseidon2 permutation over Goldilocks, width 12, x^7 S-box, batched; and
// the two Merkle entries built on it (leaf hashing, tree levels).
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
// What bounds it on Hopper: integer instruction issue.  A permutation runs
// 8*12 + 22 = 118 S-boxes (2 squares of 3 limb products, 2 products of 4)
// plus 22*12 products by the internal diagonal, each 64x64 -> 128 product
// several 32-bit IMADs, and ~1100 additions in its linear layers.  Its
// memory traffic is 12 * 8 bytes in and out, far from the bandwidth bound.
// On Hopper a lazy add costs about what a canonical one does (the P1 probe,
// csrc/probe_ops.cu), so the design saves additions and reductions rather
// than canonicalisations: each linear-layer term is one add-with-carry pair
// into a wide sum reduced once per output, and no product is canonicalised.
// The rounds stay in loops: unrolled, the body outgrew the instruction
// cache, and ptxas did not finish it inside the sponge's loop.
//
// Compiled (nvcc 12.9 for sm_90a, -Xptxas -v; chip_smoke.py prints both):
// 56 registers for the permutation and leaf-hash kernels, 64 and 8 KB of
// shared memory for the levels kernel, no spills; SASS (cuobjdump, static)
// 4,856 instructions with 968 integer multiplies for the permutation
// kernel, 5,120 (990) for the leaf hash, 4,680 (948) for the levels.
//
// Design: one thread per permutation, the 12 state words in registers, each
// round unrolled over its lanes and the rounds in loops, the round
// constants and mu - 1 in __constant__ memory (every thread of a warp reads
// the same word, which constant memory broadcasts).  The arithmetic is lazy (goldilocks.cuh): state words are any
// u64 congruent to the field value, and each output word is canonicalised
// once.  The linear layers sum in a wide accumulator (a u64 and a carry
// word), so an add is one add-with-carry pair and a sum of up to 2^32 terms
// is reduced once; the internal layer adds its 12-lane sum to each 128-bit
// diagonal product before that product's one reduction; the S-box squares
// with three limb products (sqr_lazy).  The Pallas kernel's (8, 128) batch
// folding, u32 limb planes and fori_loop are TPU layout choices and are not
// carried over.
//
// Entries:
//   mp2_poseidon2_permute_planar: (12, n) planar states, thread b reads
//     plane i at offset b (coalesced); inputs any u64, outputs canonical.
//   mp2_poseidon2_hash_leaves: the Merkle leaf digests of a natural-order
//     LDE (B, C, m): thread (b, t) absorbs column t, 8 values at a time in
//     overwrite mode, its state in registers (ceil(C/8) permutations in one
//     launch, where the sponge over the permutation entry makes one launch
//     per absorption plus torch copies), and writes hash_or_noop of the leaf
//     to row rev(t) of (B, m, 4): the bit-reversed leaf order of the tree.
//     A warp reads 32 consecutive values of one LDE row.  C <= 4: the leaf
//     zero-padded to 4, no hashing (plonky2's hash_or_noop).
//   mp2_poseidon2_merkle_levels: k levels of two_to_one over (B, m, 4)
//     digests: a block takes 2^g consecutive digests of one batch element,
//     hashes the first level from device memory and the next k - 1 levels
//     from shared memory, and writes every level (the prover opens siblings
//     from all of them).  The wrapper makes one launch of up to 9 levels
//     and one more for the levels above, down to the cap.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"
// Generated at build time from mp2_tpu_torch/hash/constants.py:
//   P2_EXT_RC[8][12], P2_INT_RC[22], P2_DIAG_M1[12] (all canonical).
#include "poseidon2_tables.h"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 22;
constexpr int PERM_THREADS = 128;
constexpr int LEVEL_THREADS = 256;  // a block hashes up to 9 levels
constexpr int MAX_LOG_GROUP = 9;    // 2^9 digests in, 2^8 threads

__constant__ uint64_t c_ext_rc[ROUNDS_F][WIDTH] = P2_EXT_RC;
__constant__ uint64_t c_int_rc[ROUNDS_P] = P2_INT_RC;
__constant__ uint64_t c_diag_m1[WIDTH] = P2_DIAG_M1;

// A wide accumulator: lo + hi * 2^64, hi a small carry count.  Inputs of
// the linear layers are any u64; their sums stay below 2^72 here.
struct Wide {
  uint64_t lo;
  uint32_t hi;
};

__device__ __forceinline__ Wide wide(uint64_t x) { return Wide{x, 0u}; }

__device__ __forceinline__ Wide operator+(Wide a, Wide b) {
  const uint64_t lo = a.lo + b.lo;
  return Wide{lo, a.hi + b.hi + (lo < a.lo ? 1u : 0u)};
}

__device__ __forceinline__ Wide dbl(Wide a) {
  return Wide{a.lo << 1, (a.hi << 1) | (uint32_t)(a.lo >> 63)};
}

// lo + hi * EPS (2^64 = EPS mod p), hi < 2^32: lazy out.
__device__ __forceinline__ uint64_t reduce(Wide a) {
  const uint64_t t = ((uint64_t)a.hi << 32) - a.hi;
  const uint64_t s = a.lo + t;
  return s + ((s < t) ? gl::EPS : 0);  // t < 2^64 - 2^33 + 2: no re-carry
}

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by its add chain
// (mp2_tpu/hash/poseidon2.py:_external_linear), on wide values: inputs
// below 2^64 give outputs below 16 * 2^64.
__device__ __forceinline__ void m4(Wide& c0, Wide& c1, Wide& c2, Wide& c3) {
  const Wide t0 = c0 + c1;
  const Wide t1 = c2 + c3;
  const Wide t2 = dbl(c1) + t1;
  const Wide t3 = dbl(c3) + t0;
  const Wide t4 = dbl(dbl(t1)) + t3;
  const Wide t5 = dbl(dbl(t0)) + t2;
  c0 = t3 + t5;
  c1 = t5;
  c2 = t2 + t4;
  c3 = t4;
}

// M_E on lazy words: each output is below 16 * 2^64 * 4 before its one
// reduction.
__device__ __forceinline__ void external_linear(uint64_t s[WIDTH]) {
  Wide w[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) w[i] = wide(s[i]);
  m4(w[0], w[1], w[2], w[3]);
  m4(w[4], w[5], w[6], w[7]);
  m4(w[8], w[9], w[10], w[11]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Wide total = w[i] + w[4 + i] + w[8 + i];
    s[i] = reduce(w[i] + total);
    s[4 + i] = reduce(w[4 + i] + total);
    s[8 + i] = reduce(w[8 + i] + total);
  }
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i)
    s[i] = gl::exp7_lazy(gl::add_lazy(s[i], c_ext_rc[r][i]));
  external_linear(s);
}

// M_I: s_i <- s_i * (mu_i - 1) + sum_j s_j.  The sum (below 12 * 2^64) is
// added to each 128-bit product, which stays below 2^128 since mu_i - 1 < p,
// and the total is reduced once.
__device__ __forceinline__ void partial_round(uint64_t s[WIDTH], int r) {
  s[0] = gl::exp7_lazy(gl::add_lazy(s[0], c_int_rc[r]));
  Wide sum = wide(s[0]);
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) sum = sum + wide(s[i]);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    uint64_t lo, hi;
    gl::mul128(s[i], c_diag_m1[i], lo, hi);
    const uint64_t lo2 = lo + sum.lo;
    s[i] = gl::reduce128_lazy(lo2, hi + sum.hi + (lo2 < lo ? 1 : 0));
  }
}

// The permutation on lazy words: any u64 in, lazy out (callers canon).
// The round loops stay rolled: a round's 12 lanes give the scheduler its
// parallelism, while the whole permutation unrolled ran slower, its code far
// beyond the instruction caches, and ptxas did not finish building it
// inside the sponge's absorption loop.
__device__ __forceinline__ void permute(uint64_t s[WIDTH]) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_F / 2; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_P; ++r) partial_round(s, r);
#pragma unroll 1
  for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) full_round(s, r);
}

__device__ __forceinline__ int bitrev(int i, int log_n) {
  return log_n == 0 ? i : (int)(__brev((unsigned)i) >> (32 - log_n));
}

__global__ void __launch_bounds__(PERM_THREADS)
poseidon2_planar_kernel(const uint64_t* __restrict__ in,
                        uint64_t* __restrict__ out, long long n) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = in[(long long)i * n + b];
  permute(s);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) out[(long long)i * n + b] = gl::canon(s[i]);
}

// lde: (B, C, 2^log_m) natural order; out: (B, 2^log_m, 4), row rev(t).
__global__ void __launch_bounds__(PERM_THREADS)
hash_leaves_kernel(const uint64_t* __restrict__ lde, uint64_t* __restrict__ out,
                   long long batch, int cols, int log_m) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= batch << log_m) return;
  const long long m = 1LL << log_m;
  const long long b = g >> log_m;
  const int t = (int)(g & (m - 1));
  const uint64_t* src = lde + b * cols * m + t;
  uint64_t* dst = out + ((b << log_m) + bitrev(t, log_m)) * 4;
  if (cols <= 4) {  // hash_or_noop: the leaf itself, zero-padded
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = i < cols ? src[i * m] : 0;
    return;
  }
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0;
  for (int c0 = 0; c0 < cols; c0 += RATE) {
    const int k = cols - c0 < RATE ? cols - c0 : RATE;
#pragma unroll
    for (int i = 0; i < RATE; ++i)
      if (i < k) s[i] = src[(long long)(c0 + i) * m];
    permute(s);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = gl::canon(s[i]);
}

// two_to_one of digests (l, r): one absorption of 8 words into a zero state.
__device__ __forceinline__ void two_to_one(const uint64_t l[4],
                                           const uint64_t r[4], uint64_t o[4]) {
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = l[i];
    s[4 + i] = r[i];
    s[8 + i] = 0;
  }
  permute(s);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = gl::canon(s[i]);
}

// in: (B, 2^log_m, 4) digests; out: `levels` levels of (B, 2^(log_m - j), 4)
// digests, j = 1..levels, each level contiguous and directly after the one
// below.  A block takes 2^log_group consecutive digests of one batch
// element (log_group >= levels) with 2^(log_group - 1) threads.
__global__ void __launch_bounds__(LEVEL_THREADS)
merkle_levels_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                     long long batch, int log_m, int levels, int log_group) {
  __shared__ uint64_t sh[4][LEVEL_THREADS];  // one level's digests, word-major
  const int blocks_per_elem = 1 << (log_m - log_group);
  const long long b = blockIdx.x / blocks_per_elem;
  const long long d0 = (long long)(blockIdx.x % blocks_per_elem) << log_group;
  const int i = threadIdx.x;
  uint64_t* level = out;  // level j of all batch elements
  long long level_m = 1LL << log_m;
  for (int j = 1; j <= levels; ++j) {
    level_m >>= 1;
    const int active = 1 << (log_group - j);
    uint64_t l[4], r[4], o[4];
    if (i < active) {
      if (j == 1) {
        const uint64_t* src = in + ((b << log_m) + d0 + 2 * i) * 4;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          l[w] = src[w];
          r[w] = src[4 + w];
        }
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          l[w] = sh[w][2 * i];
          r[w] = sh[w][2 * i + 1];
        }
      }
      two_to_one(l, r, o);
      uint64_t* dst = level + (b * level_m + (d0 >> j) + i) * 4;
#pragma unroll
      for (int w = 0; w < 4; ++w) dst[w] = o[w];
    }
    __syncthreads();  // every read of this level's inputs is done
    if (i < active) {
#pragma unroll
      for (int w = 0; w < 4; ++w) sh[w][i] = o[w];
    }
    __syncthreads();
    level += batch * level_m * 4;
  }
}

}  // namespace

// in, out: (12, n) planar u64, contiguous, on the current device.  Launches
// on `stream` and does not synchronise.  Returns cudaGetLastError().
extern "C" int mp2_poseidon2_permute_planar(const void* in, void* out,
                                            long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + PERM_THREADS - 1) / PERM_THREADS;
  poseidon2_planar_kernel<<<(unsigned int)blocks, PERM_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

// lde: (batch, cols, 2^log_m) natural-order u64, contiguous; out: (batch,
// 2^log_m, 4), leaf t's digest at row rev(t).  Returns cudaGetLastError().
extern "C" int mp2_poseidon2_hash_leaves(const void* lde, void* out,
                                         long long batch, int cols, int log_m,
                                         void* stream) {
  if (batch <= 0) return 0;
  if (cols <= 0 || log_m < 0 || log_m > 30) return (int)cudaErrorInvalidValue;
  const long long n = batch << log_m;
  const long long blocks = (n + PERM_THREADS - 1) / PERM_THREADS;
  hash_leaves_kernel<<<(unsigned int)blocks, PERM_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const uint64_t*)lde, (uint64_t*)out, batch, cols, log_m);
  return (int)cudaGetLastError();
}

// in: (batch, 2^log_m, 4) digests, contiguous; out: room for `levels`
// levels, (batch, 2^(log_m - j), 4) for j = 1..levels, back to back.
// levels <= 9.  Returns cudaGetLastError().
extern "C" int mp2_poseidon2_merkle_levels(const void* in, void* out,
                                           long long batch, int log_m,
                                           int levels, void* stream) {
  if (batch <= 0 || levels == 0) return 0;
  if (levels < 0 || levels > MAX_LOG_GROUP || levels > log_m || log_m > 40)
    return (int)cudaErrorInvalidValue;
  // a group of at least 2^7 digests (64 threads) where the level allows
  int log_group = log_m < 7 ? log_m : 7;
  if (log_group < levels) log_group = levels;
  const long long blocks = batch << (log_m - log_group);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  merkle_levels_kernel<<<(unsigned int)blocks, 1 << (log_group - 1), 0,
                         (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, batch, log_m, levels, log_group);
  return (int)cudaGetLastError();
}
