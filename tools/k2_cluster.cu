// K2's 2^14-point rows on a cluster of two blocks: the variant that
// tools/k2_cluster.py times beside the shipped kernel (a block of 1024
// threads per row, csrc/ntt.cu).  Never on the prover's path.
//
// A 2^14 transform is X[k] = E[k] + w^k O[k], X[k + 2^13] = E[k] - w^k O[k]
// (w = w_{2^14}), E and O the 2^13-point transforms of the even and the odd
// samples.  Block rank r of a cluster runs the shipped 2^13 kernel's passes
// (512 threads, 16 values each, 68 KB of shared memory) on the samples
// x[2j + r]; rank 1 multiplies O[k] by w^k; both store their outputs in
// their own shared memory, the cluster syncs, and rank r reads E[j] and
// w^j O[j] (one of them through distributed shared memory) and writes
// X[j + r 2^13].  Each block syncs alone through its three exchanges, and
// two blocks of 512 fit an SM at 64 registers, so one block's barrier waits
// can hide behind the other's work, where the shipped kernel's one block of
// 1024 threads per SM idles at each barrier.
//
// Entry: an inverse or forward transform of R rows of 2^14 points with an
// optional scale, the function of mp2_ntt_rows at log_n = 14 without the
// other flags.

#include <cooperative_groups.h>

#include "ntt.cu"

namespace cg = cooperative_groups;

namespace {

// dft<LR, INV> with every butterfly a separate instantiation, so no loop is
// left to unroll: in this kernel the compiler left the shipped dft's stage
// loops rolled and its array in local memory (a 128-byte stack frame with
// dft<4> and dft<3>, 64 bytes with dft<3> alone), where the shipped
// kernel's identical calls are unrolled.
template <bool INV, int S, int K>
__device__ __forceinline__ void bfly_k(uint64_t* u) {
  constexpr int h = 1 << (S - 1);
  bfly_const<INV>(u[(K / h) * 2 * h + K % h], u[(K / h) * 2 * h + K % h + h], S, K % h);
}

template <int LR, bool INV, int S, int... K>
__device__ __forceinline__ void stage_k(uint64_t* u, std::integer_sequence<int, K...>) {
  (bfly_k<INV, S, K>(u), ...);
}

template <int LR, bool INV, int... S>
__device__ __forceinline__ void stages_k(uint64_t* u, std::integer_sequence<int, S...>) {
  (stage_k<LR, INV, S + 1>(u, std::make_integer_sequence<int, (1 << LR) / 2>{}), ...);
}

template <int LR, bool INV>
__device__ __forceinline__ void dft_k(uint64_t* v) {
  uint64_t u[1 << LR];
  scatter_rev<LR>(u, v);
  stages_k<LR, INV>(u, std::make_integer_sequence<int, LR>{});
#pragma unroll
  for (int i = 0; i < (1 << LR); ++i) v[i] = u[i];
}

// the shipped later_pass with dft_k in place of dft
template <int LOG_N, bool INV, int PASS>
__device__ __forceinline__ void later_pass_k(uint64_t (&v)[Shape<LOG_N>::V], uint64_t* sh,
                                             int t, const uint64_t* __restrict__ pass_tw) {
  using S = Shape<LOG_N>;
  constexpr int LP = radix_log(LOG_N, PASS - 1), RP = 1 << LP;
  constexpr int LNP = log_ns(LOG_N, PASS - 1);
  constexpr int LR = radix_log(LOG_N, PASS), R = 1 << LR;
  constexpr int LNS = log_ns(LOG_N, PASS), NS = 1 << LNS;
#pragma unroll
  for (int q = 0; q < S::V / RP; ++q) {
    const int g = t + q * S::TR;
    uint64_t* base = sh + pad(((g >> LNP) << (LNP + LP)) + (g & ((1 << LNP) - 1)));
#pragma unroll
    for (int r = 0; r < RP; ++r) base[pad(r << LNP)] = v[q * RP + r];
  }
  __syncthreads();
  const uint64_t* tw = pass_tw + tw_offset(LOG_N, PASS);
#pragma unroll
  for (int q = 0; q < S::V / R; ++q) {
    const uint64_t* base = sh + pad(t + q * S::TR);
#pragma unroll
    for (int r = 0; r < R; ++r) v[q * R + r] = base[pad(r * (S::N / R))];
  }
  __syncthreads();  // reads before the next writes
#pragma unroll
  for (int q = 0; q < S::V / R; ++q) {
    const uint64_t* w = tw + ((t + q * S::TR) & (NS - 1));
#pragma unroll
    for (int r = 1; r < R; ++r)
      v[q * R + r] = gl::mul_lazy(v[q * R + r], __ldg(w + ((r - 1) << LNS)));
    dft_k<LR, INV>(v + q * R);
  }
}

// MINB: the blocks per SM asked of ptxas (2 caps it at 64 registers)
template <bool INV, int MINB>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(512, MINB)
ntt14_cluster_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                     const uint64_t* __restrict__ pass_tw,
                     const uint64_t* __restrict__ comb_tw, uint64_t scale) {
  using S = Shape<13>;
  static_assert(S::TR == 512 && S::RPB == 1, "one half-row per block");
  extern __shared__ uint64_t sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long row = blockIdx.x >> 1;
  const int t = threadIdx.x;
  uint64_t v[S::V];

  const uint64_t* src = in + (row << 14) + rank;
#pragma unroll
  for (int r = 0; r < S::V; ++r) v[r] = src[2 * (t + r * S::TR)];
  dft_k<S::LOG_V, INV>(v);
  later_pass_k<13, INV, 1>(v, sh, t, pass_tw);
  later_pass_k<13, INV, 2>(v, sh, t, pass_tw);
  later_pass_k<13, INV, 3>(v, sh, t, pass_tw);

  // group g = t + q * 512 holds outputs g + r * 2^13 / R of the half
  constexpr int LR = radix_log(13, S::NP - 1), R = 1 << LR;
#pragma unroll
  for (int q = 0; q < S::V / R; ++q) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = t + q * S::TR + r * (S::N / R);
      uint64_t x = v[q * R + r];
      if (rank == 1) x = gl::mul_lazy(x, __ldg(comb_tw + k));
      sh[pad(k)] = x;
    }
  }
  cluster.sync();
  const uint64_t* e_sh = cluster.map_shared_rank(sh, 0);
  const uint64_t* o_sh = cluster.map_shared_rank(sh, 1);
  uint64_t* dst = out + (row << 14) + (rank << 13);
#pragma unroll
  for (int i = 0; i < S::V; ++i) {
    const int j = t + i * S::TR;
    const uint64_t e = e_sh[pad(j)], o = o_sh[pad(j)];
    uint64_t x = rank == 0 ? gl::add_lazy(e, o) : gl::sub_lazy(e, o);
    if (scale != 0) x = gl::mul_lazy(x, scale);
    dst[j] = gl::canon(x);
  }
  cluster.sync();  // the peer's reads of this block's shared memory
}

template <bool INV, int MINB>
int launch_cluster(const uint64_t* in, uint64_t* out, long long rows, const uint64_t* pass_tw,
                   const uint64_t* comb_tw, uint64_t scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<13>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      ntt14_cluster_kernel<INV, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (2 * rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ntt14_cluster_kernel<INV, MINB><<<(unsigned)(2 * rows), 512, smem, stream>>>(
      in, out, pass_tw, comb_tw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: (rows, 2^14) u64, contiguous, not overlapping.  pass_tw: K2's
// pass table for 2^13 points (ops/ntt_cuda.py::_pass_table(13, inverse)).
// comb_tw: w_{2^14}^k for k < 2^13 (inverted roots when inverse).  scale:
// 0 for none, else a canonical factor for every output.  min_blocks: 1 or 2.
extern "C" int mp2_ntt14_cluster(const void* in, void* out, long long rows,
                                 const void* pass_tw, const void* comb_tw,
                                 unsigned long long scale, int inverse, int min_blocks,
                                 void* stream) {
  if (rows <= 0) return 0;
  const uint64_t* a = (const uint64_t*)in;
  uint64_t* o = (uint64_t*)out;
  const uint64_t* tw = (const uint64_t*)pass_tw;
  const uint64_t* c = (const uint64_t*)comb_tw;
  cudaStream_t s = (cudaStream_t)stream;
  if (min_blocks == 2)
    return inverse ? launch_cluster<true, 2>(a, o, rows, tw, c, scale, s)
                   : launch_cluster<false, 2>(a, o, rows, tw, c, scale, s);
  return inverse ? launch_cluster<true, 1>(a, o, rows, tw, c, scale, s)
                 : launch_cluster<false, 1>(a, o, rows, tw, c, scale, s);
}
