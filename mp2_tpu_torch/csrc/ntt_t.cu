// K2c: one pass of the transpose-fused four-step NTT over Goldilocks.
//
// Replaces the TPU kernel mp2_tpu/ops/ntt_pallas.py::_make_fused_kernel_t
// (launched by _compiled_fused_t through ntt_four_step_fused_t): the
// four-step (Bailey) transform of (B, n) rows, n = n1 * n2 with
// n1 = 2^floor(log n / 2), in which the matrix transposes between and
// around the two butterfly passes happen inside the kernel, so no pass
// takes a strided copy through device memory.
//
// Each launch transforms the COLUMNS of B row-major (L, M) matrices
// (L = 2^log_l points per column, M = 2^log_m columns) and writes column c
// = ch * D + cl, point k, to (ch, k, cl) of an (M / D, L, D) matrix
// (D = 2^log_d): D = 1 writes the matrix transposed, D = M in place.
//   pass 1: x viewed as (B, n1, n2); columns of length n1, times the middle
//           twiddle w^(k1 * j2); written transposed, as (B, n2, n1) rows;
//   pass 2: that (B, n2, n1); columns of length n2, times n^-1 when inverse;
//           written back in place of the columns, so the flat output of a
//           row is y[k1 + n1 * k2], canonical.
// Above 2^20 points a column of pass 2 would pass 2^10 points, so the
// wrapper cuts n into three passes (n = n1 * n2 * n3, each <= 2^10): pass
// 2's columns of n2 * n3 points are themselves a four-step, whose first
// pass runs here with D = n1 (the finished k1 stays innermost) and its own
// middle twiddle w_{n2 n3}^(k2 * j3), a table indexed by (output offset) /
// D.  The wrapper (mp2_tpu_torch/ops/ntt_t_cuda.py::ntt_four_step_t) makes
// the launches; its plain twin ntt_four_step_plain is the same
// decomposition with K2's plain passes and torch transposes.
//
// Two more entries ride on the same passes (the wrapper's lde_t and
// coset_intt_t):
//   LDE: pass 1 reads only the n coefficients of each row of the
//        zero-padded N = n * 2^rate-point input: in the (N1, N2) view only
//        the first N1 / 2^rate matrix rows are non-zero.  It zero-fills the
//        rest in shared memory and multiplies coefficient j by shift^j as it
//        loads, so neither the padded tensor nor the coset product is made;
//   coset iNTT: pass 2 multiplies output j by n^-1 * shift^-j from a table
//        instead of by n^-1, so the iNTT and the coset product are one
//        transform.
//
// What bounds it on Hopper: integer issue.  A pass reads and writes each
// element once (16 B), which at 3.35 TB/s is the bound the byte count
// gives, but a stage costs ~30 integer instructions per element (a lazy
// add and sub ~10 each, a product ~20: the P1 probe), which the integer
// pipe retires more slowly.  So the design spends shared memory and
// threads on occupancy (several blocks per SM hide the barriers), skips
// the products by a unit twiddle, and reads an LDE's coefficients without
// their zero padding.
//
// Design: a block takes TILE adjacent columns of one matrix (TILE * L =
// 2^13 values: TILE = 32 at L = 2^8, 16 at 2^9, 8 at 2^10, or M when M is
// smaller), so each global load of a matrix row is TILE contiguous u64
// (256, 128 or 64 B), coalesced across a warp.  It stores the tile
// transposed into dynamic shared memory, one column per shared row at its
// bit-reversed slot, rows padded to L + 16 / TILE values so that the
// threads of a half-warp (neighbouring columns, see dit_stages) touch
// distinct banks.  The stages (dit_stages, below) are lazy, radix 4, the
// unit twiddles of stages 1-2 skipped.  64 KB of shared memory and 256
// threads per block let three blocks share an SM.  The epilogue applies the
// per-element table (middle twiddle, or n^-1 * shift^-j) or the scale,
// canonicalises, and stores either whole rows of L contiguous values
// (transposed) or the TILE-wide column segments again, coalesced.  The
// Pallas kernel's (n, TILE_R = 8) column slabs and u32 plane pairs are the
// TPU's layout (which Mosaic refused) and are not carried over.  TMA tile
// loads and register-resident sub-transforms are later work.
//
// Tensors are int64 bit patterns of u64 values; the kernel reads them as
// uint64_t; the stages take any u64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

// The stages: lazy radix-4 DIT over rows held in shared memory (a tile of
// matrix columns per block).
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

// nrows = 2^log_rows rows of n = 2^log_n lazy values, row r at sh + r *
// stride (stride >= n: a padded stride keeps the column accesses free of
// bank conflicts); neighbouring threads take neighbouring rows at the same
// position.  Every thread of the block must call it.
__device__ __forceinline__ void dit_stages(uint64_t* sh, int nrows, int log_rows,
                                           int log_n, int stride,
                                           const uint64_t* __restrict__ stage_tw) {
  int s = 1;
  if (log_n & 1) {  // stage 1 alone: twiddle 1, no product
    const int half_n = 1 << (log_n - 1);
    const int total = nrows * half_n;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k & (nrows - 1);
      const int q = k >> log_rows;
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
      const int r = k & (nrows - 1);
      const int q = k >> log_rows;
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

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS_PER_SM = 3;
constexpr int MAX_TILE = 32;
constexpr int MAX_TILE_ELEMS = 1 << 13;  // TILE * L, 64 KB of values
constexpr int MIN_TILE = 8;              // 64 B per row load
constexpr int MAX_LOG_L = 10;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
ntt_cols_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                int log_l, int log_m, int log_tile, int log_l_in,
                const uint64_t* __restrict__ pre,
                const uint64_t* __restrict__ stage_tw,
                const uint64_t* __restrict__ post, uint64_t scale,
                int log_d, int post_shift) {
  extern __shared__ uint64_t sh[];
  const int L = 1 << log_l;
  const int tile = 1 << log_tile;
  const int stride = L + (tile >= 16 ? 1 : 16 / tile);
  const int tiles_per_matrix = 1 << (log_m - log_tile);
  const long long matrix = blockIdx.x >> (log_m - log_tile);
  const int c0 = (blockIdx.x & (tiles_per_matrix - 1)) << log_tile;
  const uint64_t* src = in + (matrix << (log_l_in + log_m));
  uint64_t* dst = out + (matrix << (log_l + log_m));
  const int elems = tile << log_l;
  const int elems_in = tile << log_l_in;

  // load: element (l, c0 + c) to shared row c, slot rev(l); a warp reads
  // consecutive columns of one matrix row.  Rows l >= 2^log_l_in are zero;
  // `pre` (2^log_l_in x M) multiplies each loaded element.
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int c = e & (tile - 1);
    const int l = e >> log_tile;
    uint64_t v = 0;
    if (e < elems_in) {
      const long long i = ((long long)l << log_m) + c0 + c;
      v = src[i];
      if (pre != nullptr) v = gl::mul_lazy(v, pre[i]);
    }
    sh[c * stride + ntt::bitrev(l, log_l)] = v;
  }
  __syncthreads();

  ntt::dit_stages(sh, tile, log_tile, log_l, stride, stage_tw);

  // `post` multiplies each output, indexed by its offset in the output
  // matrix shifted right by post_shift
  if (log_d == 0) {
    // column c0 + c becomes output row c0 + c of the (M, L) matrix: each
    // thread walks along a row, L contiguous values
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int c = e >> log_l;
      const int k = e & (L - 1);
      const long long o = ((long long)(c0 + c) << log_l) + k;
      uint64_t v = sh[c * stride + k];
      if (post != nullptr) v = gl::mul_lazy(v, post[o]);  // post_shift <= log_d = 0
      if (scale != 0) v = gl::mul_lazy(v, scale);
      dst[o] = gl::canon(v);
    }
  } else {
    // (ch, k, cl): TILE-wide segments of contiguous columns (D >= TILE)
    const int d_mask = (1 << log_d) - 1;
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int c = e & (tile - 1);
      const int k = e >> log_tile;
      const int col = c0 + c;
      const long long o = ((long long)(col >> log_d) << (log_l + log_d)) +
                          ((long long)k << log_d) + (col & d_mask);
      uint64_t v = sh[c * stride + k];
      if (post != nullptr) v = gl::mul_lazy(v, post[o >> post_shift]);
      if (scale != 0) v = gl::mul_lazy(v, scale);
      dst[o] = gl::canon(v);
    }
  }
}

}  // namespace

// in: `matrices` row-major (2^log_l_in, 2^log_m) u64 matrices, the first
// rows of (2^log_l, 2^log_m) matrices whose other rows are zero (log_l_in
// = log_l: the whole matrix); out: `matrices` (2^(log_m - log_d), 2^log_l,
// 2^log_d) arrays, column ch * 2^log_d + cl's point k at (ch, k, cl)
// (log_d = 0: the matrix transposed; log_d = log_m: in place; otherwise
// 2^log_d at least the tile width); contiguous, on the current device; in
// and out must not overlap.  Every column is transformed (length 2^log_l).
// pre: null, or 2^log_l_in x 2^log_m factors, one per input element.
// stage_tw: the 2^log_l - 1 stage twiddles (canonical).  post: null, or a
// factor per output element, at (its offset in the output array) >>
// post_shift.  scale: 0 for none, else a canonical factor for every
// output.  Outputs are canonical.  Launches on `stream` and does not
// synchronise.  Returns cudaGetLastError() (or the error of the
// shared-memory opt-in).
extern "C" int mp2_ntt_cols(const void* in, void* out, long long matrices,
                            int log_l, int log_m, int log_l_in, const void* pre,
                            const void* stage_tw, const void* post,
                            unsigned long long scale, int log_d, int post_shift,
                            void* stream) {
  if (matrices <= 0) return 0;
  if (log_l < 1 || log_l > MAX_LOG_L || log_m < 1 || log_l + log_m > 40 ||
      log_l_in < 0 || log_l_in > log_l || log_d < 0 || log_d > log_m ||
      post_shift < 0 || post_shift > log_d)
    return (int)cudaErrorInvalidValue;
  // TILE: MAX_TILE columns, fewer where TILE * L would pass MAX_TILE_ELEMS,
  // all M where M is smaller; never under MIN_TILE unless M is
  int log_tile = 0;
  while ((2 << log_tile) <= MAX_TILE &&
         (2 << (log_tile + log_l)) <= MAX_TILE_ELEMS)
    ++log_tile;
  if (log_tile > log_m) log_tile = log_m;
  if (((1 << log_tile) < MIN_TILE && log_tile < log_m) ||
      (log_d != 0 && log_d < log_tile))
    return (int)cudaErrorInvalidValue;
  const int tile = 1 << log_tile;
  const int stride = (1 << log_l) + (tile >= 16 ? 1 : 16 / tile);
  const size_t smem = (size_t)tile * stride * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ntt_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = matrices << (log_m - log_tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int quads = tile << (log_l > 1 ? log_l - 2 : 0);
  const int threads = quads >= THREADS ? THREADS : (quads < 32 ? 32 : quads);
  ntt_cols_kernel<<<(unsigned int)blocks, threads, smem,
                    (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, log_l, log_m, log_tile, log_l_in,
      (const uint64_t*)pre, (const uint64_t*)stage_tw, (const uint64_t*)post,
      (uint64_t)scale, log_d, post_shift);
  return (int)cudaGetLastError();
}
