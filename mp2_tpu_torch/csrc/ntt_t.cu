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
// (L = 2^log_l points per column, M = 2^log_m columns):
//   pass 1: x viewed as (B, n1, n2); columns of length n1, times the middle
//           twiddle w^(k1 * j2); written transposed, as (B, n2, n1) rows;
//   pass 2: that (B, n2, n1); columns of length n2, times n^-1 when inverse;
//           written back in place of the columns, so the flat output of a
//           row is y[k1 + n1 * k2], canonical.
// The wrapper (mp2_tpu_torch/ops/ntt_t_cuda.py::ntt_four_step_t) makes the
// two launches; its plain twin ntt_four_step_plain is the torch four-step
// with K2's plain passes and torch transposes.
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
// threads of a half-warp (neighbouring columns, see dit_stages'
// INTERLEAVE) touch distinct banks.  The stages are csrc/ntt_stages.cuh:
// lazy, radix 4, the unit twiddles of stages 1-2 skipped.  64 KB of shared memory and 256
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
#include "ntt_stages.cuh"

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
                int transpose_out) {
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

  ntt::dit_stages<true>(sh, tile, log_tile, log_l, stride, stage_tw);

  // `post` (M x L when transposed, L x M otherwise) multiplies each output,
  // indexed by its offset in the output matrix
  if (transpose_out) {
    // column c0 + c becomes output row c0 + c of the (M, L) matrix
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int c = e >> log_l;
      const int k = e & (L - 1);
      const long long o = ((long long)(c0 + c) << log_l) + k;
      uint64_t v = sh[c * stride + k];
      if (post != nullptr) v = gl::mul_lazy(v, post[o]);
      if (scale != 0) v = gl::mul_lazy(v, scale);
      dst[o] = gl::canon(v);
    }
  } else {
    // back into the columns of the (L, M) matrix
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int c = e & (tile - 1);
      const int k = e >> log_tile;
      const long long o = ((long long)k << log_m) + c0 + c;
      uint64_t v = sh[c * stride + k];
      if (post != nullptr) v = gl::mul_lazy(v, post[o]);
      if (scale != 0) v = gl::mul_lazy(v, scale);
      dst[o] = gl::canon(v);
    }
  }
}

}  // namespace

// in: `matrices` row-major (2^log_l_in, 2^log_m) u64 matrices, the first
// rows of (2^log_l, 2^log_m) matrices whose other rows are zero (log_l_in
// = log_l: the whole matrix); out: `matrices` (2^log_l, 2^log_m) matrices
// (transposed to (2^log_m, 2^log_l) when transpose_out); contiguous, on the
// current device; in and out must not overlap.  Every column is transformed
// (length 2^log_l).  pre: null, or 2^log_l_in x 2^log_m factors, one per
// input element.  stage_tw: the 2^log_l - 1 stage twiddles (canonical).
// post: null, or one factor per output element of a matrix, indexed by its
// offset in the output matrix.  scale: 0 for none, else a canonical factor
// for every output.  Outputs are canonical.  Launches on `stream` and does
// not synchronise.  Returns cudaGetLastError() (or the error of the
// shared-memory opt-in).
extern "C" int mp2_ntt_cols(const void* in, void* out, long long matrices,
                            int log_l, int log_m, int log_l_in, const void* pre,
                            const void* stage_tw, const void* post,
                            unsigned long long scale,
                            int transpose_out, void* stream) {
  if (matrices <= 0) return 0;
  if (log_l < 1 || log_l > MAX_LOG_L || log_m < 1 || log_l + log_m > 40 ||
      log_l_in < 0 || log_l_in > log_l)
    return (int)cudaErrorInvalidValue;
  // TILE: MAX_TILE columns, fewer where TILE * L would pass MAX_TILE_ELEMS,
  // all M where M is smaller; never under MIN_TILE unless M is
  int log_tile = 0;
  while ((2 << log_tile) <= MAX_TILE &&
         (2 << (log_tile + log_l)) <= MAX_TILE_ELEMS)
    ++log_tile;
  if (log_tile > log_m) log_tile = log_m;
  if ((1 << log_tile) < MIN_TILE && log_tile < log_m)
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
      (uint64_t)scale, transpose_out);
  return (int)cudaGetLastError();
}
