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
// What bounds it on Hopper: the bytes.  A pass reads and writes each element
// once (16 B), against log L / 2 64-bit products per element (each several
// 32-bit multiplies); the four-step as K2 + torch transposes moved each
// element through device memory five times (three transposed copies, two
// kernel passes), this moves it twice.
//
// Design (a first, simple one): a block takes TILE adjacent columns of one
// matrix (TILE = 32, or 16 at L = 2^10, or M when M is smaller), so every
// global load of a matrix row is TILE contiguous u64 (256 B; 128 B at
// L = 2^10), coalesced across a warp.  It stores the tile transposed into
// dynamic shared memory, one column per shared row at its bit-reversed
// slot, with rows padded to L + 1 values so that a warp walking down a
// column touches distinct banks.  The L-point radix-2 stages are those of
// K2 (csrc/ntt_stages.cuh).  The epilogue applies the twiddle or scale and
// stores either whole rows of L contiguous values (transposed) or the
// TILE-wide column segments again, coalesced.  TILE * (L + 1) * 8 B is
// 66 KB at L = 2^8 and 131 KB at L = 2^9 and 2^10, above the 48 KB default,
// so the C entry opts in with cudaFuncSetAttribute.  The Pallas kernel's
// (n, TILE_R = 8) column slabs and u32 plane pairs are the TPU's layout
// (which Mosaic refused) and are not carried over.  Radix-4 stages, TMA
// tile loads and wgmma are later work.
//
// Tensors are int64 bit patterns of u64 values; the kernel reads them as
// uint64_t and reduces each input mod p on load.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"
#include "ntt_stages.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MAX_TILE = 32;
constexpr int MAX_TILE_ELEMS = 1 << 14;  // TILE * L, 128 KB of values
constexpr int MIN_TILE = 16;             // 128 B per row load
constexpr int MAX_LOG_L = 10;

__global__ void __launch_bounds__(THREADS)
ntt_cols_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                int log_l, int log_m, int log_tile,
                const uint64_t* __restrict__ stage_tw,
                const uint64_t* __restrict__ mid_tw, uint64_t scale,
                int transpose_out) {
  extern __shared__ uint64_t sh[];
  const int L = 1 << log_l;
  const int stride = L + 1;
  const int tile = 1 << log_tile;
  const int tiles_per_matrix = 1 << (log_m - log_tile);
  const long long matrix = blockIdx.x >> (log_m - log_tile);
  const int c0 = (blockIdx.x & (tiles_per_matrix - 1)) << log_tile;
  const long long base = matrix << (log_l + log_m);
  const uint64_t* src = in + base;
  uint64_t* dst = out + base;
  const int elems = tile << log_l;

  // load: element (l, c0 + c) to shared row c, slot rev(l); a warp reads
  // consecutive columns of one matrix row
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int c = e & (tile - 1);
    const int l = e >> log_tile;
    sh[c * stride + ntt::bitrev(l, log_l)] =
        gl::canon(src[((long long)l << log_m) + c0 + c]);
  }
  __syncthreads();

  ntt::dit_stages(sh, tile, log_l, stride, stage_tw);

  if (transpose_out) {
    // column c0 + c becomes output row c0 + c of the (M, L) matrix
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int c = e >> log_l;
      const int k = e & (L - 1);
      const long long o = ((long long)(c0 + c) << log_l) + k;
      uint64_t v = sh[c * stride + k];
      if (mid_tw != nullptr) v = gl::mul(v, mid_tw[o]);
      if (scale != 0) v = gl::mul(v, scale);
      dst[o] = v;
    }
  } else {
    // back into the columns of the (L, M) matrix
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int c = e & (tile - 1);
      const int k = e >> log_tile;
      uint64_t v = sh[c * stride + k];
      if (mid_tw != nullptr) v = gl::mul(v, mid_tw[((long long)(c0 + c) << log_l) + k]);
      if (scale != 0) v = gl::mul(v, scale);
      dst[((long long)k << log_m) + c0 + c] = v;
    }
  }
}

}  // namespace

// in, out: `matrices` row-major (2^log_l, 2^log_m) u64 matrices, contiguous,
// on the current device; in and out must not overlap.  Every column is
// transformed (length 2^log_l).  stage_tw: the 2^log_l - 1 stage twiddles
// (canonical).  mid_tw: null, or (2^log_m, 2^log_l) canonical values, row c
// multiplying column c's transform.  scale: 0 for none, else a canonical
// factor for every output.  transpose_out: 1 writes column c as row c of a
// (2^log_m, 2^log_l) matrix, 0 writes it back as a column.  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError() (or the
// error of the shared-memory opt-in).
extern "C" int mp2_ntt_cols(const void* in, void* out, long long matrices,
                            int log_l, int log_m, const void* stage_tw,
                            const void* mid_tw, unsigned long long scale,
                            int transpose_out, void* stream) {
  if (matrices <= 0) return 0;
  if (log_l < 1 || log_l > MAX_LOG_L || log_m < 1 || log_l + log_m > 40)
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
  const int elems = 1 << (log_tile + log_l);
  const size_t smem =
      (size_t)(1 << log_tile) * ((1 << log_l) + 1) * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ntt_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = matrices << (log_m - log_tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int half = elems / 2;
  const int threads = half >= THREADS ? THREADS : (half < 32 ? 32 : half);
  ntt_cols_kernel<<<(unsigned int)blocks, threads, smem,
                    (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, log_l, log_m, log_tile,
      (const uint64_t*)stage_tw, (const uint64_t*)mid_tw, (uint64_t)scale,
      transpose_out);
  return (int)cudaGetLastError();
}
