// Batched radix-2 NTT over Goldilocks: R independent rows of n = 2^log_n
// points, n <= 2^14, one pass.
//
// Replaces the TPU kernel mp2_tpu/ops/ntt_pallas.py::_dit_body_lazy_pk (K2,
// launched by _compiled_fused_lazy_pk) and the variants that compute the
// same function: _dit_body_lazy (K2a, unpacked stages), _dit_body (K2b,
// always-canonical arithmetic) and _make_kernel (K2d, stages on input that
// is already bit-reversed: the `bitrev_input` flag here).  Per row:
//   load in bit-reversed order (unless bitrev_input)
//   log_n DIT stages: stage s, half h = 2^(s-1), twiddles w_{2^s}^j, j < h
//   epilogue: optionally times a per-row middle-twiddle row (four-step
//             pass 1) and/or a scale (n^-1 of an inverse transform)
//   store canonical, natural order
// The outputs are canonical values of a mathematically defined transform,
// so a correct kernel is bit-identical to the TPU kernel and to the plain
// torch version (mp2_tpu_torch/ops/ntt_cuda.py::ntt_rows_plain).
//
// What bounds it on Hopper: at the prover's shapes (R = 136 * B rows of
// 2^13 or 2^14 points) the bytes, 16 per element (one u64 read, one
// written), come out at about the same time as the 64-bit products (one per
// butterfly, log_n / 2 per element, each emulated by several 32-bit
// multiplies); a row's log_n stages touch every element log_n times, so the
// design keeps the row in shared memory between stages and reads and
// writes device memory once.  The stages are csrc/ntt_stages.cuh, shared
// with K2c (csrc/ntt_t.cu, the transpose-fused four-step above 2^14).
//
// Design (a first, simple one): one thread block holds one row of n >= 2048
// points, or 2048 / n rows of a smaller n, in dynamic shared memory as
// uint64_t (2^14 * 8 B = 128 KB at the largest n, above the 48 KB default,
// so the launch opts in with cudaFuncSetAttribute).  Loads are coalesced
// global reads written to the bit-reversed shared slot; 512 threads walk
// the stages of csrc/ntt_stages.cuh (lazy, radix 4; __syncthreads()
// between passes, each thread along a row); the stage twiddles are one
// table of n - 1 values in device memory (stage s at offset 2^(s-1) - 1).
// The epilogue canonicalises.  The Pallas kernel's
// lane rolls, swap-rolls, packed pairs, lazy u32-limb dialect and TILE_R
// tiles are TPU layout choices and are not carried over.  Small-n batched
// rows, register-resident sub-transforms and TMA loads are later work.
//
// Tensors are int64 bit patterns of u64 values (PyTorch has no uint64 ops);
// the kernel reads them as uint64_t and reduces each input mod p on load.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"
#include "ntt_stages.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MIN_BLOCK_ELEMS = 2048;
constexpr int MAX_LOG_N = 14;

__global__ void __launch_bounds__(THREADS)
ntt_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                long long rows, int log_n, int rows_per_block,
                const uint64_t* __restrict__ stage_tw,
                const uint64_t* __restrict__ mid_tw, long long mid_rows,
                uint64_t scale, int bitrev_input) {
  extern __shared__ uint64_t sh[];
  const int n = 1 << log_n;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long left = rows - row0;
  const int nrows = left < rows_per_block ? (int)left : rows_per_block;
  const int elems = nrows << log_n;
  const uint64_t* src = in + (row0 << log_n);
  uint64_t* dst = out + (row0 << log_n);

  // load: element i of a row goes to shared slot rev(i) (rev is an
  // involution, so slot k then holds x[rev(k)])
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int i = e & (n - 1);
    const int j = bitrev_input ? i : ntt::bitrev(i, log_n);
    sh[e - i + j] = gl::canon(src[e]);
  }
  __syncthreads();

  ntt::dit_stages<false>(sh, nrows, 0, log_n, n, stage_tw);

  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    uint64_t v = sh[e];
    if (mid_tw != nullptr) {
      const long long r = (row0 + (e >> log_n)) % mid_rows;
      v = gl::mul_lazy(v, mid_tw[(r << log_n) + (e & (n - 1))]);
    }
    if (scale != 0) v = gl::mul_lazy(v, scale);
    dst[e] = gl::canon(v);
  }
}

}  // namespace

// in, out: (rows, 2^log_n) u64, contiguous, on the current device.
// stage_tw: the n - 1 stage twiddles (canonical).  mid_tw: null, or
// (mid_rows, n) canonical values; row r is multiplied by mid_tw row
// r % mid_rows.  scale: 0 for none, else a canonical factor for every
// output.  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int mp2_ntt_rows(const void* in, void* out, long long rows,
                            int log_n, const void* stage_tw,
                            const void* mid_tw, long long mid_rows,
                            unsigned long long scale, int bitrev_input,
                            void* stream) {
  if (rows <= 0) return 0;
  if (log_n < 0 || log_n > MAX_LOG_N) return (int)cudaErrorInvalidValue;
  if (mid_tw != nullptr && mid_rows <= 0) return (int)cudaErrorInvalidValue;
  const int n = 1 << log_n;
  long long rpb = n >= MIN_BLOCK_ELEMS ? 1 : MIN_BLOCK_ELEMS / n;
  if (rpb > rows) rpb = rows;
  const size_t smem = (size_t)rpb * n * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ntt_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + rpb - 1) / rpb;
  const long long half = rpb * n / 2;
  const int threads = half >= THREADS ? THREADS : (half < 32 ? 32 : (int)half);
  ntt_rows_kernel<<<(unsigned int)blocks, threads, smem,
                    (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, rows, log_n, (int)rpb,
      (const uint64_t*)stage_tw, (const uint64_t*)mid_tw, mid_rows,
      (uint64_t)scale, bitrev_input);
  return (int)cudaGetLastError();
}
