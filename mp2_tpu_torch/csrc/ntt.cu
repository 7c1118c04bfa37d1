// Batched NTT over Goldilocks: R independent rows of n = 2^log_n points,
// n <= 2^14, one launch, with register-resident radix stages.
//
// Replaces the TPU kernel mp2_tpu/ops/ntt_pallas.py::_dit_body_lazy_pk (K2,
// launched by _compiled_fused_lazy_pk) and the variants that compute the
// same function: _dit_body_lazy (K2a, unpacked stages), _dit_body (K2b,
// always-canonical arithmetic) and _make_kernel (K2d, stages on input that
// is already bit-reversed: the `bitrev_input` flag here).  Per row:
//   the transform of the row (natural order in and out), or of the row
//   given in bit-reversed order (bitrev_input), or, for the LDE entry, of
//   the row's first n_in coefficients times shift^j, zero-padded to n;
//   an epilogue that optionally multiplies by a per-row table row (the
//   four-step's middle twiddle, or n^-1 * shift^-j of the coset-iNTT
//   entry) and/or a scale (n^-1 of an inverse transform);
//   stored canonical.
// The outputs are canonical values of a mathematically defined transform,
// so a correct kernel is bit-identical to the TPU kernel and to the plain
// torch version (mp2_tpu_torch/ops/ntt_cuda.py::ntt_rows_plain, and
// lde_rows_plain / coset_intt_rows_plain for the two entries).
//
// What bounds it on Hopper: integer issue.  At the prover's shapes (136 * B
// rows of 2^13 or 2^14 points) the bytes, 16 per element, take ~0.085 ms,
// but log_n radix-2 stages of lazy butterflies cost 7-20 integer
// instructions per element each (an add or a sub 6-7, a product ~18: the
// P1 probe), several times that.  So
// the design spends its instructions on butterflies and as few as possible
// on moving data, and skips every product it can:
//  * Stockham radix passes in registers.  A thread holds V = 16 values (a
//    row of n <= 16 is one thread's).  Pass 0 loads the thread's 16 inputs
//    x[t + r * n/16] straight from device memory (coalesced: neighbouring
//    threads, neighbouring words) and runs a radix-16 DFT on them in
//    registers; each later pass of radix 2^3 or 2^4 (the schedule below)
//    multiplies its inputs by the pass twiddles, one product each from a
//    coalesced table, and runs radix-8/16 DFTs.  Stockham's index order
//    leaves the output in natural order with no bit reversal anywhere: a
//    2^13 row takes 4 passes, 3 exchanges through shared memory.
//  * The DFTs' own twiddles are roots of order <= 16, powers of 2 mod p, so
//    they are constant shifts with a short reduction, and a negative one
//    swaps the butterfly's add and sub instead of negating.
//  * Exchanges through shared memory use the padded index i + i / 16, so
//    the writes of the first pass (a thread's 16 outputs are adjacent) and
//    the strided reads of the later ones hit 16 distinct 8-byte banks per
//    half-warp.  A row of at most 512 points lives in one warp, which syncs
//    with __syncwarp() instead of a block barrier.
//  * bitrev_input: pass 0's input x[t + r * n/16] is stored at rev(t + r *
//    n/16) = 16 * rev'(t) + rev4(r), so thread t reads the 16 contiguous
//    words at 16 * rev'(t) (one 128-byte line) and takes them into its
//    registers in the order rev4(r), a renaming the compiler resolves.
//  * 2^14 rows: a block of 1024 threads, 16 values each, 136 KB of shared
//    memory: 32 warps per SM.
//  * Every index into a thread's values is a compile-time constant (the
//    loops unrolled, the bit-reversed renamings index sequences): one index
//    computed at run time puts the values in local memory, which made the
//    2^13 kernel 1.7 times slower on an H100 (chip_smoke.py's K2 times).
//  * The LDE entry reads only the n_in coefficients and multiplies each by
//    shift^j as it loads it; the coset-iNTT entry is the epilogue's table
//    with n^-1 * shift^-j in it.
// The Pallas kernel's lane rolls, swap-rolls, packed pairs and u32 planes
// are TPU layout choices and are not carried over.  The radix schedule is
// mirrored by mp2_tpu_torch/ops/ntt_cuda.py::_radices, which lays out the
// pass twiddle table.
//
// Tensors are int64 bit patterns of u64 values (PyTorch has no uint64 ops);
// the kernel reads them as uint64_t; the stages take any u64.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_LOG_N = 14;
constexpr int LOG_V_MAX = 4;     // 16 values per thread
constexpr int MIN_BLOCK = 128;   // threads per block at small n

// ---------------------------------------------------------------------------
// the schedule: pass 0 has radix 2^min(log_n, 4); the rest of log_n is cut
// into ceil(rest / 4) passes as equal as possible, the larger ones last
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int log_v(int log_n) {
  return log_n < LOG_V_MAX ? log_n : LOG_V_MAX;
}
__host__ __device__ constexpr int num_passes(int log_n) {
  return 1 + (log_n - log_v(log_n) + LOG_V_MAX - 1) / LOG_V_MAX;
}
__host__ __device__ constexpr int radix_log(int log_n, int i) {
  if (i == 0) return log_v(log_n);
  const int rest = log_n - log_v(log_n);
  const int p = num_passes(log_n) - 1;
  return rest / p + (i - 1 >= p - rest % p ? 1 : 0);
}
// log2 of the sub-transform length before pass i (Ns)
__host__ __device__ constexpr int log_ns(int log_n, int i) {
  int s = 0;
  for (int j = 0; j < i; ++j) s += radix_log(log_n, j);
  return s;
}
// offset of pass i's twiddles: (R_j - 1) * Ns_j values for each 1 <= j < i
__host__ __device__ constexpr int tw_offset(int log_n, int i) {
  int o = 0;
  for (int j = 1; j < i; ++j) o += ((1 << radix_log(log_n, j)) - 1) << log_ns(log_n, j);
  return o;
}
__host__ __device__ constexpr int rev_bits(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// e with 2^e = w_{2^s} (inverted when INV): the roots of order <= 16 of
// plonky2's tower (mp2_tpu_torch/ops/ntt_cuda.py::_root_of_unity), all
// powers of 2 since 2 has order 192
__host__ __device__ constexpr int root_exp(int s, bool inv) {
  return s == 1 ? 96
       : s == 2 ? (inv ? 144 : 48)
       : s == 3 ? (inv ? 72 : 120)
       : (inv ? 36 : 156);
}

// x * 2^e for 0 < e < 96, lazy, e a constant after unrolling
__device__ __forceinline__ uint64_t mul_pow2_const(uint64_t x, int e) {
  if (e >= 64) {  // x * 2^64 = x_lo * EPS - x_hi, then the rest of e
    x = gl::reduce128_lazy(0, x);
    e -= 64;
    if (e == 0) return x;
  }
  if (e > 32) return gl::reduce128_lazy(x << e, x >> (64 - e));
  // hi < 2^32: hi * 2^64 = hi * EPS < 2^64 - 2^33 + 2, one fold
  return gl::add_lazy_once(x << e, gl::mul_eps(x >> (64 - e)));
}

// (a + w b, a - w b) for the DFT's constant twiddle w = w_{2^s}^j
template <bool INV>
__device__ __forceinline__ void bfly_const(uint64_t& a, uint64_t& b, int s, int j) {
  int e = root_exp(s, INV) * j % 192;
  const bool neg = e >= 96;  // w = -2^(e - 96): swap the add and the sub
  if (neg) e -= 96;
  const uint64_t t = e == 0 ? b : mul_pow2_const(b, e);
  const uint64_t u = neg ? gl::sub_lazy(a, t) : gl::add_lazy(a, t);
  const uint64_t w = neg ? gl::add_lazy(a, t) : gl::sub_lazy(a, t);
  a = u;
  b = w;
}

// dst[rev(i)] = src[i] for i < 2^LR, every index a constant expression: an
// index the compiler computes at run time puts the arrays in local memory
template <int LR, int... I>
__device__ __forceinline__ void scatter_rev(uint64_t* dst, const uint64_t* src,
                                           std::integer_sequence<int, I...>) {
  ((dst[std::integral_constant<int, rev_bits(I, LR)>::value] = src[I]), ...);
}

template <int LR>
__device__ __forceinline__ void scatter_rev(uint64_t* dst, const uint64_t* src) {
  scatter_rev<LR>(dst, src, std::make_integer_sequence<int, 1 << LR>{});
}

// v[0..2^LR) <- its DFT with root w_{2^LR}, natural order in and out, in
// registers: radix-2 DIT stages on the bit-reversed renaming
template <int LR, bool INV>
__device__ __forceinline__ void dft(uint64_t* v) {
  constexpr int R = 1 << LR;
  uint64_t u[R];
  scatter_rev<LR>(u, v);  // rev is an involution: u[i] = v[rev(i)]
#pragma unroll
  for (int s = 1; s <= LR; ++s) {
    const int h = 1 << (s - 1);
#pragma unroll
    for (int blk = 0; blk < R; blk += 2 * h) {
#pragma unroll
      for (int j = 0; j < h; ++j) bfly_const<INV>(u[blk + j], u[blk + j + h], s, j);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = u[i];
}

__device__ __forceinline__ int rev_bits_rt(int i, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - bits));
}

__host__ __device__ constexpr int pad(int i) { return i + (i >> 4); }

template <int LOG_N>
struct Shape {
  static constexpr int N = 1 << LOG_N;
  static constexpr int LOG_V = log_v(LOG_N);
  static constexpr int V = 1 << LOG_V;
  static constexpr int LOG_TR = LOG_N - LOG_V;  // threads per row
  static constexpr int TR = 1 << LOG_TR;
  static constexpr int BLOCK = TR > MIN_BLOCK ? TR : MIN_BLOCK;
  static constexpr int RPB = BLOCK / TR;  // rows per block
  static constexpr int NP = num_passes(LOG_N);
  static constexpr size_t SMEM = NP > 1 ? (size_t)RPB * N * 17 / 16 * sizeof(uint64_t) : 0;
};

template <int LOG_N>
__device__ __forceinline__ void exchange_sync() {
  if (Shape<LOG_N>::TR <= 32) __syncwarp(); else __syncthreads();
}

// pass PASS >= 1: the previous pass's outputs are in v; store them at
// their Stockham positions, reload this pass's inputs, twiddle, DFT.  Every
// shared address is pad(base) + pad(offset), the offset a compile-time
// constant: pad(a + b) = pad(a) + pad(b) where a or b is a multiple of 16.
template <int LOG_N, bool INV, int PASS>
__device__ __forceinline__ void later_pass(uint64_t (&v)[Shape<LOG_N>::V], uint64_t* sh,
                                           int t, int rb,
                                           const uint64_t* __restrict__ pass_tw) {
  using S = Shape<LOG_N>;
  constexpr int LP = radix_log(LOG_N, PASS - 1), RP = 1 << LP;  // previous radix
  constexpr int LNP = log_ns(LOG_N, PASS - 1);                  // previous Ns
  constexpr int LR = radix_log(LOG_N, PASS), R = 1 << LR;
  constexpr int LNS = log_ns(LOG_N, PASS), NS = 1 << LNS;
  static_assert(LNP >= 4 || (LNP == 0 && RP >= 16), "store offsets must pad linearly");
  static_assert(S::N / R >= 16, "load offsets must pad linearly");
  uint64_t* row = sh + pad(rb * S::N);
#pragma unroll
  for (int q = 0; q < S::V / RP; ++q) {
    const int g = t + q * S::TR;
    uint64_t* base = row + pad(((g >> LNP) << (LNP + LP)) + (g & ((1 << LNP) - 1)));
#pragma unroll
    for (int r = 0; r < RP; ++r)
      base[pad(r << LNP)] = v[q * RP + r];
  }
  exchange_sync<LOG_N>();
  const uint64_t* tw = pass_tw + tw_offset(LOG_N, PASS);
#pragma unroll
  for (int q = 0; q < S::V / R; ++q) {
    const uint64_t* base = row + pad(t + q * S::TR);
#pragma unroll
    for (int r = 0; r < R; ++r) v[q * R + r] = base[pad(r * (S::N / R))];
  }
  if constexpr (PASS + 1 < S::NP) exchange_sync<LOG_N>();  // reads before the next writes
#pragma unroll
  for (int q = 0; q < S::V / R; ++q) {
    const uint64_t* w = tw + ((t + q * S::TR) & (NS - 1));
#pragma unroll
    for (int r = 1; r < R; ++r) v[q * R + r] = gl::mul_lazy(v[q * R + r], __ldg(w + ((r - 1) << LNS)));
    dft<LR, INV>(v + q * R);
  }
}

template <int LOG_N, bool INV>
__global__ void __launch_bounds__(Shape<LOG_N>::BLOCK)
ntt_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                long long rows, int log_n_in, const uint64_t* __restrict__ pass_tw,
                const uint64_t* __restrict__ pre, const uint64_t* __restrict__ mid_tw,
                long long mid_rows, uint64_t scale, int bitrev_input) {
  using S = Shape<LOG_N>;
  extern __shared__ uint64_t sh[];
  const int t = threadIdx.x & (S::TR - 1);
  const int rb = threadIdx.x >> S::LOG_TR;
  const long long row = (long long)blockIdx.x * S::RPB + rb;
  const bool live = row < rows;
  uint64_t v[S::V];

  // pass 0: one group per thread, g = t, inputs x[t + r * n/V]
#pragma unroll
  for (int r = 0; r < S::V; ++r) v[r] = 0;
  if (live && bitrev_input) {
    const uint64_t* src = in + (row << LOG_N) + (rev_bits_rt(t, S::LOG_TR) << S::LOG_V);
    scatter_rev<S::LOG_V>(v, src);
  } else if (live && log_n_in == LOG_N && pre == nullptr) {
    const uint64_t* src = in + (row << LOG_N) + t;
#pragma unroll
    for (int r = 0; r < S::V; ++r) v[r] = src[r * S::TR];
  } else if (live) {  // the LDE entry: n_in coefficients times shift^i
    const int n_in = 1 << log_n_in;
    const uint64_t* src = in + (row << log_n_in);
#pragma unroll
    for (int r = 0; r < S::V; ++r) {
      const int i = t + r * S::TR;
      if (i < n_in) v[r] = pre != nullptr ? gl::mul_lazy(src[i], __ldg(pre + i)) : src[i];
    }
  }
  dft<S::LOG_V, INV>(v);
  if constexpr (S::NP > 1) later_pass<LOG_N, INV, 1>(v, sh, t, rb, pass_tw);
  if constexpr (S::NP > 2) later_pass<LOG_N, INV, 2>(v, sh, t, rb, pass_tw);
  if constexpr (S::NP > 3) later_pass<LOG_N, INV, 3>(v, sh, t, rb, pass_tw);
  static_assert(S::NP <= 4, "at most four passes");

  // epilogue: the last pass's group g holds outputs g + r * n/R
  if (!live) return;
  constexpr int LR = radix_log(LOG_N, S::NP - 1), R = 1 << LR;
  const uint64_t* mid = mid_tw != nullptr ? mid_tw + ((row % mid_rows) << LOG_N) : nullptr;
  uint64_t* dst = out + (row << LOG_N);
#pragma unroll
  for (int q = 0; q < S::V / R; ++q) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = t + q * S::TR + r * (S::N / R);
      uint64_t x = v[q * R + r];
      if (mid != nullptr) x = gl::mul_lazy(x, __ldg(mid + i));
      if (scale != 0) x = gl::mul_lazy(x, scale);
      dst[i] = gl::canon(x);
    }
  }
}

template <int LOG_N, bool INV>
int launch(const uint64_t* in, uint64_t* out, long long rows, int log_n_in,
           const uint64_t* pass_tw, const uint64_t* pre, const uint64_t* mid_tw,
           long long mid_rows, uint64_t scale, int bitrev_input, cudaStream_t stream) {
  using S = Shape<LOG_N>;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_rows_kernel<LOG_N, INV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)S::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + S::RPB - 1) / S::RPB;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ntt_rows_kernel<LOG_N, INV><<<(unsigned)blocks, S::BLOCK, S::SMEM, stream>>>(
      in, out, rows, log_n_in, pass_tw, pre, mid_tw, mid_rows, scale, bitrev_input);
  return (int)cudaGetLastError();
}

template <bool INV>
int dispatch(int log_n, const uint64_t* in, uint64_t* out, long long rows, int log_n_in,
             const uint64_t* pass_tw, const uint64_t* pre, const uint64_t* mid_tw,
             long long mid_rows, uint64_t scale, int bitrev_input, cudaStream_t stream) {
#define MP2_K2_CASE(L) \
  case L: return launch<L, INV>(in, out, rows, log_n_in, pass_tw, pre, mid_tw, \
                                mid_rows, scale, bitrev_input, stream);
  switch (log_n) {
    MP2_K2_CASE(0) MP2_K2_CASE(1) MP2_K2_CASE(2) MP2_K2_CASE(3) MP2_K2_CASE(4)
    MP2_K2_CASE(5) MP2_K2_CASE(6) MP2_K2_CASE(7) MP2_K2_CASE(8) MP2_K2_CASE(9)
    MP2_K2_CASE(10) MP2_K2_CASE(11) MP2_K2_CASE(12) MP2_K2_CASE(13) MP2_K2_CASE(14)
  }
#undef MP2_K2_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// in: (rows, 2^log_n_in) u64, out: (rows, 2^log_n) u64, contiguous, on the
// current device, not overlapping; log_n_in <= log_n (below: the row's
// first 2^log_n_in points, the others zero; then bitrev_input must be 0).
// pass_tw: the pass twiddle table of ops/ntt_cuda.py::_pass_table (canonical;
// null when log_n <= 4).  pre: null, or 2^log_n_in factors, one per input
// point.  mid_tw: null, or (mid_rows, 2^log_n) factors; row r's outputs are
// multiplied by mid_tw row r % mid_rows.  scale: 0 for none, else a
// canonical factor for every output.  inverse: the inverted roots.
// Outputs are canonical.  Launches on `stream` and does not synchronise.
// Returns cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int mp2_ntt_rows(const void* in, void* out, long long rows, int log_n,
                            int log_n_in, const void* pass_tw, const void* pre,
                            const void* mid_tw, long long mid_rows,
                            unsigned long long scale, int bitrev_input, int inverse,
                            void* stream) {
  if (rows <= 0) return 0;
  if (log_n < 0 || log_n > MAX_LOG_N || log_n_in < 0 || log_n_in > log_n ||
      (bitrev_input && log_n_in != log_n) || (mid_tw != nullptr && mid_rows <= 0))
    return (int)cudaErrorInvalidValue;
  const uint64_t* a = (const uint64_t*)in;
  uint64_t* o = (uint64_t*)out;
  const uint64_t* tw = (const uint64_t*)pass_tw;
  const uint64_t* p = (const uint64_t*)pre;
  const uint64_t* m = (const uint64_t*)mid_tw;
  cudaStream_t s = (cudaStream_t)stream;
  return inverse ? dispatch<true>(log_n, a, o, rows, log_n_in, tw, p, m, mid_rows, scale,
                                  bitrev_input, s)
                 : dispatch<false>(log_n, a, o, rows, log_n_in, tw, p, m, mid_rows, scale,
                                   bitrev_input, s);
}
