// P1: the field-primitive probe.  Times one primitive applied k times to
// every element of a u64 array, so that the slope of time against k is the
// primitive's cost on the card.
//
// Replaces the TPU probe tools/probe_ops.py::_kern (launched by _compiled),
// which timed the gl_u32 limb primitives (mul_lazy, sq_lazy, add_lazy,
// mul_pow2_lazy, pltpu.roll, select, mul32, mul32_wide) inside a Pallas
// kernel.  Here the primitives are goldilocks.cuh's, canonical and lazy,
// beside the machine's own 32-bit multiply, 64x64 -> 128 product, select
// and warp shuffle (__shfl_sync, Hopper's counterpart of pltpu.roll).
//
// What bounds it on Hopper: integer instruction issue, by construction.
// Each thread holds one element x and its operand y in registers and runs
// the chain x <- op(x, y) K times, each step depending on the last, so the
// time grows with K by the op's issue cost (or its latency, where too few
// warps are in flight to hide it: 2^23 elements are 2^18 warps, ~1986 per
// SM over the grid).  Memory traffic (two reads and one write per element) is the same
// at every K and drops out of the slope.
//
// Design: one kernel per (op, K), K a template constant, so the chain is
// unrolled with no loop counter; the op and K are chosen at the C entry.
// An empty asm after each step hides x from the optimiser, so each step
// costs what it would cost alone.
// The chain's result is stored after a canon, so a plain twin that
// computes the same function in canonical arithmetic can be held against it
// bit for bit.  The ops are those of the table in
// mp2_tpu_torch/ops/probe_cuda.py (OPS), in the same order.
//
// The *_SEL ops time the lazy primitives in compiled C (a carry or borrow
// read by comparing the result with an operand, folded by a select), the
// forms goldilocks.cuh's PTX carry chains replaced, kept here so that one
// run prices both.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;

enum Op {
  MUL, MUL_LAZY, SQR, SQR_LAZY, ADD, ADD_LAZY, SUB, SUB_LAZY, CANON,
  MUL_POW2_LAZY, MUL_POW2_WARP, MUL_POW2_UNIFORM, MUL32, MUL_WIDE, SELECT,
  SHFL, ADD_LAZY_SEL, SUB_LAZY_SEL, MUL_LAZY_SEL, SQR_LAZY_SEL
};

// The lazy set by compare and select: in [0, 2^64), out [0, 2^64),
// congruent mod p, as goldilocks.cuh's lazy functions.
namespace sel {

using gl::EPS;

__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  const uint64_t c = (s < a) ? EPS : 0;
  s += c;
  return s + ((s < c) ? EPS : 0);
}

__device__ __forceinline__ uint64_t sub_lazy(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  const uint64_t w = (a < b) ? EPS : 0;
  const uint64_t e = d - w;
  return e - ((d < w) ? EPS : 0);
}

__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t lo, uint64_t hi) {
  const uint64_t hi_lo = hi & 0xFFFFFFFFull;
  const uint64_t hi_hi = hi >> 32;
  uint64_t t0 = lo - hi_hi;
  t0 -= (lo < hi_hi) ? EPS : 0;
  const uint64_t t1 = (hi_lo << 32) - hi_lo;
  const uint64_t s = t0 + t1;
  return s + ((s < t1) ? EPS : 0);
}

__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  return reduce128_lazy(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t sqr_lazy(uint64_t a) {
  const uint32_t al = (uint32_t)a, ah = (uint32_t)(a >> 32);
  const uint64_t ll = (uint64_t)al * al, lh = (uint64_t)al * ah,
                 hh = (uint64_t)ah * ah;
  const uint64_t lo = ll + (lh << 33);
  const uint64_t hi = hh + (lh >> 31) + (lo < ll);
  return reduce128_lazy(lo, hi);
}

}  // namespace sel

template <int OP>
__device__ __forceinline__ uint64_t step(uint64_t x, uint64_t y, uint32_t e,
                                         uint32_t ew, int r, int lane) {
  switch (OP) {
    case MUL: return gl::mul(x, y);
    case MUL_LAZY: return gl::mul_lazy(x, y);
    case SQR: return gl::mul(x, x);
    case SQR_LAZY: return gl::sqr_lazy(x);
    case ADD: return gl::add(x, y);
    case ADD_LAZY: return gl::add_lazy(x, y);
    case SUB: return gl::sub(x, y);
    case SUB_LAZY: return gl::sub_lazy(x, y);
    case CANON: return gl::canon(x ^ y);
    case MUL_POW2_LAZY: return gl::mul_pow2_lazy(x, e);
    case MUL_POW2_WARP: return gl::mul_pow2_lazy(x, ew);
    case MUL_POW2_UNIFORM: return gl::mul_pow2_uniform_lazy(x, ew);
    case MUL32: {  // (lo * hi, hi + lo) on the 32-bit halves
      const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
      return ((uint64_t)(hi + lo) << 32) | (uint32_t)(lo * hi);
    }
    case MUL_WIDE:  // the 128-bit product, both halves folded together
      return (x * y) ^ __umul64hi(x, y);
    case SELECT: {  // each half kept when even, else the other half
      const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
      const uint32_t nlo = (lo & 1) ? hi : lo, nhi = (hi & 1) ? lo : hi;
      return ((uint64_t)nhi << 32) | nlo;
    }
    case SHFL:  // lane i takes lane (i + 1 + r % 7) mod 32's value
      return (uint64_t)__shfl_sync(0xffffffffu, (unsigned long long)x,
                                   (lane + 1 + r % 7) & 31);
    case ADD_LAZY_SEL: return sel::add_lazy(x, y);
    case SUB_LAZY_SEL: return sel::sub_lazy(x, y);
    case MUL_LAZY_SEL: return sel::mul_lazy(x, y);
    case SQR_LAZY_SEL: return sel::sqr_lazy(x);
  }
  return x;
}

template <int OP, int K>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
             uint64_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;  // n is a multiple of THREADS: whole warps only
  uint64_t x = a[i];
  const uint64_t y = b[i];
  // y mod 192: the shift exponent of MUL_POW2_LAZY (2^32 = 64 mod 192)
  const uint32_t e = (uint32_t)((((y >> 32) * 64) + (y & 0xFFFFFFFFull)) % 192);
  // an exponent shared by the 32 threads of a warp, as an NTT stage's
  // twiddle is in K2c's interleaved layout (the plain twin's warp_exponents)
  const uint32_t ew = (uint32_t)(((i >> 5) * 131) % 192);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    x = step<OP>(x, y, e, ew, r, lane);
    // an empty asm that "changes" x: the compiler can neither fold the
    // chain (k adds into one product) nor analyse across its steps (without
    // it a long chain of sqr_lazy, each using x three times, did not build)
    asm volatile("" : "+l"(x));
  }
  out[i] = gl::canon(x);
}

// the chain lengths of an op: (2, 10) as the TPU probe timed its products,
// (2, 18) its other ops, and the two long chains (64, 128) and (256, 512)
// whose difference is compute-bound (see ops/probe_cuda.py)
constexpr bool is_product(int op) {
  return op == MUL || op == MUL_LAZY || op == SQR || op == SQR_LAZY ||
         op == MUL_POW2_LAZY || op == MUL_POW2_WARP ||
         op == MUL_POW2_UNIFORM || op == MUL_WIDE || op == MUL_LAZY_SEL ||
         op == SQR_LAZY_SEL;
}

template <int OP, int K>
void run(const uint64_t* a, const uint64_t* b, uint64_t* out, long long n,
         cudaStream_t stream) {
  probe_kernel<OP, K><<<(unsigned)(n / THREADS), THREADS, 0, stream>>>(a, b, out, n);
}

template <int OP>
int launch(int k, const uint64_t* a, const uint64_t* b, uint64_t* out,
           long long n, cudaStream_t stream) {
  constexpr bool PRODUCT = is_product(OP);
  if (k == 2) run<OP, 2>(a, b, out, n, stream);
  else if (k == (PRODUCT ? 10 : 18)) run<OP, PRODUCT ? 10 : 18>(a, b, out, n, stream);
  else if (k == (PRODUCT ? 64 : 256)) run<OP, PRODUCT ? 64 : 256>(a, b, out, n, stream);
  else if (k == (PRODUCT ? 128 : 512)) run<OP, PRODUCT ? 128 : 512>(a, b, out, n, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: n u64, contiguous, on the current device; n a positive
// multiple of 256.  op: an index of enum Op; k: 2, 10, 64 or 128 for the
// products, 2, 18, 256 or 512 for the other ops.  out[i] =
// canon(op^k(a[i]) with operand b[i]).  Launches on `stream` and does not
// synchronise.  Returns cudaGetLastError().
extern "C" int mp2_probe_ops(int op, int k, const void* a, const void* b,
                             void* out, long long n, void* stream) {
  if (n <= 0 || n % THREADS || n / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const uint64_t* pa = (const uint64_t*)a;
  const uint64_t* pb = (const uint64_t*)b;
  uint64_t* po = (uint64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case MUL: return launch<MUL>(k, pa, pb, po, n, s);
    case MUL_LAZY: return launch<MUL_LAZY>(k, pa, pb, po, n, s);
    case SQR: return launch<SQR>(k, pa, pb, po, n, s);
    case SQR_LAZY: return launch<SQR_LAZY>(k, pa, pb, po, n, s);
    case ADD: return launch<ADD>(k, pa, pb, po, n, s);
    case ADD_LAZY: return launch<ADD_LAZY>(k, pa, pb, po, n, s);
    case SUB: return launch<SUB>(k, pa, pb, po, n, s);
    case SUB_LAZY: return launch<SUB_LAZY>(k, pa, pb, po, n, s);
    case CANON: return launch<CANON>(k, pa, pb, po, n, s);
    case MUL_POW2_LAZY: return launch<MUL_POW2_LAZY>(k, pa, pb, po, n, s);
    case MUL_POW2_WARP: return launch<MUL_POW2_WARP>(k, pa, pb, po, n, s);
    case MUL_POW2_UNIFORM: return launch<MUL_POW2_UNIFORM>(k, pa, pb, po, n, s);
    case MUL32: return launch<MUL32>(k, pa, pb, po, n, s);
    case MUL_WIDE: return launch<MUL_WIDE>(k, pa, pb, po, n, s);
    case SELECT: return launch<SELECT>(k, pa, pb, po, n, s);
    case SHFL: return launch<SHFL>(k, pa, pb, po, n, s);
    case ADD_LAZY_SEL: return launch<ADD_LAZY_SEL>(k, pa, pb, po, n, s);
    case SUB_LAZY_SEL: return launch<SUB_LAZY_SEL>(k, pa, pb, po, n, s);
    case MUL_LAZY_SEL: return launch<MUL_LAZY_SEL>(k, pa, pb, po, n, s);
    case SQR_LAZY_SEL: return launch<SQR_LAZY_SEL>(k, pa, pb, po, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
