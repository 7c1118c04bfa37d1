"""K2c: the transpose-fused four-step NTT, as a CUDA kernel and its plain twin.

Replaces `mp2_tpu/ops/ntt_pallas.py::_make_fused_kernel_t` (the Pallas TPU
kernel K2c, launched by `_compiled_fused_t` through `ntt_four_step_fused_t`):
the four-step (Bailey) transform of (B, n) rows with both transposes inside
the kernel.  The kernel source is `csrc/ntt_t.cu` (its radix-4 stages
included) on `csrc/goldilocks.cuh`; its header comment says
what bounds it on Hopper (integer issue: each pass reads and writes each
element once, but its stages cost ~30 integer instructions per element) and
how the design answers that (a tile of matrix columns is transposed in
shared memory; lazy radix-4 stages).

Three entries, each two launches of the kernel (the column pass with the
middle twiddle, written transposed, then the row pass) for contiguous rows
of 2^6 to 2^20 points (n1, n2 from 8 to 2^10), and three launches from
2^21 to 2^30 points (`passes`: n = n1 * n2 * n3, each at most 2^10, the
row pass a four-step of its own with its own middle twiddle):
  * `ntt_four_step_t(x, inverse)`: (B, n) rows, each transformed; natural
    order out, scaled by n^-1 when `inverse`;
  * `lde_t(coeffs, rate_bits, shift)`: (B, n) coefficients -> their
    evaluations on shift * H of n * 2^rate_bits points; pass 1 reads only
    the coefficients (the zero padding is never made) and multiplies them by
    shift^j as it loads them;
  * `coset_intt_t(evals, shift)`: (B, n) evaluations on shift * H -> the
    coefficients; pass 2 multiplies by n^-1 * shift^-j as it stores.
On a CPU tensor each runs its plain twin: `ntt_four_step_plain`, the same
decomposition with K2's plain passes and torch transposes, for any power of
two from 4, and `lde_t_plain` / `coset_intt_t_plain`, the padded, coset-
multiplied compositions `prover/ntt` ran around it.  On a CUDA tensor each
launches the kernel or raises, and never falls back to its plain twin.
`ntt_four_step_t.launches` counts the kernel's launches, two or three per
transform, over all three entries.  Above 2^30 points the entries raise:
a row of 2^30 is 8 GiB, and its two scratch buffers and the first pass's
middle-twiddle table (n values) take 24 GiB more.

Build: at first use, `ops/_nvcc.build_library` compiles the kernel for
sm_90a into `mp2_tpu_torch/_build/mp2_ntt_t-<hash>/` and loads it with
ctypes.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.ops._nvcc import Built, build_library
from mp2_tpu_torch.ops.ntt_cuda import (
    _coset_intt_post,
    _coset_powers,
    _root,
    _stage_table,
    ntt_rows_plain,
    powers,
)

MIN_LOG_N = 6  # n1, n2 >= 8
MAX_LOG_L = 10  # a pass's columns: a tile of 8 columns of 2^10 fills 64 KB
MAX_LOG_N = 30  # three passes of at most 2^10 points
_SOURCES = ("ntt_t.cu", "goldilocks.cuh")


def passes(log_n: int, max_log_l: int = MAX_LOG_L):
    """log2 of each pass's column length: at least two passes, as few as
    keep each at most 2^max_log_l, as equal as possible, the longer ones
    last (two passes: floor(log n / 2), then the rest)."""
    p = max(2, -(-log_n // max_log_l))
    return [log_n // p + (i >= p - log_n % p) for i in range(p)]


@functools.lru_cache(maxsize=None)
def _pass_twiddles(log_total: int, log_l: int, inverse: bool, device) -> torch.Tensor:
    """w^(k*j) for w = w_{2^log_total}, as a (2^(log_total - log_l),
    2^log_l) table: row j is the middle twiddle of the transform of length
    2^log_l that a pass computes for column j.  Built by doubling the
    columns: column block [m, 2m) is columns [0, m) times w^(m*j)."""
    w = _root(log_total, inverse)
    rows = 1 << (log_total - log_l)
    out = gl.ones((rows, 1), device)
    while out.shape[1] < 1 << log_l:
        m = out.shape[1]
        out = torch.cat([out, gl.mul(out, powers(pow(w, m, P), rows, device)[:, None])], dim=1)
    return out


def _four_step_twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """The (n / n1, n1) middle twiddle of the first pass, n1 =
    2^passes(log_n)[0]: (n2, n1) for a two-pass transform."""
    return _pass_twiddles(log_n, passes(log_n)[0], inverse, device)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def build() -> Built:
    """Compile (once per source hash) and load the kernel library."""
    built = build_library("mp2_ntt_t", _SOURCES)
    fn = built.lib.mp2_ntt_cols
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


# ---------------------------------------------------------------------------
# plain version (torch field ops)
# ---------------------------------------------------------------------------


def ntt_four_step_plain(x: torch.Tensor, inverse: bool, ntt_rows=None,
                        max_log_l: int = MAX_LOG_L) -> torch.Tensor:
    """(B, n) -> (B, n): the plain torch version of the kernel's passes.
    Bailey's four-step, nested: view a row as (n1, n2) row-major;
    y[k1 + n1*k2] = NTT_j2( w^(j2 k1) * NTT_j1(x[j1, j2])[k1] )[k2]; each
    pass transforms the next index j_i of the row (columns of length
    2^passes()[i]), times the middle twiddle of the transform still to do
    over (j_i, j_rest), and leaves the finished indices innermost, so the
    last pass's output is in natural order.  An inverse scales each pass
    by its own length's inverse, whose product is n^-1.  `ntt_rows` runs
    the passes (default: K2's plain twin); `max_log_l` sets the longest
    pass (the kernel's: 2^10)."""
    ntt_rows = ntt_rows or ntt_rows_plain
    B, n = x.shape
    log_n = n.bit_length() - 1
    lens = passes(log_n, max_log_l)
    log_done = 0
    for i, log_l in enumerate(lens):
        log_rest = log_n - log_done - log_l
        # layout (B, j_i, j_rest, done) -> rows (B, done, j_rest) of length L
        cols = x.reshape(B, 1 << log_l, 1 << log_rest, 1 << log_done) \
            .permute(0, 3, 2, 1).reshape(-1, 1 << log_l)
        tw = (_pass_twiddles(log_l + log_rest, log_l, inverse, x.device)
              if i < len(lens) - 1 else None)
        a = ntt_rows(cols, inverse, twiddle=tw, scale=inverse)
        # (B, done, j_rest, k_i) -> layout (B, j_rest, k_i, done)
        x = a.reshape(B, 1 << log_done, 1 << log_rest, 1 << log_l) \
            .permute(0, 2, 3, 1).reshape(B, n)
        log_done += log_l
    return x


def lde_t_plain(coeffs: torch.Tensor, rate_bits: int, shift: int,
                transform=None) -> torch.Tensor:
    """(B, n) -> (B, n * 2^rate_bits): the plain version of the LDE entry,
    the composition `prover/ntt.lde` ran: zero-pad, multiply by shift^j,
    transform by `transform` (default: the plain four-step)."""
    B, n = coeffs.shape
    big = n << rate_bits
    padded = torch.cat([coeffs, gl.zeros((B, big - n), coeffs.device)], dim=-1)
    return (transform or ntt_four_step_plain)(
        gl.mul(padded, _coset_powers(big, shift, coeffs.device)), False)


def coset_intt_t_plain(evals: torch.Tensor, shift: int, transform=None) -> torch.Tensor:
    """(B, n) -> (B, n): the plain version of the coset-iNTT entry, the
    composition `prover/ntt.coset_intt` ran: inverse transform by
    `transform` (default: the plain four-step), multiply by shift^-j."""
    n = evals.shape[-1]
    return gl.mul((transform or ntt_four_step_plain)(evals, True),
                  _coset_powers(n, pow(shift, P - 2, P), evals.device))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, what: str) -> int:
    """log2 of the row length of a (B, n) int64 tensor, or ValueError."""
    if x.dtype != torch.int64 or x.dim() != 2:
        raise ValueError(f"expected a (B, n) int64 tensor, got {x.dtype} {tuple(x.shape)}")
    n = x.shape[1]
    log_n = n.bit_length() - 1
    if n < 4 or 1 << log_n != n:
        raise ValueError(f"{what}: row length {n} is not a power of two from 4")
    return log_n


def _check_cuda(x: torch.Tensor, log_n: int, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"no four-step NTT kernel for device {x.device}")
    if not MIN_LOG_N <= log_n <= MAX_LOG_N:
        raise ValueError(f"the four-step NTT kernel takes {what} of 2^{MIN_LOG_N} to "
                         f"2^{MAX_LOG_N} points, not 2^{log_n}")
    if not x.is_contiguous():
        raise ValueError("the four-step NTT kernel takes a contiguous tensor")


def _launch_passes(x, log_n, inverse, log_in, pre, post):
    """The kernel's passes over the B rows of x, transforms of 2^log_n
    points, as `ntt_four_step_plain` decomposes them.  x: (B, 2^log_in)
    contiguous, the first points of each row (the others zero); pre: null or
    a factor per element of x's rows (pass 1); post: null or a factor per
    output point (else n^-1 when inverse; last pass).  Returns (B, 2^log_n)."""
    dev, B = x.device, x.shape[0]
    n = 1 << log_n
    bufs = [torch.empty((B, n), dtype=torch.int64, device=dev) for _ in range(2)]
    if B == 0:
        return bufs[0]
    fn = build().lib.mp2_ntt_cols
    lens = passes(log_n)
    log_done, src = 0, x
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, log_l in enumerate(lens):
            log_m = log_n - log_l
            last = i == len(lens) - 1
            # columns of (L, M) matrices; the first pass reads the first
            # 2^(log_in - log_m) matrix rows; written as (M / D, L, D)
            if last:
                post_t, shift = post, 0
                scale = pow(n, P - 2, P) if inverse and post is None else 0
            else:
                post_t = _pass_twiddles(log_n - log_done, log_l, inverse, dev)
                shift, scale = log_done, 0
            dst = bufs[i % 2]
            rc = fn(src.data_ptr(), dst.data_ptr(), B, log_l, log_m,
                    log_in - log_m if i == 0 else log_l,
                    pre.data_ptr() if i == 0 and pre is not None else None,
                    _stage_table(log_l, inverse, dev).data_ptr(),
                    post_t.data_ptr() if post_t is not None else None, scale,
                    log_m if last else log_done, shift, stream)
            if rc != 0:
                raise RuntimeError(f"four-step NTT kernel launch failed: CUDA error {rc}")
            ntt_four_step_t.launches += 1
            src = dst
            log_done += log_l
    return src


def ntt_four_step_t(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, n) int64 canonical rows -> their transforms, natural order, scaled
    by n^-1 when `inverse`.

    CPU tensor: the plain version.  CUDA tensor: the kernel (two or three
    launches on the current stream), or an exception."""
    log_n = _check(x, "four-step NTT")
    if x.device.type == "cpu":
        return ntt_four_step_plain(x, inverse)
    _check_cuda(x, log_n, "rows")
    return _launch_passes(x, log_n, inverse, log_n, None, None)


def lde_t(coeffs: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    """(B, n) int64 canonical coefficients -> (B, n * 2^rate_bits), their
    evaluations on the coset shift * H, natural order (the low-degree
    extension).

    CPU tensor: the plain version.  CUDA tensor: the kernel (two or three
    launches on the current stream) for n * 2^rate_bits from 2^6 to 2^30
    points and n at least the width of the first pass's matrix (N / n1,
    2^ceil(log N / 2) for two passes: rate_bits <= log n1), or an
    exception."""
    log_n = _check(coeffs, "LDE")
    if coeffs.device.type == "cpu":
        return lde_t_plain(coeffs, rate_bits, shift)
    log_big = log_n + rate_bits
    _check_cuda(coeffs, log_big, "LDEs")
    width = log_big - passes(log_big)[0]
    if log_n < width:
        raise ValueError(f"the LDE kernel takes at least 2^{width} "
                         f"coefficients for 2^{log_big} points, not 2^{log_n}")
    return _launch_passes(coeffs, log_big, False, log_n,
                          _coset_powers(1 << log_n, shift, coeffs.device), None)


def coset_intt_t(evals: torch.Tensor, shift: int) -> torch.Tensor:
    """(B, n) int64 canonical evaluations on the coset shift * H -> (B, n)
    coefficients: the inverse transform times shift^-j.

    CPU tensor: the plain version.  CUDA tensor: the kernel (two or three
    launches on the current stream), or an exception."""
    log_n = _check(evals, "coset iNTT")
    if evals.device.type == "cpu":
        return coset_intt_t_plain(evals, shift)
    _check_cuda(evals, log_n, "rows")
    return _launch_passes(evals, log_n, True, log_n, None,
                          _coset_intt_post(1 << log_n, shift, evals.device))


ntt_four_step_t.launches = 0
