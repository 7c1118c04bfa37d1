"""K2c: the transpose-fused four-step NTT, as a CUDA kernel and its plain twin.

Replaces `mp2_tpu/ops/ntt_pallas.py::_make_fused_kernel_t` (the Pallas TPU
kernel K2c, launched by `_compiled_fused_t` through `ntt_four_step_fused_t`):
the four-step (Bailey) transform of (B, n) rows with both transposes inside
the kernel.  The kernel source is `csrc/ntt_t.cu`, on K2's stages
(`csrc/ntt_stages.cuh`) and `csrc/goldilocks.cuh`; its header comment says
what bounds it on Hopper (integer issue: each pass reads and writes each
element once, but its stages cost ~30 integer instructions per element) and
how the design answers that (a tile of matrix columns is transposed in
shared memory; lazy radix-4 stages).

Three entries, each two launches of the kernel (the column pass with the
middle twiddle, written transposed, then the row pass) for contiguous rows
of 2^6 to 2^20 points (n1, n2 from 8 to 2^10):
  * `ntt_four_step_t(x, inverse)`: (B, n) rows, each transformed; natural
    order out, scaled by n^-1 when `inverse`;
  * `lde_t(coeffs, rate_bits, shift)`: (B, n) coefficients -> their
    evaluations on shift * H of n * 2^rate_bits points; pass 1 reads only
    the coefficients (the zero padding is never made) and multiplies them by
    shift^j as it loads them;
  * `coset_intt_t(evals, shift)`: (B, n) evaluations on shift * H -> the
    coefficients; pass 2 multiplies by n^-1 * shift^-j as it stores.
On a CPU tensor each runs its plain twin: `ntt_four_step_plain`, the torch
four-step (K2's plain passes with torch transposes), for any power of two
from 4, and `lde_t_plain` / `coset_intt_t_plain`, the padded, coset-
multiplied compositions `prover/ntt` ran around it.  On a CUDA tensor each
launches the kernel or raises, and never falls back to its plain twin.
`ntt_four_step_t.launches` counts the kernel's launches, two per transform,
over all three entries.

Build: at first use, `ops/_nvcc.build_library` compiles the kernel for
sm_90a into `mp2_tpu_torch/_build/mp2_ntt_t-<hash>/` and loads it with
ctypes.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.ops._nvcc import Built, build_library
from mp2_tpu_torch.ops.ntt_cuda import (
    _power_table,
    _root_of_unity,
    _stage_table,
    ntt_rows_plain,
)

MIN_LOG_N = 6  # n1, n2 >= 8
MAX_LOG_N = 20  # n1, n2 <= 2^10: a tile of 8 columns of 2^10 fills 64 KB
_SOURCES = ("ntt_t.cu", "ntt_stages.cuh", "goldilocks.cuh")


def split(log_n: int):
    """(log n1, log n2): n1 = 2^floor(log n / 2) points per column of the
    (n1, n2) matrix view of a row, n2 per matrix row."""
    log1 = log_n // 2
    return log1, log_n - log1


@functools.lru_cache(maxsize=None)
def _four_step_twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """w^(k1*j2) as an (n2, n1) table: row j2 is the middle twiddle of the
    column transform that pass 1 computes for column j2."""
    log1, log2 = split(log_n)
    n1, n2 = 1 << log1, 1 << log2
    w = _root_of_unity(log_n)
    if inverse:
        w = pow(w, P - 2, P)
    out = np.empty((n2, n1), dtype=np.uint64)
    for j2 in range(n2):
        out[j2] = _power_table(pow(w, j2, P), n1)
    return gl.from_u64(out, device)


@functools.lru_cache(maxsize=None)
def _coset_powers(n: int, shift: int, device) -> torch.Tensor:
    """shift^j, j < n: the coset factors of an LDE's coefficients."""
    return gl.from_u64(_power_table(shift % P, n), device)


@functools.lru_cache(maxsize=None)
def _coset_intt_post(n: int, shift: int, device) -> torch.Tensor:
    """n^-1 * shift^-j, j < n: the factors of a coset iNTT's outputs."""
    return gl.mul_const(_coset_powers(n, pow(shift, P - 2, P), device), pow(n, P - 2, P))


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
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


# ---------------------------------------------------------------------------
# plain version (torch field ops)
# ---------------------------------------------------------------------------


def ntt_four_step_plain(x: torch.Tensor, inverse: bool, ntt_rows=None) -> torch.Tensor:
    """(B, n) -> (B, n): the plain torch version of the kernel.  Bailey: view
    a row as (n1, n2) row-major; y[k1 + n1*k2] =
    NTT_j2( w^(j2 k1) * NTT_j1(x[j1, j2])[k1] )[k2]: 1) transform the
    columns, with the middle twiddle, 2) transform the rows, 3) read out
    transposed.  An inverse scales each pass by its own length's inverse,
    n1^-1 * n2^-1 = n^-1.  `ntt_rows` runs the passes (default: K2's plain
    twin)."""
    ntt_rows = ntt_rows or ntt_rows_plain
    B, n = x.shape
    log_n = n.bit_length() - 1
    log1, log2 = split(log_n)
    n1, n2 = 1 << log1, 1 << log2
    cols = x.reshape(B, n1, n2).transpose(1, 2).reshape(-1, n1)  # (B*n2, n1)
    a = ntt_rows(cols, inverse, twiddle=_four_step_twiddles(log_n, inverse, x.device),
                 scale=inverse)
    rows = a.reshape(B, n2, n1).transpose(1, 2).reshape(-1, n2)  # (B*n1, n2)
    c = ntt_rows(rows, inverse, scale=inverse)
    return c.reshape(B, n1, n2).transpose(1, 2).reshape(B, n)


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
    """Both kernel passes over the B rows of x, transforms of 2^log_n points.
    x: (B, 2^log_in) contiguous, the first points of each row (the others
    zero); pre: null or a factor per element of x's rows; post: null or a
    factor per output point (else n^-1 when inverse).  Returns (B, 2^log_n)."""
    dev, B = x.device, x.shape[0]
    n = 1 << log_n
    log1, log2 = split(log_n)
    a = torch.empty((B, n), dtype=torch.int64, device=dev)  # pass 1 out: (B, n2, n1)
    out = torch.empty((B, n), dtype=torch.int64, device=dev)
    if B == 0:
        return out
    fn = build().lib.mp2_ntt_cols
    scale = pow(n, P - 2, P) if inverse and post is None else 0
    passes = (
        # columns of (n1, n2), of which the first 2^(log_in - log2) rows are
        # given; middle twiddle; written transposed
        (x, a, log1, log2, log_in - log2, pre, _stage_table(log1, inverse, dev),
         _four_step_twiddles(log_n, inverse, dev), 0, 1),
        # columns of (n2, n1), written back in place
        (a, out, log2, log1, log2, None, _stage_table(log2, inverse, dev), post, scale, 0),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for src, dst, log_l, log_m, log_l_in, pre_t, table, post_t, sc, transpose_out in passes:
            rc = fn(src.data_ptr(), dst.data_ptr(), B, log_l, log_m, log_l_in,
                    pre_t.data_ptr() if pre_t is not None else None, table.data_ptr(),
                    post_t.data_ptr() if post_t is not None else None, sc,
                    transpose_out, stream)
            if rc != 0:
                raise RuntimeError(f"four-step NTT kernel launch failed: CUDA error {rc}")
            ntt_four_step_t.launches += 1
    return out


def ntt_four_step_t(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, n) int64 canonical rows -> their transforms, natural order, scaled
    by n^-1 when `inverse`.

    CPU tensor: the plain version.  CUDA tensor: the kernel (two launches on
    the current stream), or an exception."""
    log_n = _check(x, "four-step NTT")
    if x.device.type == "cpu":
        return ntt_four_step_plain(x, inverse)
    _check_cuda(x, log_n, "rows")
    return _launch_passes(x, log_n, inverse, log_n, None, None)


def lde_t(coeffs: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    """(B, n) int64 canonical coefficients -> (B, n * 2^rate_bits), their
    evaluations on the coset shift * H, natural order (the low-degree
    extension).

    CPU tensor: the plain version.  CUDA tensor: the kernel (two launches on
    the current stream) for n * 2^rate_bits from 2^6 to 2^20 points and n at
    least its matrix width (2^ceil(log N / 2)), or an exception."""
    log_n = _check(coeffs, "LDE")
    if coeffs.device.type == "cpu":
        return lde_t_plain(coeffs, rate_bits, shift)
    log_big = log_n + rate_bits
    _check_cuda(coeffs, log_big, "LDEs")
    if log_n < split(log_big)[1]:
        raise ValueError(f"the LDE kernel takes at least 2^{split(log_big)[1]} "
                         f"coefficients for 2^{log_big} points, not 2^{log_n}")
    return _launch_passes(coeffs, log_big, False, log_n,
                          _coset_powers(1 << log_n, shift, coeffs.device), None)


def coset_intt_t(evals: torch.Tensor, shift: int) -> torch.Tensor:
    """(B, n) int64 canonical evaluations on the coset shift * H -> (B, n)
    coefficients: the inverse transform times shift^-j.

    CPU tensor: the plain version.  CUDA tensor: the kernel (two launches on
    the current stream), or an exception."""
    log_n = _check(evals, "coset iNTT")
    if evals.device.type == "cpu":
        return coset_intt_t_plain(evals, shift)
    _check_cuda(evals, log_n, "rows")
    return _launch_passes(evals, log_n, True, log_n, None,
                          _coset_intt_post(1 << log_n, shift, evals.device))


ntt_four_step_t.launches = 0
