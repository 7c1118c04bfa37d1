"""K2: the batched NTT of rows up to 2^14 points, as a CUDA kernel and its
plain twin, with its LDE and coset-iNTT entries.

Replaces `mp2_tpu/ops/ntt_pallas.py::_dit_body_lazy_pk` (the Pallas TPU
kernel K2, launched by `_compiled_fused_lazy_pk` through `ntt_full` and
both passes of `ntt_four_step_fused`) and the variants that compute the
same function: `_dit_body_lazy` (K2a), `_dit_body` (K2b) and `_make_kernel`
(K2d, `ntt_stages_bitrev_input`: the `bitrev_input` flag here).  The kernel
source is `csrc/ntt.cu` on `csrc/goldilocks.cuh`; its header comment says
what bounds it on Hopper (integer issue) and how the design answers that
(Stockham radix-8/16 passes in registers, no bit reversal, constant-shift
DFT twiddles, padded exchanges).

Three entries, each one launch of the kernel for rows of up to 2^14 points:
  * `ntt_rows(x, inverse, twiddle=None, scale=False, bitrev_input=False)`:
    an (R, n) int64 tensor of rows, each transformed; on a CPU tensor
    `ntt_rows_plain`, the radix-2 torch code of the port's `prover/ntt`;
  * `lde_rows(coeffs, rate_bits, shift)`: (R, n) coefficients -> their
    evaluations on shift * H of n * 2^rate_bits points; the kernel reads
    only the coefficients and multiplies them by shift^j as it loads them;
    on a CPU tensor `lde_rows_plain`, the zero pad, coset multiply and
    transform `prover/ntt.lde` ran;
  * `coset_intt_rows(evals, shift)`: (R, n) evaluations on shift * H -> the
    coefficients, n^-1 * shift^-j applied as the outputs are stored; on a
    CPU tensor `coset_intt_rows_plain`, the inverse transform and coset
    multiply `prover/ntt.coset_intt` ran.
On a CUDA tensor each launches the kernel or raises, and never falls back to
its plain twin.  `ntt_rows.launches` counts the kernel's launches over all
three.  This module also holds the root-of-unity and power tables that
`prover/ntt.py` and the four-step (`ops/ntt_t_cuda.py`) share, built
vectorised by doubling with the port's torch field ops.

Build: at first use, `ops/_nvcc.build_library` compiles the kernel for
sm_90a into `mp2_tpu_torch/_build/mp2_ntt-<hash>/` and loads it with
ctypes.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.goldilocks import P, POWER_OF_TWO_GENERATOR
from mp2_tpu_torch.ops._nvcc import Built, build_library

MAX_LOG_N = 14  # a row of 2^14 u64 fills 128 KB of shared memory
LOG_V = 4  # 16 values per thread: the radix of a pass is at most 2^4
_SOURCES = ("ntt.cu", "goldilocks.cuh")


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity (plonky2's tower from the 2^32
    generator)."""
    assert 0 <= log_n <= 32
    g = POWER_OF_TWO_GENERATOR
    for _ in range(32 - log_n):
        g = g * g % P
    return g


@functools.lru_cache(maxsize=None)
def _bitrev_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def powers(base: int, n: int, device) -> torch.Tensor:
    """base^j for j < n, as an int64 tensor: by doubling, each step one
    field product of the powers so far by base^len (O(n) products in
    log n torch launches)."""
    out = gl.ones((min(n, 1),), device)
    while out.shape[0] < n:
        m = out.shape[0]
        out = torch.cat([out, gl.mul_const(out[: n - m], pow(base, m, P))])
    return out


@functools.lru_cache(maxsize=None)
def _power_table(base: int, n: int) -> np.ndarray:
    """base^j for j < n as canonical uint64 values."""
    return gl.to_u64(powers(base % P, n, "cpu")).copy()


@functools.lru_cache(maxsize=None)
def _bitrev_t(log_n: int, device) -> torch.Tensor:
    return torch.from_numpy(_bitrev_indices(log_n)).to(device)


@functools.lru_cache(maxsize=None)
def _stage_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    """The n - 1 stage twiddles, stage s (1-based) at offset 2^(s-1) - 1:
    w_{2^s}^j for j < 2^(s-1), inverted roots when `inverse` (the radix-2
    stages of the plain twins and of K2c's passes)."""
    parts = [powers(_root(s, inverse), 1 << (s - 1), device) for s in range(1, log_n + 1)]
    return torch.cat(parts) if parts else gl.zeros((0,), device)


def _root(log_n: int, inverse: bool) -> int:
    w = _root_of_unity(log_n)
    return pow(w, P - 2, P) if inverse else w


def _radices(log_n: int):
    """log2 of each pass's radix in the kernel (csrc/ntt.cu: log_v,
    num_passes, radix_log): 2^min(log_n, LOG_V) first, then the rest cut
    into ceil(rest / LOG_V) passes as equal as possible, the larger ones
    last."""
    first = min(log_n, LOG_V)
    rest = log_n - first
    p = -(-rest // LOG_V)
    return [first] + [rest // p + (i >= p - rest % p) for i in range(p)]


@functools.lru_cache(maxsize=None)
def _pass_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    """The kernel's pass twiddles: for each pass i >= 1 of radix R after
    sub-transforms of Ns points, w_{Ns*R}^(r*k) at (r - 1) * Ns + k for
    1 <= r < R, k < Ns (csrc/ntt.cu: tw_offset)."""
    parts, log_ns = [], 0
    for i, lr in enumerate(_radices(log_n)):
        if i:
            w = _root(log_ns + lr, inverse)
            parts += [powers(pow(w, r, P), 1 << log_ns, device) for r in range(1, 1 << lr)]
        log_ns += lr
    return torch.cat(parts) if parts else gl.zeros((1,), device)


@functools.lru_cache(maxsize=None)
def _coset_powers(n: int, shift: int, device) -> torch.Tensor:
    """shift^j, j < n: the coset factors of an LDE's coefficients."""
    return powers(shift % P, n, device)


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
    built = build_library("mp2_ntt", _SOURCES)
    fn = built.lib.mp2_ntt_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


# ---------------------------------------------------------------------------
# plain version (torch field ops)
# ---------------------------------------------------------------------------


def ntt_rows_plain(x: torch.Tensor, inverse: bool, twiddle: Optional[torch.Tensor] = None,
                   scale: bool = False, bitrev_input: bool = False) -> torch.Tensor:
    """(R, n) -> (R, n): the plain torch version of the kernel.  Iterative
    DIT: one bit-reversal gather (skipped when `bitrev_input`), then log2(n)
    stages of contiguous-half butterflies written as reshapes."""
    R, n = x.shape
    log_n = n.bit_length() - 1
    if not bitrev_input and n > 1:
        x = torch.index_select(x, -1, _bitrev_t(log_n, x.device))
    table = _stage_table(log_n, inverse, x.device)
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        v = x.reshape(R, n // (2 * half), 2, half)
        e = v[..., 0, :]
        t = gl.mul(v[..., 1, :], table[half - 1 : 2 * half - 1])
        x = torch.cat([gl.add(e, t), gl.sub(e, t)], dim=-1).reshape(R, n)
    if twiddle is not None:
        x = gl.mul(x.reshape(-1, twiddle.shape[0], n), twiddle).reshape(R, n)
    if scale:
        x = gl.mul_const(x, pow(n, P - 2, P))
    return x


def lde_rows_plain(coeffs: torch.Tensor, rate_bits: int, shift: int,
                   transform=None) -> torch.Tensor:
    """(R, n) -> (R, n * 2^rate_bits): the plain version of the LDE entry,
    the composition `prover/ntt.lde` ran below 2^15 points: zero-pad,
    multiply by shift^j, forward transform by `transform(x, inverse)`
    (default: `ntt_rows_plain`)."""
    R, n = coeffs.shape
    big = n << rate_bits
    padded = torch.cat([coeffs, gl.zeros((R, big - n), coeffs.device)], dim=-1)
    return (transform or ntt_rows_plain)(
        gl.mul(padded, _coset_powers(big, shift, coeffs.device)), False)


def coset_intt_rows_plain(evals: torch.Tensor, shift: int, transform=None) -> torch.Tensor:
    """(R, n) -> (R, n): the plain version of the coset-iNTT entry, the
    composition `prover/ntt.coset_intt` ran below 2^15 points: inverse
    transform with its n^-1 by `transform(x, inverse, scale=True)` (default:
    `ntt_rows_plain`), multiply by shift^-j."""
    n = evals.shape[-1]
    return gl.mul((transform or ntt_rows_plain)(evals, True, scale=True),
                  _coset_powers(n, pow(shift, P - 2, P), evals.device))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _log_len(x: torch.Tensor, what: str) -> int:
    """log2 of the row length of an (R, n) int64 tensor, or ValueError."""
    if x.dtype != torch.int64 or x.dim() != 2:
        raise ValueError(f"{what}: expected an (R, n) int64 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    n = x.shape[1]
    log_n = n.bit_length() - 1
    if n == 0 or 1 << log_n != n:
        raise ValueError(f"{what}: row length {n} is not a power of two")
    return log_n


def _check_cuda(x: torch.Tensor, log_out: int):
    if x.device.type != "cuda":
        raise ValueError(f"no NTT kernel for device {x.device}")
    if log_out > MAX_LOG_N:
        raise ValueError(f"the NTT kernel takes rows of up to 2^{MAX_LOG_N} points, "
                         f"not 2^{log_out}")
    if not x.is_contiguous():
        raise ValueError("the NTT kernel takes contiguous tensors")


def _launch(x, log_n, inverse, pre=None, mid=None, scale=0, bitrev_input=False):
    """One kernel launch over the rows of x (contiguous, 2^log_in points
    each, the first points of rows of 2^log_n): returns (R, 2^log_n)."""
    R = x.shape[0]
    out = torch.empty((R, 1 << log_n), dtype=torch.int64, device=x.device)
    if R == 0:
        return out
    fn = build().lib.mp2_ntt_rows
    table = _pass_table(log_n, inverse, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), R, log_n, x.shape[1].bit_length() - 1,
                table.data_ptr(), pre.data_ptr() if pre is not None else None,
                mid.data_ptr() if mid is not None else None,
                mid.shape[0] if mid is not None else 0, scale, int(bitrev_input),
                int(inverse), stream)
    if rc != 0:
        raise RuntimeError(f"NTT kernel launch failed: CUDA error {rc}")
    ntt_rows.launches += 1
    return out


def ntt_rows(x: torch.Tensor, inverse: bool, twiddle: Optional[torch.Tensor] = None,
             scale: bool = False, bitrev_input: bool = False) -> torch.Tensor:
    """(R, n) int64 canonical rows -> their transforms, natural order.

    inverse: use the inverted roots.  twiddle: a (T, n) tensor, R % T == 0;
    row r of the output is multiplied by twiddle row r % T (the four-step
    middle twiddle).  scale: multiply by n^-1 (a full inverse transform).
    bitrev_input: the rows are already in bit-reversed order.

    CPU tensor: the plain version.  CUDA tensor: the kernel, on the current
    stream, or an exception."""
    log_n = _log_len(x, "NTT")
    if log_n > MAX_LOG_N:
        raise ValueError(f"row length {x.shape[1]} is above 2^{MAX_LOG_N}")
    R, n = x.shape
    if twiddle is not None and (twiddle.dtype != torch.int64 or twiddle.dim() != 2
                                or twiddle.shape[1] != n or R % twiddle.shape[0]):
        raise ValueError(f"twiddle {tuple(twiddle.shape)} does not tile rows of {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ntt_rows_plain(x, inverse, twiddle, scale, bitrev_input)
    _check_cuda(x, log_n)
    if twiddle is not None and (twiddle.device != x.device or not twiddle.is_contiguous()):
        raise ValueError(f"the twiddle must be contiguous on {x.device}")
    return _launch(x, log_n, inverse, mid=twiddle,
                   scale=pow(n, P - 2, P) if scale else 0, bitrev_input=bitrev_input)


def lde_rows(coeffs: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    """(R, n) int64 canonical coefficients -> (R, n * 2^rate_bits), their
    evaluations on the coset shift * H, natural order (the low-degree
    extension), for n * 2^rate_bits up to 2^14 points.

    CPU tensor: the plain version.  CUDA tensor: the kernel (one launch on
    the current stream), or an exception."""
    log_n = _log_len(coeffs, "LDE")
    if coeffs.device.type == "cpu":
        return lde_rows_plain(coeffs, rate_bits, shift)
    _check_cuda(coeffs, log_n + rate_bits)
    return _launch(coeffs, log_n + rate_bits, False,
                   pre=_coset_powers(1 << log_n, shift, coeffs.device))


def coset_intt_rows(evals: torch.Tensor, shift: int) -> torch.Tensor:
    """(R, n) int64 canonical evaluations on the coset shift * H -> (R, n)
    coefficients: the inverse transform times n^-1 * shift^-j, for n up to
    2^14.

    CPU tensor: the plain version.  CUDA tensor: the kernel (one launch on
    the current stream), or an exception."""
    log_n = _log_len(evals, "coset iNTT")
    if evals.device.type == "cpu":
        return coset_intt_rows_plain(evals, shift)
    _check_cuda(evals, log_n)
    post = _coset_intt_post(1 << log_n, shift, evals.device)[None]
    return _launch(evals, log_n, True, mid=post)


ntt_rows.launches = 0
