"""K2c: the transpose-fused four-step NTT, as a CUDA kernel and its plain twin.

Replaces `mp2_tpu/ops/ntt_pallas.py::_make_fused_kernel_t` (the Pallas TPU
kernel K2c, launched by `_compiled_fused_t` through `ntt_four_step_fused_t`):
the four-step (Bailey) transform of (B, n) rows with both transposes inside
the kernel.  The kernel source is `csrc/ntt_t.cu`, on K2's stages
(`csrc/ntt_stages.cuh`) and `csrc/goldilocks.cuh`; its header comment says
what bounds it on Hopper (the bytes: each pass reads and writes each element
once) and how the design answers that (a tile of matrix columns is
transposed in shared memory).

`ntt_four_step_t(x, inverse)` is the one entry: a (B, n) int64 tensor of
canonical rows, each row transformed; natural order out, scaled by n^-1
when `inverse`.  On a CPU tensor it runs `ntt_four_step_plain`, the torch
four-step (K2's plain passes with torch transposes), for any power of two
from 4.  On a CUDA tensor it launches the kernel twice (the column pass
with the middle twiddle, written transposed, then the row pass), for
contiguous rows of 2^6 to 2^20 points (n1, n2 from 8 to 2^10), or raises,
and never falls back to the plain version.  `ntt_four_step_t.launches`
counts kernel launches, two per transform.

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
MAX_LOG_N = 20  # n1, n2 <= 2^10: a tile of 16 columns of 2^10 fills 128 KB
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


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def build() -> Built:
    """Compile (once per source hash) and load the kernel library."""
    built = build_library("mp2_ntt_t", _SOURCES)
    fn = built.lib.mp2_ntt_cols
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


# ---------------------------------------------------------------------------
# plain version (torch field ops)
# ---------------------------------------------------------------------------


def ntt_four_step_plain(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, n) -> (B, n): the plain torch version of the kernel.  Bailey: view
    a row as (n1, n2) row-major; y[k1 + n1*k2] =
    NTT_j2( w^(j2 k1) * NTT_j1(x[j1, j2])[k1] )[k2]: 1) transform the
    columns, with the middle twiddle, 2) transform the rows, 3) read out
    transposed.  An inverse scales each pass by its own length's inverse,
    n1^-1 * n2^-1 = n^-1."""
    B, n = x.shape
    log_n = n.bit_length() - 1
    log1, log2 = split(log_n)
    n1, n2 = 1 << log1, 1 << log2
    cols = x.reshape(B, n1, n2).transpose(1, 2).reshape(-1, n1)  # (B*n2, n1)
    a = ntt_rows_plain(cols, inverse, twiddle=_four_step_twiddles(log_n, inverse, x.device),
                       scale=inverse)
    rows = a.reshape(B, n2, n1).transpose(1, 2).reshape(-1, n2)  # (B*n1, n2)
    c = ntt_rows_plain(rows, inverse, scale=inverse)
    return c.reshape(B, n1, n2).transpose(1, 2).reshape(B, n)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def ntt_four_step_t(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, n) int64 canonical rows -> their transforms, natural order, scaled
    by n^-1 when `inverse`.

    CPU tensor: the plain version.  CUDA tensor: the kernel (two launches on
    the current stream), or an exception."""
    if x.dtype != torch.int64 or x.dim() != 2:
        raise ValueError(f"expected a (B, n) int64 tensor, got {x.dtype} {tuple(x.shape)}")
    B, n = x.shape
    log_n = n.bit_length() - 1
    if n < 4 or 1 << log_n != n:
        raise ValueError(f"row length {n} is not a power of two from 4")
    if x.device.type == "cpu":
        return ntt_four_step_plain(x, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"no four-step NTT kernel for device {x.device}")
    if not MIN_LOG_N <= log_n <= MAX_LOG_N:
        raise ValueError(f"the four-step NTT kernel takes rows of 2^{MIN_LOG_N} to "
                         f"2^{MAX_LOG_N} points, not {n}")
    if not x.is_contiguous():
        raise ValueError("the four-step NTT kernel takes a contiguous tensor")
    a = torch.empty_like(x)  # pass 1 out: (B, n2, n1)
    out = torch.empty_like(x)
    if B == 0:
        return out
    fn = build().lib.mp2_ntt_cols
    log1, log2 = split(log_n)
    mid = _four_step_twiddles(log_n, inverse, x.device)
    passes = (
        # columns of (n1, n2), middle twiddle, written transposed
        (x, a, log1, log2, _stage_table(log1, inverse, x.device), mid, 0, 1),
        # columns of (n2, n1), n^-1, written back in place
        (a, out, log2, log1, _stage_table(log2, inverse, x.device), None,
         pow(n, P - 2, P) if inverse else 0, 0),
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for src, dst, log_l, log_m, table, tw, scale, transpose_out in passes:
            rc = fn(src.data_ptr(), dst.data_ptr(), B, log_l, log_m, table.data_ptr(),
                    tw.data_ptr() if tw is not None else None, scale, transpose_out,
                    stream)
            if rc != 0:
                raise RuntimeError(f"four-step NTT kernel launch failed: CUDA error {rc}")
            ntt_four_step_t.launches += 1
    return out


ntt_four_step_t.launches = 0
