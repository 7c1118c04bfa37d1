"""K2: the batched fused NTT, as a CUDA kernel and its plain twin.

Replaces `mp2_tpu/ops/ntt_pallas.py::_dit_body_lazy_pk` (the Pallas TPU
kernel K2, launched by `_compiled_fused_lazy_pk` through `ntt_full` and
both passes of `ntt_four_step_fused`) and the variants that compute the
same function: `_dit_body_lazy` (K2a), `_dit_body` (K2b) and `_make_kernel`
(K2d, `ntt_stages_bitrev_input`: the `bitrev_input` flag here).  The kernel
source is `csrc/ntt.cu` on `csrc/ntt_stages.cuh` (the stages it shares
with K2c) and `csrc/goldilocks.cuh`; its header comment says
what bounds it on Hopper (the bytes, one read and one write of each element,
about level with the 64-bit products) and how the design answers that (each
row stays in shared memory for all its stages).

`ntt_rows(x, inverse, twiddle=None, scale=False, bitrev_input=False)` is the
one entry: an (R, n) int64 tensor of rows, n = 2^k <= 2^14, each row
transformed.  On a CPU tensor it runs `ntt_rows_plain`, the radix-2 torch
code of the port's `prover/ntt`; on a CUDA tensor it launches the kernel or
raises, and never falls back to the plain version.  `ntt_rows.launches`
counts kernel launches.  This module also holds the root-of-unity and
twiddle tables that `prover/ntt.py` shares.

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
_SOURCES = ("ntt.cu", "ntt_stages.cuh", "goldilocks.cuh")


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


@functools.lru_cache(maxsize=None)
def _power_table(base: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint64)
    cur = 1
    for i in range(n):
        out[i] = cur
        cur = cur * base % P
    return out


@functools.lru_cache(maxsize=None)
def _bitrev_t(log_n: int, device) -> torch.Tensor:
    return torch.from_numpy(_bitrev_indices(log_n)).to(device)


@functools.lru_cache(maxsize=None)
def _stage_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    """The n - 1 stage twiddles, stage s (1-based) at offset 2^(s-1) - 1:
    w_{2^s}^j for j < 2^(s-1), inverted roots when `inverse`."""
    parts = []
    for s in range(1, log_n + 1):
        w = _root_of_unity(s)
        if inverse:
            w = pow(w, P - 2, P)
        parts.append(_power_table(w, 1 << (s - 1)))
    flat = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint64)
    return gl.from_u64(flat, device)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def build() -> Built:
    """Compile (once per source hash) and load the kernel library."""
    built = build_library("mp2_ntt", _SOURCES)
    fn = built.lib.mp2_ntt_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_int,
                   ctypes.c_void_p]
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


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def ntt_rows(x: torch.Tensor, inverse: bool, twiddle: Optional[torch.Tensor] = None,
             scale: bool = False, bitrev_input: bool = False) -> torch.Tensor:
    """(R, n) int64 canonical rows -> their transforms, natural order.

    inverse: use the inverted roots.  twiddle: a (T, n) tensor, R % T == 0;
    row r of the output is multiplied by twiddle row r % T (the four-step
    middle twiddle).  scale: multiply by n^-1 (a full inverse transform).
    bitrev_input: the rows are already in bit-reversed order.

    CPU tensor: the plain version.  CUDA tensor: the kernel, on the current
    stream, or an exception."""
    if x.dtype != torch.int64 or x.dim() != 2:
        raise ValueError(f"expected an (R, n) int64 tensor, got {x.dtype} {tuple(x.shape)}")
    R, n = x.shape
    log_n = n.bit_length() - 1
    if n == 0 or 1 << log_n != n or log_n > MAX_LOG_N:
        raise ValueError(f"row length {n} is not a power of two up to 2^{MAX_LOG_N}")
    if twiddle is not None and (twiddle.dtype != torch.int64 or twiddle.dim() != 2
                                or twiddle.shape[1] != n or R % twiddle.shape[0]):
        raise ValueError(f"twiddle {tuple(twiddle.shape)} does not tile rows of {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ntt_rows_plain(x, inverse, twiddle, scale, bitrev_input)
    if x.device.type != "cuda":
        raise ValueError(f"no NTT kernel for device {x.device}")
    if not x.is_contiguous() or (twiddle is not None and not twiddle.is_contiguous()):
        raise ValueError("the NTT kernel takes contiguous tensors")
    if twiddle is not None and twiddle.device != x.device:
        raise ValueError(f"twiddle on {twiddle.device}, rows on {x.device}")
    out = torch.empty_like(x)
    if R == 0:
        return out
    fn = build().lib.mp2_ntt_rows
    table = _stage_table(log_n, inverse, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), R, log_n,
                table.data_ptr() if log_n else None,
                twiddle.data_ptr() if twiddle is not None else None,
                twiddle.shape[0] if twiddle is not None else 0,
                pow(n, P - 2, P) if scale else 0, int(bitrev_input), stream)
    if rc != 0:
        raise RuntimeError(f"NTT kernel launch failed: CUDA error {rc}")
    ntt_rows.launches += 1
    return out


ntt_rows.launches = 0
