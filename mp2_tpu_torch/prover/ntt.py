"""Number-theoretic transform over Goldilocks.

Port of `mp2_tpu/prover/ntt.py`.  Every transform of up to 2^14 points is
one `ops/ntt_cuda.ntt_rows` call over all rows, flattened to (R, n): on the
card that is one launch of K2 (the fused NTT kernel), on the CPU its plain
radix-2 twin.  From 2^15 points the four-step (Bailey) decomposition of
`mp2_tpu/ops/ntt_pallas.py::ntt_four_step_fused` runs instead: K2 over the
columns with the middle twiddle in its epilogue, a torch transpose, K2 over
the rows, and the transpose back.  The reference gates its kernel at 512
points; on the card the gate is dropped, since an eager plain stage costs
dozens of launches (a field multiply alone is ~30).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.ops.ntt_cuda import (  # noqa: F401  (re-exported tables)
    MAX_LOG_N,
    _bitrev_indices,
    _bitrev_t,
    _power_table,
    _root_of_unity,
    ntt_rows,
)


@lru_cache(maxsize=None)
def _power_t(base: int, n: int, device) -> torch.Tensor:
    return gl.from_u64(_power_table(base, n), device)


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Transform along the last axis (length a power of two)."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    if n == 1:
        return x
    if log_n > MAX_LOG_N:
        return _ntt_four_step(x, inverse)
    return _ntt_small(x, inverse)


def _ntt_small(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """One pass over all rows (n <= 2^14 on the card)."""
    n = x.shape[-1]
    return ntt_rows(x.reshape(-1, n).contiguous(), inverse, scale=inverse).reshape(x.shape)


@lru_cache(maxsize=None)
def _four_step_twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """w^(k1*j2) as an (n2, n1) table: row j2 is the middle twiddle of the
    column transform that pass 1 computes for column j2."""
    log1 = log_n // 2
    n1, n2 = 1 << log1, 1 << (log_n - log1)
    w = _root_of_unity(log_n)
    if inverse:
        w = pow(w, P - 2, P)
    out = np.empty((n2, n1), dtype=np.uint64)
    for j2 in range(n2):
        out[j2] = _power_table(pow(w, j2, P), n1)
    return gl.from_u64(out, device)


def _ntt_four_step(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Bailey: view n = n1*n2 as (n1, n2) row-major, n1 = 2^floor(log n / 2);
    y[k1 + n1*k2] = NTT_j2( w^(j2 k1) * NTT_j1(x[j1, j2])[k1] )[k2]:
    1) transform the columns, with the middle twiddle, 2) transform the
    rows, 3) read out transposed.  An inverse scales each pass by its own
    length's inverse, n1^-1 * n2^-1 = n^-1."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    log1 = log_n // 2
    n1, n2 = 1 << log1, 1 << (log_n - log1)
    batch = tuple(x.shape[:-1])
    cols = x.reshape(-1, n1, n2).transpose(1, 2).reshape(-1, n1)  # (B*n2, n1)
    a = ntt_rows(cols, inverse, twiddle=_four_step_twiddles(log_n, inverse, x.device),
                 scale=inverse)
    rows = a.reshape(-1, n2, n1).transpose(1, 2).reshape(-1, n2)  # (B*n1, n2)
    c = ntt_rows(rows, inverse, scale=inverse)
    return c.reshape(-1, n1, n2).transpose(1, 2).reshape(batch + (n,))


def intt(x: torch.Tensor) -> torch.Tensor:
    return ntt(x, inverse=True)


def coset_ntt(coeffs: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR):
    """Evaluate on the coset shift*H (plonky2's coset_fft)."""
    n = coeffs.shape[-1]
    return ntt(gl.mul(coeffs, _power_t(shift, n, coeffs.device)))


def coset_intt(evals: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR):
    n = evals.shape[-1]
    return gl.mul(intt(evals), _power_t(pow(shift, P - 2, P), n, evals.device))


def lde(coeffs: torch.Tensor, rate_bits: int,
        shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Low-degree extension: zero-pad to n*2^rate_bits, evaluate on shift*H."""
    n = coeffs.shape[-1]
    pad = gl.zeros(tuple(coeffs.shape[:-1]) + ((n << rate_bits) - n,), coeffs.device)
    return coset_ntt(torch.cat([coeffs, pad], dim=-1), shift)
