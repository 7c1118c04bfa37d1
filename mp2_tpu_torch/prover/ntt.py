"""Number-theoretic transform over Goldilocks (radix-2, plain torch).

Port of `mp2_tpu/prover/ntt.py`.  Iterative DIT: one bit-reversal gather,
then log2(n) stages of contiguous-half butterflies written as reshapes.
From 2^15 points the four-step (Bailey) decomposition runs instead, as in
the reference.  The fused NTT kernel of the TPU package (K2) is not ported
yet; the tree-node slice only transforms 16 and 128 points.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.goldilocks import P, POWER_OF_TWO_GENERATOR

_FOUR_STEP_MIN_LOG = 15


@lru_cache(maxsize=None)
def _root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity (plonky2's tower from the 2^32
    generator)."""
    assert 0 <= log_n <= 32
    g = POWER_OF_TWO_GENERATOR
    for _ in range(32 - log_n):
        g = g * g % P
    return g


@lru_cache(maxsize=None)
def _bitrev_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@lru_cache(maxsize=None)
def _power_table(base: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint64)
    cur = 1
    for i in range(n):
        out[i] = cur
        cur = cur * base % P
    return out


@lru_cache(maxsize=None)
def _bitrev_t(log_n: int, device) -> torch.Tensor:
    return torch.from_numpy(_bitrev_indices(log_n)).to(device)


@lru_cache(maxsize=None)
def _stage_twiddles(log_n: int, inverse: bool, device):
    """For stage s (1-based): w_{2^s}^j for j < 2^(s-1), as device tensors."""
    tables = []
    for s in range(1, log_n + 1):
        w = _root_of_unity(s)
        if inverse:
            w = pow(w, P - 2, P)
        tables.append(gl.from_u64(_power_table(w, 1 << (s - 1)), device))
    return tables


@lru_cache(maxsize=None)
def _power_t(base: int, n: int, device) -> torch.Tensor:
    return gl.from_u64(_power_table(base, n), device)


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Transform along the last axis (length a power of two)."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    if log_n >= _FOUR_STEP_MIN_LOG:
        return _ntt_four_step(x, inverse)
    return _ntt_small(x, inverse)


def _ntt_small(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if n == 1:
        return x
    batch = tuple(x.shape[:-1])
    x = torch.index_select(x, -1, _bitrev_t(log_n, x.device))
    tws = _stage_twiddles(log_n, inverse, x.device)
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        v = x.reshape(batch + (n // (2 * half), 2, half))
        e = v[..., 0, :]
        t = gl.mul(v[..., 1, :], tws[s - 1])
        x = torch.cat([gl.add(e, t), gl.sub(e, t)], dim=-1).reshape(batch + (n,))
    if inverse:
        x = gl.mul_const(x, pow(n, P - 2, P))
    return x


@lru_cache(maxsize=None)
def _four_step_twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """w^(i*j) table of shape (n1, n2) for the middle twiddle pass."""
    log1 = log_n // 2
    n1, n2 = 1 << log1, 1 << (log_n - log1)
    w = _root_of_unity(log_n)
    if inverse:
        w = pow(w, P - 2, P)
    out = np.empty((n1, n2), dtype=np.uint64)
    for i in range(n1):
        out[i] = _power_table(pow(w, i, P), n2)
    return gl.from_u64(out, device)


def _ntt_four_step(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Bailey: view n = n1*n2 as (n1, n2) row-major;
    1) transform the columns, 2) twiddle by w^(k1*j2), 3) transform the
    rows, 4) read out transposed."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    log1 = log_n // 2
    n1, n2 = 1 << log1, 1 << (log_n - log1)
    batch = tuple(x.shape[:-1])
    m = x.reshape((-1, n1, n2))
    a = _ntt_small(m.transpose(1, 2), inverse)  # (B, n2, n1)
    a = gl.mul(a, _four_step_twiddles(log_n, inverse, x.device).T)
    c = _ntt_small(a.transpose(1, 2), inverse)  # (B, n1, n2)
    return c.transpose(1, 2).reshape(batch + (n,))


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
