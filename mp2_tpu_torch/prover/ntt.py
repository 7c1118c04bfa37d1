"""Number-theoretic transform over Goldilocks.

Port of `mp2_tpu/prover/ntt.py`.  Every transform of up to 2^14 points is
one `ops/ntt_cuda.ntt_rows` call over all rows, flattened to (R, n): on the
card that is one launch of K2 (the fused NTT kernel), on the CPU its plain
radix-2 twin.  From 2^15 points the four-step (Bailey) decomposition runs
instead, as `ops/ntt_t_cuda.ntt_four_step_t`: on the card two launches of
K2c (the transpose-fused four-step kernel, `ntt_pallas.py::
ntt_four_step_fused_t` in the reference, where it is opt-in), three from
2^21 to 2^30 points, with no transpose or copy through device memory
between or around its passes; on the CPU its plain twin, K2's plain passes
with torch transposes.  The reference gates its kernel at 512 points; on
the card the gate is dropped, since an eager plain stage costs dozens of
launches (a field multiply alone is ~30).

`lde` and `coset_intt` are the kernels' own entries at every size: K2's
`lde_rows` and `coset_intt_rows` up to 2^14 points, K2c's `lde_t` and
`coset_intt_t` above.  The zero padding, the coset factors and the iNTT's
scale ride inside the kernels' loads and stores.  Inputs of any strides
are taken: the flattening to (R, n) copies a non-contiguous one, where
`reshape` alone would return a strided view that the kernels refuse.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.ops.ntt_cuda import (  # noqa: F401  (re-exported tables)
    MAX_LOG_N,
    _bitrev_indices,
    _bitrev_t,
    _power_table,
    _root_of_unity,
    coset_intt_rows,
    lde_rows,
    ntt_rows,
)
from mp2_tpu_torch.ops.ntt_t_cuda import coset_intt_t, lde_t, ntt_four_step_t


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


def _ntt_four_step(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The four-step over all rows of a (..., n) tensor."""
    n = x.shape[-1]
    return ntt_four_step_t(x.reshape(-1, n).contiguous(), inverse).reshape(x.shape)


def intt(x: torch.Tensor) -> torch.Tensor:
    return ntt(x, inverse=True)


def coset_ntt(coeffs: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR):
    """Evaluate on the coset shift*H (plonky2's coset_fft)."""
    n = coeffs.shape[-1]
    return ntt(gl.mul(coeffs, _power_t(shift, n, coeffs.device)))


def coset_intt(evals: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR):
    """Coefficients from evaluations on shift*H (plonky2's coset_ifft)."""
    n = evals.shape[-1]
    entry = coset_intt_t if n.bit_length() - 1 > MAX_LOG_N else coset_intt_rows
    return entry(evals.reshape(-1, n).contiguous(), shift).reshape(evals.shape)


def lde(coeffs: torch.Tensor, rate_bits: int,
        shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Low-degree extension: zero-pad to n*2^rate_bits, evaluate on shift*H."""
    n = coeffs.shape[-1]
    big = n << rate_bits
    entry = lde_t if big.bit_length() - 1 > MAX_LOG_N else lde_rows
    rows = coeffs.reshape(-1, n).contiguous()
    return entry(rows, rate_bits, shift).reshape(coeffs.shape[:-1] + (big,))
