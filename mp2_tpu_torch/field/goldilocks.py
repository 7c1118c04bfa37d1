"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, as PyTorch tensor arithmetic.

Representation: a `torch.int64` tensor holding the bit pattern of the
canonical u64 value, so p - 1 is stored as -4294967296.  Torch has no add,
shift or compare on uint64, so:
  * wrapping add and the low 64 bits of a product are exact in int64;
  * a logical right shift is `>>` followed by a mask;
  * an unsigned compare flips the sign bit of both sides first.

The 64x64 -> 128 product is built from four 32x32 limb products, then
reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).  This is the plain
twin of the CUDA device functions in `csrc/goldilocks.cuh`.

Every public function takes and returns canonical values in [0, p).
Port of `mp2_tpu/field/goldilocks.py`.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
EPSILON = 0xFFFFFFFF  # 2^64 mod p
MASK32 = 0xFFFFFFFF

TWO_ADICITY = 32
MULTIPLICATIVE_GROUP_GENERATOR = 7
POWER_OF_TWO_GENERATOR = pow(7, (P - 1) >> TWO_ADICITY, P)

_SIGN = -(1 << 63)  # int64 bit pattern of 2^63
_P_I64 = P - (1 << 64)  # int64 bit pattern of p
_P_FLIP = _P_I64 ^ _SIGN  # p with the sign bit flipped, for unsigned compares


def to_i64(v: int) -> int:
    """Python int -> the int64 bit pattern of its canonical residue."""
    v %= P
    return v - (1 << 64) if v >= 1 << 63 else v


# ---------------------------------------------------------------------------
# Host <-> tensor conversion
# ---------------------------------------------------------------------------


def from_u64(x: Union[int, Sequence[int], np.ndarray], device) -> torch.Tensor:
    """Python ints / numpy values (reduced mod p) -> int64 tensor on device."""
    arr = np.asarray(x)
    if arr.dtype == np.uint64:
        flat = arr % np.uint64(P)
    else:
        obj = np.asarray(x, dtype=np.object_)
        flat = np.array(
            [int(v) % P for v in obj.reshape(-1)], dtype=np.uint64
        ).reshape(obj.shape)
    flat = np.ascontiguousarray(flat)
    return torch.from_numpy(flat.view(np.int64).copy()).to(device)


def to_u64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().view(np.uint64)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.int64, device=device)


def full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, to_i64(value), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Unsigned helpers on int64 bit patterns
# ---------------------------------------------------------------------------


def _ult(a, b):
    """a < b as unsigned 64-bit values."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _shr32(a):
    """Logical right shift by 32."""
    return (a >> 32) & MASK32


def canon(v: torch.Tensor) -> torch.Tensor:
    """Any u64 bit pattern -> its residue in [0, p) (one subtraction
    suffices since 2^64 < 2p)."""
    return torch.where((v ^ _SIGN) >= _P_FLIP, v - _P_I64, v)


# ---------------------------------------------------------------------------
# Field ops
# ---------------------------------------------------------------------------


def add(a, b):
    s = a + b
    # a carry out of 2^64 is worth 2^64 = EPSILON (mod p); cannot re-carry
    # for canonical inputs
    s = torch.where(_ult(s, a), s + EPSILON, s)
    return canon(s)


def sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d - EPSILON, d)


def neg(a):
    return torch.where(a != 0, _P_I64 - a, a)


def _mul_wide(a, b):
    """(lo64, hi64) of the 128-bit product, from 32-bit limbs."""
    a0 = a & MASK32
    a1 = _shr32(a)
    b0 = b & MASK32
    b1 = _shr32(b)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + p10
    midc = _ult(mid, p01).to(torch.int64)
    lo = p00 + (mid << 32)
    c2 = _ult(lo, p00).to(torch.int64)
    hi = p11 + _shr32(mid) + (midc << 32) + c2
    return lo, hi


def _reduce128(lo, hi):
    """lo + hi * 2^64 mod p, using 2^64 = 2^32 - 1 and 2^96 = -1."""
    hi_lo = hi & MASK32
    hi_hi = _shr32(hi)
    t0 = lo - hi_hi
    t0 = torch.where(_ult(lo, hi_hi), t0 - EPSILON, t0)
    t1 = (hi_lo << 32) - hi_lo
    s = t0 + t1
    s = torch.where(_ult(s, t1), s + EPSILON, s)
    return canon(s)


def mul(a, b):
    return _reduce128(*_mul_wide(a, b))


def sqr(a):
    return mul(a, a)


def mul_const(a, c: int):
    # a Python-int operand rides along as a kernel scalar: no device copy
    return _reduce128(*_mul_wide(a, c % P))


def add_const(a, c: int):
    return add(a, to_i64(c))


def pow_const(a, e: int):
    """a^e for a Python-int exponent (square and multiply)."""
    e %= P - 1
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = sqr(base)
    return result


def exp7(a):
    a2 = sqr(a)
    a3 = mul(a2, a)
    a4 = sqr(a2)
    return mul(a4, a3)


def inv(a):
    """a^(p-2); inv(0) = 0."""
    return pow_const(a, P - 2)


def sum_axis(a, axis=-1):
    """Field sum along an axis by pairwise halving (log depth)."""
    x = torch.movedim(a, axis, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        red = add(x[:half], x[half : 2 * half])
        if x.shape[0] % 2:
            red = torch.cat([red, x[2 * half :]], dim=0)
        x = red
    return x[0]

