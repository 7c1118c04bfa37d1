"""GF(p^5) = GF(p)[z]/(z^5 - 3), host-exact arithmetic (python ints).

The degree-5 extension of Goldilocks underlying the EcGFp5 digest curve
(reference: plonky2_ecgfp5 dependency; used by
the reference's mp2-common/src/group_hashing/ for the order-agnostic multiset
digest accumulator).  This module is the *host golden model*: exact python-int
arithmetic used by tree building, out-of-circuit digest computation, and as
the reference for the batched JAX/Pallas versions.

Key facts exploited:
  * p = 1 (mod 5), so Frobenius is diagonal: (z^i)^p = gamma^i * z^i with
    gamma = 3^((p-1)/5).
  * The 2-Sylow subgroup of GF(p^5)* has order 2^32 and lies inside GF(p)*,
    so Tonelli-Shanks square roots use base-field fixup factors.

A jax-free copy of `mp2_tpu/field/gfp5.py`: only the imports change.
"""

from __future__ import annotations

from typing import Tuple

from mp2_tpu_torch.field.goldilocks import P

# Non-residue defining the extension: z^5 = 3.
W5 = 3

# gamma = 3^((p-1)/5): Frobenius diagonal base.
_GAMMA = pow(W5, (P - 1) // 5, P)
# FROB_COEFFS[k][i] = gamma^(i*k): coefficient scaling for frobenius^k.
FROB_COEFFS = [[pow(_GAMMA, i * k, P) for i in range(5)] for k in range(5)]

# p^5 - 1 = 2^32 * S_ODD with S_ODD odd.
_M = 1 + P + P * P + P**3 + P**4
S_ODD = ((P - 1) >> 32) * _M
assert S_ODD % 2 == 1
# Generator of the order-2^32 subgroup (lives in GF(p)).
_G32 = pow(7, (P - 1) >> 32, P)

Quint = Tuple[int, int, int, int, int]

ZERO: Quint = (0, 0, 0, 0, 0)
ONE: Quint = (1, 0, 0, 0, 0)


def from_base(c: int) -> Quint:
    return (c % P, 0, 0, 0, 0)


def add(a: Quint, b: Quint) -> Quint:
    return tuple((x + y) % P for x, y in zip(a, b))


def sub(a: Quint, b: Quint) -> Quint:
    return tuple((x - y) % P for x, y in zip(a, b))


def neg(a: Quint) -> Quint:
    return tuple((-x) % P for x in a)


def scalar_mul(c: int, a: Quint) -> Quint:
    return tuple((c * x) % P for x in a)


def mul(a: Quint, b: Quint) -> Quint:
    # Schoolbook product, degree folded with z^5 = 3.
    acc = [0] * 9
    for i in range(5):
        ai = a[i]
        if ai:
            for j in range(5):
                acc[i + j] += ai * b[j]
    return tuple((acc[k] + W5 * acc[k + 5]) % P for k in range(4)) + (
        acc[4] % P,
    )


def square(a: Quint) -> Quint:
    return mul(a, a)


def frobenius(a: Quint, k: int = 1) -> Quint:
    co = FROB_COEFFS[k % 5]
    return tuple((a[i] * co[i]) % P for i in range(5))


def norm(a: Quint) -> int:
    """N(a) = a^(1+p+p^2+p^3+p^4) in GF(p)."""
    t = mul(frobenius(a, 1), frobenius(a, 2))
    t = mul(t, mul(frobenius(a, 3), frobenius(a, 4)))
    full = mul(a, t)
    # The norm lands in the base field.
    assert all(c == 0 for c in full[1:]), "norm must be scalar"
    return full[0]


def inv(a: Quint) -> Quint:
    """Itoh-Tsujii: a^-1 = (prod of conjugates) / N(a).  inv(0) = 0."""
    if a == ZERO:
        return ZERO
    t = mul(frobenius(a, 1), frobenius(a, 2))
    t = mul(t, mul(frobenius(a, 3), frobenius(a, 4)))
    n = mul(a, t)[0]
    return scalar_mul(pow(n, P - 2, P), t)


def div(a: Quint, b: Quint) -> Quint:
    return mul(a, inv(b))


def pow_int(a: Quint, e: int) -> Quint:
    r = ONE
    base = a
    while e:
        if e & 1:
            r = mul(r, base)
        base = square(base)
        e >>= 1
    return r


def is_square(a: Quint) -> bool:
    """Legendre via norm: a square in GF(p^5) iff N(a) square in GF(p)."""
    if a == ZERO:
        return True
    return pow(norm(a), (P - 1) // 2, P) == 1


def sqrt(a: Quint) -> Quint | None:
    """Tonelli-Shanks; returns one of the two roots, or None if non-square.

    The 2-Sylow of GF(p^5)* lies in GF(p)*, so the fixup chain uses
    base-field scalars only.
    """
    if a == ZERO:
        return ZERO
    if not is_square(a):
        return None
    r = pow_int(a, (S_ODD + 1) // 2)
    # t = a^S_ODD lies in the base-field 2^32-torsion.
    t_full = pow_int(a, S_ODD)
    assert all(c == 0 for c in t_full[1:])
    t = t_full[0]
    m = 32
    c = _G32
    while t != 1:
        # least i with t^(2^i) == 1
        i = 0
        tt = t
        while tt != 1:
            tt = tt * tt % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m = i
        c = b * b % P
        t = t * c % P
        r = scalar_mul(b, r)
    return r


def sgn0(a: Quint) -> int:
    """Sign of a quintic element: parity of the lowest-degree non-zero
    coefficient (0 for zero).  Matches plonky2_ecgfp5's Sgn0 convention,
    pinned down by the SSWU test vectors in
    the reference's mp2-common/src/group_hashing/sswu_value.rs:85-121.
    """
    for c in a:
        if c:
            return c & 1
    return 0
