"""EcGFp5: the digest curve over GF(p^5), host-exact group operations.

Double-odd curve E: y^2 = x(x^2 + a*x + b) over GF(p^5), with a = 2 and
b = 263*z (z the quintic generator), as used by the reference's group-hashing
digest accumulator (constants documented at
the reference's mp2-common/src/group_hashing/utils.rs:19-46).

Group model (double-odd construction): the prime-order group G is the coset
E[n] + N where N = (0,0) is the 2-torsion point.  A group element g is stored
as its canonical coset representative P' = Q + N (Q in E[n]); the identity is
represented by N itself (encoded as w = 0, exported to public inputs as the
point-at-infinity flag).  With b a non-square, every non-identity
representative has a NON-square x-coordinate, which is the root-selection rule
used by decode().

Encoding: w = y/x of the representative (w = 0 for identity).  decode(w)
solves x^2 + (a - w^2) x + b = 0 and keeps the non-square root.

Group law on representatives: since N has order 2,
    rep(g1 + g2) = P'_1 + P'_2 + N   (chord-tangent on E),
with the convention that a result landing exactly on N means the identity.

Weierstrass export: (x + a/3, y) of the representative, matching the
reference's `to_weierstrass` public-input layout (5 + 5 + 1 field elements,
CURVE_TARGET_LEN = 11, the reference's mp2-common/src/types.rs).

A jax-free copy of `mp2_tpu/field/ecgfp5.py`: only the imports change.
"""

from __future__ import annotations

from typing import Optional, Tuple

from mp2_tpu_torch.field import gfp5
from mp2_tpu_torch.field.gfp5 import Quint, ZERO
from mp2_tpu_torch.field.goldilocks import P

# Double-odd coefficients.
A_DO: Quint = (2, 0, 0, 0, 0)
B_DO: Quint = (0, 263, 0, 0, 0)

# Short-Weierstrass form (x_sw = x_do + a/3): y^2 = x^3 + A_SW x + B_SW.
_THIRD = pow(3, P - 2, P)
TWO_THIRDS: Quint = (2 * _THIRD % P, 0, 0, 0, 0)
# A_SW = b - a^2/3 ; B_SW = a(2a^2 - 9b)/27
A_SW: Quint = gfp5.sub(B_DO, gfp5.scalar_mul(4 * _THIRD % P, gfp5.ONE))
B_SW: Quint = gfp5.scalar_mul(
    pow(27, P - 2, P),
    gfp5.sub(gfp5.scalar_mul(16, gfp5.ONE), gfp5.scalar_mul(18, B_DO)),
)

# Chord-tangent infinity is modelled as None; N = (0, 0).
_AffOrInf = Optional[Tuple[Quint, Quint]]
_N_PT: Tuple[Quint, Quint] = (ZERO, ZERO)


def _curve_rhs_do(x: Quint) -> Quint:
    """y^2 = x(x^2 + a x + b) in double-odd coordinates."""
    return gfp5.mul(x, gfp5.add(gfp5.mul(x, gfp5.add(x, A_DO)), B_DO))


def _ec_add(p: _AffOrInf, q: _AffOrInf) -> _AffOrInf:
    """Affine chord-tangent addition on y^2 = x^3 + a x^2 + b x."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if gfp5.add(y1, y2) == ZERO:
            return None  # P + (-P)
        # doubling: lambda = (3x^2 + 2 a x + b) / (2 y)
        num = gfp5.add(
            gfp5.add(
                gfp5.scalar_mul(3, gfp5.square(x1)),
                gfp5.scalar_mul(2, gfp5.mul(A_DO, x1)),
            ),
            B_DO,
        )
        lam = gfp5.div(num, gfp5.scalar_mul(2, y1))
    else:
        lam = gfp5.div(gfp5.sub(y2, y1), gfp5.sub(x2, x1))
    # x3 = lambda^2 - a - x1 - x2  (the curve carries an x^2 term)
    x3 = gfp5.sub(gfp5.sub(gfp5.sub(gfp5.square(lam), A_DO), x1), x2)
    y3 = gfp5.sub(gfp5.mul(lam, gfp5.sub(x1, x3)), y1)
    return (x3, y3)


class Point:
    """A group element of EcGFp5 (coset representative or identity)."""

    __slots__ = ("x", "y", "is_neutral")

    def __init__(self, x: Quint, y: Quint, is_neutral: bool = False):
        self.x = x
        self.y = y
        self.is_neutral = is_neutral

    # -- constructors -------------------------------------------------------
    @staticmethod
    def neutral() -> "Point":
        return Point(ZERO, ZERO, True)

    @staticmethod
    def decode(w: Quint) -> Optional["Point"]:
        """Decode from w = y/x; None if w is not a valid encoding."""
        if w == ZERO:
            return Point.neutral()
        e = gfp5.sub(gfp5.square(w), A_DO)  # x^2 - e*x + b = 0
        delta = gfp5.sub(gfp5.square(e), gfp5.scalar_mul(4, B_DO))
        r = gfp5.sqrt(delta)
        if r is None:
            return None
        inv2 = pow(2, P - 2, P)
        x1 = gfp5.scalar_mul(inv2, gfp5.add(e, r))
        x2 = gfp5.scalar_mul(inv2, gfp5.sub(e, r))
        x = x2 if gfp5.is_square(x1) else x1
        y = gfp5.mul(w, x)
        return Point(x, y, False)

    def encode(self) -> Quint:
        if self.is_neutral:
            return ZERO
        return gfp5.div(self.y, self.x)

    # -- group law ----------------------------------------------------------
    def __add__(self, other: "Point") -> "Point":
        if self.is_neutral:
            return other
        if other.is_neutral:
            return self
        s = _ec_add((self.x, self.y), (other.x, other.y))
        s = _ec_add(s, _N_PT)  # + N: back onto the coset
        if s is None or s == _N_PT:
            # Landing on N (or formally past it) means Q1 + Q2 = infinity.
            return Point.neutral()
        return Point(s[0], s[1], False)

    def __neg__(self) -> "Point":
        if self.is_neutral:
            return self
        return Point(self.x, gfp5.neg(self.y), False)

    def __sub__(self, other: "Point") -> "Point":
        return self + (-other)

    def double(self) -> "Point":
        return self + self

    def scalar_mul(self, k: int) -> "Point":
        if k < 0:
            return (-self).scalar_mul(-k)
        r = Point.neutral()
        base = self
        while k:
            if k & 1:
                r = r + base
            base = base.double()
            k >>= 1
        return r

    def __eq__(self, other) -> bool:
        if not isinstance(other, Point):
            return NotImplemented
        if self.is_neutral or other.is_neutral:
            return self.is_neutral and other.is_neutral
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash((self.x, self.y, self.is_neutral))

    def __repr__(self):
        if self.is_neutral:
            return "Point(neutral)"
        return f"Point(x={self.x}, y={self.y})"

    # -- validation & export ------------------------------------------------
    def is_valid(self) -> bool:
        if self.is_neutral:
            return True
        on_curve = gfp5.square(self.y) == _curve_rhs_do(self.x)
        return on_curve and not gfp5.is_square(self.x)

    def to_weierstrass(self) -> Tuple[Quint, Quint, bool]:
        """(x + a/3, y, is_inf): the reference's WeierstrassPoint PI layout."""
        if self.is_neutral:
            return (ZERO, ZERO, True)
        return (gfp5.add(self.x, TWO_THIRDS), self.y, False)

    @staticmethod
    def from_weierstrass(x: Quint, y: Quint, is_inf: bool) -> "Point":
        if is_inf:
            return Point.neutral()
        return Point(gfp5.sub(x, TWO_THIRDS), y, False)

    def to_fields(self) -> list:
        """Flatten to 11 base-field elements (x || y || is_inf)."""
        x, y, inf = self.to_weierstrass()
        return list(x) + list(y) + [1 if inf else 0]

    @staticmethod
    def from_fields(v) -> "Point":
        assert len(v) == 11
        return Point.from_weierstrass(tuple(v[0:5]), tuple(v[5:10]), bool(v[10]))


NEUTRAL = Point.neutral()


def add_points(points) -> Point:
    """Multiset digest accumulation: order-agnostic sum of curve points
    (reference: add_curve_point, group_hashing/curve_add.rs:17-21)."""
    acc = NEUTRAL
    for p in points:
        acc = acc + p
    return acc
