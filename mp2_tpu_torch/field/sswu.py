"""Simplified SWU map GF(p^5) -> EcGFp5, host-exact.

Mirrors the reference's value-side map
(the reference's mp2-common/src/group_hashing/sswu_value.rs:31-78) including
its exact constants (utils.rs) and edge-case conventions; verified against the
reference's published test vectors in tests/test_curve.py.

A jax-free copy of `mp2_tpu/field/sswu.py`: only the imports change.
"""

from __future__ import annotations

from mp2_tpu_torch.field import gfp5
from mp2_tpu_torch.field.ecgfp5 import A_SW, B_SW, TWO_THIRDS, Point
from mp2_tpu_torch.field.gfp5 import ONE, ZERO, Quint
from mp2_tpu_torch.field.goldilocks import P

# SSWU non-square Z (short-Weierstrass side): Z_sw = -4 - z.
Z_SW: Quint = ((P - 4) % P, P - 1, 0, 0, 0)
NEG_Z_INV_SW: Quint = gfp5.neg(gfp5.inv(Z_SW))
NEG_B_DIV_A_SW: Quint = gfp5.neg(gfp5.div(B_SW, A_SW))


def _g_sw(x: Quint) -> Quint:
    """g(x) = x^3 + A_sw x + B_sw."""
    return gfp5.add(gfp5.add(gfp5.mul(x, gfp5.square(x)), gfp5.mul(A_SW, x)), B_SW)


def simple_swu(u: Quint) -> Point:
    """Map a quintic field element to a curve point (constant structure)."""
    denom_part = gfp5.mul(Z_SW, gfp5.square(u))
    denom = gfp5.add(gfp5.square(denom_part), denom_part)
    tv1 = gfp5.inv(denom)  # inverse_or_zero

    if tv1 == ZERO:
        x1 = gfp5.mul(NEG_Z_INV_SW, NEG_B_DIV_A_SW)
    else:
        x1 = gfp5.mul(gfp5.add(tv1, ONE), NEG_B_DIV_A_SW)
    x2 = gfp5.mul(denom_part, x1)

    gx1 = _g_sw(x1)
    gx2 = _g_sw(x2)

    root1 = gfp5.sqrt(gx1)
    if root1 is not None:
        x_sw, y_pos = x1, root1
    else:
        x_sw, y_pos = x2, gfp5.sqrt(gx2)
        assert y_pos is not None, "SSWU: neither gx1 nor gx2 is square"

    x_cand = gfp5.sub(x_sw, TWO_THIRDS)
    y_cand = y_pos if gfp5.sgn0(u) == gfp5.sgn0(y_pos) else gfp5.neg(y_pos)

    w = gfp5.div(y_cand, x_cand)
    pt = Point.decode(w)
    assert pt is not None, "SSWU produced an undecodable w"
    return pt
