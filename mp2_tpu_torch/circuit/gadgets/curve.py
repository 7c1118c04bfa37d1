"""In-circuit EcGFp5: complete point addition + SSWU map-to-curve.

The digest accumulator of the whole system (reference: mp2-common/src/
group_hashing/{mod.rs:56-197, sswu_gadget.rs, curve_add.rs} over
plonky2_ecgfp5): circuits commit to extracted values as order-agnostic sums
of curve points.  Every formula mirrors `mp2_tpu_torch.field.ecgfp5`/`sswu`
branch-for-branch (double-odd coordinates, coset-fixup add, decode
convention), so in-circuit digests are bit-identical to host digests —
tested against the reference's published SSWU vectors.

A jax-free copy of `mp2_tpu/circuit/gadgets/curve.py`: only the imports change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.gfp5 import (
    QuintTarget,
    q_add,
    q_connect,
    q_constant,
    q_div,
    q_inverse_or_zero,
    q_is_equal,
    q_is_zero,
    q_mul,
    q_neg,
    q_one,
    q_prove_nonsquare,
    q_prove_nonsquare_if,
    q_scalar_mul,
    q_select,
    q_sgn0,
    q_square,
    q_sub,
    q_witness,
    q_zero,
    _read_quint,
)
from mp2_tpu_torch.field import gfp5
from mp2_tpu_torch.field.ecgfp5 import A_DO, A_SW, B_DO, B_SW, TWO_THIRDS, Point
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.field.sswu import NEG_B_DIV_A_SW, NEG_Z_INV_SW, Z_SW


@dataclass(frozen=True)
class CurveTarget:
    """A group element in double-odd representative coordinates
    (x, y, is_neutral) — the in-circuit mirror of field.ecgfp5.Point."""

    x: QuintTarget
    y: QuintTarget
    is_neutral: Target


def curve_zero(b: CircuitBuilder) -> CurveTarget:
    return CurveTarget(q_zero(b), q_zero(b), b.one())


def curve_constant(b: CircuitBuilder, p: Point) -> CurveTarget:
    return CurveTarget(
        q_constant(b, p.x),
        q_constant(b, p.y),
        b.one() if p.is_neutral else b.zero(),
    )


def curve_select(
    b: CircuitBuilder, bit: Target, p: CurveTarget, q: CurveTarget
) -> CurveTarget:
    return CurveTarget(
        q_select(b, bit, p.x, q.x),
        q_select(b, bit, p.y, q.y),
        b.select(bit, p.is_neutral, q.is_neutral),
    )


def curve_connect(b: CircuitBuilder, p: CurveTarget, q: CurveTarget) -> None:
    q_connect(b, p.x, q.x)
    q_connect(b, p.y, q.y)
    b.connect(p.is_neutral, q.is_neutral)


def _gated_slope(
    b: CircuitBuilder,
    active: Target,
    num: QuintTarget,
    den: QuintTarget,
) -> QuintTarget:
    """Witness lam with active * (lam*den - num) == 0."""

    def gen(read, num=num, den=den):
        nv = _read_quint(read, num)
        dv = _read_quint(read, den)
        if any(dv):
            return gfp5.div(nv, dv)
        return gfp5.ZERO

    lam = q_witness(b, gen)
    diff = q_sub(b, q_mul(b, lam, den), num)
    for limb in diff:
        b.connect(b.mul(active, limb), b.zero())
    return lam


def _ec_add_raw(
    b: CircuitBuilder,
    x1: QuintTarget, y1: QuintTarget, inf1: Target,
    x2: QuintTarget, y2: QuintTarget, inf2: Target,
) -> Tuple[QuintTarget, QuintTarget, Target]:
    """Complete chord-tangent addition on y^2 = x^3 + a x^2 + b x
    (field.ecgfp5._ec_add with None modelled as an inf flag)."""
    same_x = q_is_equal(b, x1, x2)
    y_sum_zero = q_is_zero(b, q_add(b, y1, y2))
    res_inf = b.logic_and(same_x, y_sum_zero)
    is_dbl = b.logic_and(same_x, b.logic_not(y_sum_zero))

    # doubling slope: (3 x^2 + 2 a x + b) / (2 y)
    a_q = q_constant(b, A_DO)
    b_q = q_constant(b, B_DO)
    num_dbl = q_add(
        b,
        q_add(
            b,
            q_scalar_mul(b, 3, q_square(b, x1)),
            q_scalar_mul(b, 2, q_mul(b, a_q, x1)),
        ),
        b_q,
    )
    den_dbl = q_scalar_mul(b, 2, y1)
    num_add = q_sub(b, y2, y1)
    den_add = q_sub(b, x2, x1)
    num = q_select(b, is_dbl, num_dbl, num_add)
    den = q_select(b, is_dbl, den_dbl, den_add)
    finite = b.logic_and(
        b.logic_and(b.logic_not(inf1), b.logic_not(inf2)),
        b.logic_not(res_inf),
    )
    lam = _gated_slope(b, finite, num, den)

    # x3 = lam^2 - a - x1 - x2 ; y3 = lam (x1 - x3) - y1
    x3 = q_sub(b, q_sub(b, q_sub(b, q_square(b, lam), a_q), x1), x2)
    y3 = q_sub(b, q_mul(b, lam, q_sub(b, x1, x3)), y1)

    # result mux: inf1 -> P2 ; inf2 -> P1 ; res_inf -> infinity ; else P3
    rx = q_select(b, inf1, x2, q_select(b, inf2, x1, x3))
    ry = q_select(b, inf1, y2, q_select(b, inf2, y1, y3))
    rinf = b.select(
        inf1, inf2, b.select(inf2, inf1, res_inf)
    )
    return rx, ry, rinf


def curve_add(b: CircuitBuilder, p: CurveTarget, q: CurveTarget) -> CurveTarget:
    """Group addition mirroring Point.__add__ exactly: raw chord add, then
    `+ N` coset fixup, with neutral handling."""
    zero_q = q_zero(b)
    sx, sy, sinf = _ec_add_raw(
        b, p.x, p.y, p.is_neutral, q.x, q.y, q.is_neutral
    )
    # + N where N = (0, 0)
    tx, ty, tinf = _ec_add_raw(
        b, sx, sy, sinf, zero_q, zero_q, b.zero()
    )
    t_is_n = b.logic_and(q_is_zero(b, tx), q_is_zero(b, ty))
    neutral = b.logic_or(tinf, t_is_n)

    # either input neutral: result is the other input (host short-circuits
    # BEFORE the coset fixup)
    out = CurveTarget(
        q_select(b, neutral, zero_q, tx),
        q_select(b, neutral, zero_q, ty),
        neutral,
    )
    out = curve_select(b, q.is_neutral, p, out)
    out = curve_select(b, p.is_neutral, q, out)
    return out


def curve_sum(b: CircuitBuilder, points: Sequence[CurveTarget]) -> CurveTarget:
    acc = curve_zero(b)
    for p in points:
        acc = curve_add(b, acc, p)
    return acc


# ---------------------------------------------------------------------------
# SSWU map-to-curve (field.sswu.simple_swu mirrored)
# ---------------------------------------------------------------------------


def _g_sw(b: CircuitBuilder, x: QuintTarget) -> QuintTarget:
    a_sw = q_constant(b, A_SW)
    b_sw = q_constant(b, B_SW)
    return q_add(
        b, q_add(b, q_mul(b, x, q_square(b, x)), q_mul(b, a_sw, x)), b_sw
    )


def simple_swu_circuit(b: CircuitBuilder, u: QuintTarget) -> CurveTarget:
    z_sw = q_constant(b, Z_SW)
    dp = q_mul(b, z_sw, q_square(b, u))  # Z * u^2
    denom = q_add(b, q_square(b, dp), dp)
    tv1, tv1_zero = q_inverse_or_zero(b, denom)

    nbda = q_constant(b, NEG_B_DIV_A_SW)
    x1_deg = q_mul(b, q_constant(b, NEG_Z_INV_SW), nbda)
    x1_reg = q_mul(b, q_add(b, tv1, q_one(b)), nbda)
    x1 = q_select(b, tv1_zero, x1_deg, x1_reg)
    x2 = q_mul(b, dp, x1)

    gx1 = _g_sw(b, x1)
    gx2 = _g_sw(b, x2)

    # witness: which gx is square, and the root; host prefers gx1 when both
    # are square, so pin s: s == 0 forces gx1 to be a PROVEN non-square
    def gen_s(read, gx1=gx1):
        return 1 if gfp5.sqrt(_read_quint(read, gx1)) is not None else 0

    s = b.add_input()
    b.add_generator(s, gen_s)
    b.connect(b.mul(s, s), s)
    q_prove_nonsquare_if(b, b.logic_not(s), gx1)

    def gen_y(read, gx1=gx1, gx2=gx2):
        r = gfp5.sqrt(_read_quint(read, gx1))
        if r is None:
            r = gfp5.sqrt(_read_quint(read, gx2))
        return r if r is not None else gfp5.ZERO

    y_pos = q_witness(b, gen_y)
    q_connect(b, q_square(b, y_pos), q_select(b, s, gx1, gx2))
    x_sw = q_select(b, s, x1, x2)

    x_cand = q_sub(b, x_sw, q_constant(b, TWO_THIRDS))
    sgn_u = q_sgn0(b, u)
    sgn_y = q_sgn0(b, y_pos)
    same = b.logic_not(b.logic_xor(sgn_u, sgn_y))
    y_cand = q_select(b, same, y_pos, q_neg(b, y_pos))

    w = q_div(b, y_cand, x_cand)

    # decode w -> double-odd point (Point.decode): x is the NON-square root
    # of x^2 - e x + b with e = w^2 - a; witness both roots, constrain their
    # sum/product, prove the chosen one non-square (b non-square => exactly
    # one root is, so the choice is forced)
    e = q_sub(b, q_square(b, w), q_constant(b, A_DO))

    def gen_roots(read, e=e):
        ev = _read_quint(read, e)
        delta = gfp5.sub(gfp5.square(ev), gfp5.scalar_mul(4, B_DO))
        r = gfp5.sqrt(delta)
        if r is None:
            return gfp5.ZERO, gfp5.ZERO
        inv2 = pow(2, P - 2, P)
        x1d = gfp5.scalar_mul(inv2, gfp5.add(ev, r))
        x2d = gfp5.scalar_mul(inv2, gfp5.sub(ev, r))
        xd = x2d if gfp5.is_square(x1d) else x1d
        xo = x1d if gfp5.is_square(x1d) else x2d
        return xd, xo

    xd = q_witness(b, lambda read, g=gen_roots: g(read)[0])
    xo = q_witness(b, lambda read, g=gen_roots: g(read)[1])
    q_connect(b, q_add(b, xd, xo), e)
    q_connect(b, q_mul(b, xd, xo), q_constant(b, B_DO))
    q_prove_nonsquare(b, xd)
    y = q_mul(b, w, xd)

    # w == 0 decodes to the neutral element (never hit by honest SSWU)
    return CurveTarget(x=xd, y=y, is_neutral=q_is_zero(b, w))


def map_to_curve_point_circuit(
    b: CircuitBuilder, inputs: Sequence[Target]
) -> CurveTarget:
    """In-circuit D(values): Poseidon2-sponge to a quintic element, then
    SSWU (mirror of hash/poseidon2_host.map_to_curve_point)."""
    u = tuple(b.hash_n_to_m_no_pad(list(inputs), 5))
    return simple_swu_circuit(b, u)


# ---------------------------------------------------------------------------
# PI encoding (WeierstrassPoint layout, 11 field elements)
# ---------------------------------------------------------------------------


def curve_scalar_mul_hash128(
    b: CircuitBuilder, h0: Target, h1: Target, p: CurveTarget
) -> CurveTarget:
    """digest.scalar_mul(hash_to_int(h)): the 128-bit scalar is the
    canonical little-endian value of hash limbs (h[0], h[1])
    (mp2-common/src/poseidon.rs:106-131 hash_to_int convention).
    Double-and-add mirrors Point.scalar_mul bit-for-bit."""
    from mp2_tpu_torch.circuit.gadgets.gfp5 import canonical_u64_bits

    bits = canonical_u64_bits(b, h0) + canonical_u64_bits(b, h1)
    acc = curve_zero(b)
    base = p
    for i, bit in enumerate(bits):
        acc = curve_select(b, bit, curve_add(b, acc, base), acc)
        if i + 1 < len(bits):
            base = curve_add(b, base, base)
    return acc


def curve_to_pi_targets(b: CircuitBuilder, p: CurveTarget) -> List[Target]:
    """x_w || y || is_inf with x_w = (x + 2/3) zeroed when neutral —
    mirror of Point.to_fields (CURVE_TARGET_LEN = 11)."""
    tt = q_constant(b, TWO_THIRDS)
    xw = q_add(b, p.x, tt)
    not_inf = b.logic_not(p.is_neutral)
    out = [b.mul(c, not_inf) for c in xw]
    out += [b.mul(c, not_inf) for c in p.y]
    out.append(p.is_neutral)
    return out


def curve_from_pi_targets(
    b: CircuitBuilder, pis: Sequence[Target]
) -> CurveTarget:
    """Inverse of curve_to_pi_targets (Point.from_fields): 11 targets
    x_w || y || is_inf -> double-odd representative coordinates."""
    assert len(pis) == 11
    inf = pis[10]
    b.connect(b.mul(inf, inf), inf)  # boolean
    tt = q_constant(b, TWO_THIRDS)
    x = q_sub(b, tuple(pis[0:5]), tt)
    zero = q_zero(b)
    return CurveTarget(
        x=q_select(b, inf, zero, x),
        y=q_select(b, inf, zero, tuple(pis[5:10])),
        is_neutral=inf,
    )
