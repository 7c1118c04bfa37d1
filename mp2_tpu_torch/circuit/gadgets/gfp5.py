"""In-circuit GF(p^5) = GF(p)[z]/(z^5 - 3) arithmetic.

The digest field of the group-hashing commitment scheme (reference:
plonky2_ecgfp5 gadgets used by mp2-common/src/group_hashing/).  Elements are
5-tuples of base targets mirroring `mp2_tpu_torch.field.gfp5` limb-for-limb, so
in-circuit digests land bit-identical to the host accumulation.

A jax-free copy of `mp2_tpu/circuit/gadgets/gfp5.py`: only the imports change.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.field import gfp5
from mp2_tpu_torch.field.goldilocks import P

W5 = 3  # z^5 = 3

QuintTarget = Tuple[Target, Target, Target, Target, Target]


def q_zero(b: CircuitBuilder) -> QuintTarget:
    z = b.zero()
    return (z, z, z, z, z)


def q_one(b: CircuitBuilder) -> QuintTarget:
    return (b.one(), b.zero(), b.zero(), b.zero(), b.zero())


def q_constant(b: CircuitBuilder, c: Sequence[int]) -> QuintTarget:
    return tuple(b.constant(int(v)) for v in c)


def q_from_base(b: CircuitBuilder, t: Target) -> QuintTarget:
    z = b.zero()
    return (t, z, z, z, z)


def q_add(b: CircuitBuilder, x: QuintTarget, y: QuintTarget) -> QuintTarget:
    return tuple(b.add(a, c) for a, c in zip(x, y))


def q_sub(b: CircuitBuilder, x: QuintTarget, y: QuintTarget) -> QuintTarget:
    return tuple(b.sub(a, c) for a, c in zip(x, y))


def q_neg(b: CircuitBuilder, x: QuintTarget) -> QuintTarget:
    return tuple(b.mul_const(P - 1, a) for a in x)


def q_scalar_mul(b: CircuitBuilder, c: int, x: QuintTarget) -> QuintTarget:
    return tuple(b.mul_const(c % P, a) for a in x)


def q_mul(b: CircuitBuilder, x: QuintTarget, y: QuintTarget) -> QuintTarget:
    """Schoolbook with z^5 = 3: c_k = sum_{i+j=k} + 3 * sum_{i+j=k+5}."""
    out = []
    for k in range(5):
        acc = None
        for i in range(5):
            j = k - i
            if 0 <= j < 5:
                t = b.mul(x[i], y[j])
                acc = t if acc is None else b.add(acc, t)
        acc3 = None
        for i in range(5):
            j = k + 5 - i
            if 0 <= j < 5:
                t = b.mul(x[i], y[j])
                acc3 = t if acc3 is None else b.add(acc3, t)
        if acc3 is not None:
            acc = b.add(acc, b.mul_const(W5, acc3))
        out.append(acc)
    return tuple(out)


def q_square(b: CircuitBuilder, x: QuintTarget) -> QuintTarget:
    return q_mul(b, x, x)


def q_select(
    b: CircuitBuilder, bit: Target, x: QuintTarget, y: QuintTarget
) -> QuintTarget:
    return tuple(b.select(bit, a, c) for a, c in zip(x, y))


def q_is_zero(b: CircuitBuilder, x: QuintTarget) -> Target:
    acc = None
    for a in x:
        z = b.is_zero(a)
        acc = z if acc is None else b.logic_and(acc, z)
    return acc


def q_is_equal(b: CircuitBuilder, x: QuintTarget, y: QuintTarget) -> Target:
    return q_is_zero(b, q_sub(b, x, y))


def q_connect(b: CircuitBuilder, x: QuintTarget, y: QuintTarget) -> None:
    for a, c in zip(x, y):
        b.connect(a, c)


def _read_quint(read, x: QuintTarget) -> Tuple[int, ...]:
    return tuple(read(t) for t in x)


def q_witness(b: CircuitBuilder, fn) -> QuintTarget:
    """Allocate a quint whose limbs are generated by fn(read) -> Quint."""
    ts = tuple(b.add_input() for _ in range(5))
    for i, t in enumerate(ts):
        b.add_generator(t, lambda read, i=i, fn=fn: int(fn(read)[i]) % P)
    return ts


def q_inverse_or_zero(
    b: CircuitBuilder, x: QuintTarget
) -> Tuple[QuintTarget, Target]:
    """(x^-1 or 0, is_zero flag) with full constraints:
    x * inv == (1 - z, 0, 0, 0, 0) and z * inv == 0."""
    z = q_is_zero(b, x)

    def gen(read, x=x):
        xv = _read_quint(read, x)
        return gfp5.inv(xv) if any(xv) else gfp5.ZERO

    inv = q_witness(b, gen)
    prod = q_mul(b, x, inv)
    b.connect(prod[0], b.logic_not(z))
    for i in range(1, 5):
        b.connect(prod[i], b.zero())
    for t in inv:
        b.connect(b.mul(z, t), b.zero())
    return inv, z


def q_inv(b: CircuitBuilder, x: QuintTarget) -> QuintTarget:
    """Witnessed inverse; constrains x * inv == 1 (so x != 0)."""

    def gen(read, x=x):
        xv = _read_quint(read, x)
        return gfp5.inv(xv) if any(xv) else gfp5.ZERO

    inv = q_witness(b, gen)
    prod = q_mul(b, x, inv)
    q_connect(b, prod, q_one(b))
    return inv


def q_div(b: CircuitBuilder, x: QuintTarget, y: QuintTarget) -> QuintTarget:
    return q_mul(b, x, q_inv(b, y))


# A fixed quadratic non-residue of GF(p^5): the base element 7 (non-QR in
# GF(p), and 5 is odd so it stays a non-square in the extension); verified
# host-side at import.
NQR: Tuple[int, ...] = (7, 0, 0, 0, 0)
assert not gfp5.is_square(NQR), "NQR constant must be a non-square"


def q_sqrt_branch(
    b: CircuitBuilder, g1: QuintTarget, g2: QuintTarget
) -> Tuple[Target, QuintTarget]:
    """Given that EXACTLY ONE of (g1, g2) is a nonzero square, witness the
    selection bit s (1 if g1 is square) and the root y with
    y^2 == select(s, g1, g2).  Used by the SSWU gadget where gx1*gx2 is a
    non-square by construction, so s cannot be forged."""

    def gen_s(read, g1=g1):
        v1 = _read_quint(read, g1)
        return 1 if gfp5.sqrt(v1) is not None else 0

    s = b.add_input()
    b.add_generator(s, gen_s)
    b.connect(b.mul(s, s), s)  # boolean

    def gen_y(read, g1=g1, g2=g2):
        v1 = _read_quint(read, g1)
        r = gfp5.sqrt(v1)
        if r is None:
            r = gfp5.sqrt(_read_quint(read, g2))
        return r if r is not None else gfp5.ZERO

    y = q_witness(b, gen_y)
    target = q_select(b, s, g1, g2)
    q_connect(b, q_square(b, y), target)
    return s, y


def q_prove_square(b: CircuitBuilder, x: QuintTarget) -> None:
    """Constrain x to be a square (witnessed root)."""

    def gen(read, x=x):
        r = gfp5.sqrt(_read_quint(read, x))
        return r if r is not None else gfp5.ZERO

    r = q_witness(b, gen)
    q_connect(b, q_square(b, r), x)


def q_prove_nonsquare_if(
    b: CircuitBuilder, active: Target, x: QuintTarget
) -> None:
    """When `active` (boolean) is 1, constrain nonzero x to be a NON-square
    (witnessed root of x * NQR); no constraint when active is 0."""
    xn = q_mul(b, x, q_constant(b, NQR))

    def gen(read, xn=xn, active=active):
        if not read(active):
            return gfp5.ZERO
        r = gfp5.sqrt(_read_quint(read, xn))
        return r if r is not None else gfp5.ZERO

    r = q_witness(b, gen)
    diff = q_sub(b, q_square(b, r), xn)
    for limb in diff:
        b.connect(b.mul(active, limb), b.zero())


def q_prove_nonsquare(b: CircuitBuilder, x: QuintTarget) -> None:
    """Constrain nonzero x to be a NON-square: x * NQR is then a square
    (odd-order multiplicative group), witnessed by its root."""
    xn = q_mul(b, x, q_constant(b, NQR))

    def gen(read, xn=xn):
        r = gfp5.sqrt(_read_quint(read, xn))
        return r if r is not None else gfp5.ZERO

    r = q_witness(b, gen)
    q_connect(b, q_square(b, r), xn)


def canonical_u64_bits(b: CircuitBuilder, t: Target) -> List[Target]:
    """64-bit LE decomposition constrained to the CANONICAL value:
    rejects the shifted-by-p representation (value >= p iff the high 32
    bits are all ones and the low 32 bits are nonzero)."""
    bits = b.decompose_bits(t, 64)
    lo = None
    hi = None
    for k in range(32):
        term = b.mul_const(1 << k, bits[k])
        lo = term if lo is None else b.add(lo, term)
        term_h = b.mul_const(1 << k, bits[32 + k])
        hi = term_h if hi is None else b.add(hi, term_h)
    hi_all_ones = b.is_equal(hi, b.constant((1 << 32) - 1))
    lo_nonzero = b.logic_not(b.is_zero(lo))
    b.connect(b.logic_and(hi_all_ones, lo_nonzero), b.zero())
    return bits


def q_sgn0(b: CircuitBuilder, x: QuintTarget) -> Target:
    """Parity of the lowest-degree nonzero coefficient (gfp5.sgn0),
    computed over canonical 64-bit decompositions."""
    sgn = b.zero()
    found = b.zero()
    for limb in x:
        bits = canonical_u64_bits(b, limb)
        parity = bits[0]
        nonzero = b.logic_not(b.is_zero(limb))
        use = b.logic_and(b.logic_not(found), nonzero)
        sgn = b.add(sgn, b.mul(use, parity))
        found = b.logic_or(found, nonzero)
    return sgn
