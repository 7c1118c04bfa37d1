"""In-circuit 256-bit unsigned arithmetic as 8 x u32 big-endian limbs.

Role of the reference's `UInt256Target`/`CircuitBuilderU256`
(mp2-common/src/u256.rs:43-222): limbs are range-checked via bit
decomposition; comparisons run an LSB-to-MSB borrow chain with
range-checked limb differences; addition runs the dual carry chain.

A jax-free copy of `mp2_tpu/circuit/gadgets/u256.py`: only the imports change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.utils.u256 import NUM_LIMBS, u256_from_fields, u256_to_fields

TWO32 = 1 << 32


@dataclass(frozen=True)
class U256Target:
    """8 u32 limb targets, big-endian (limbs[0] most significant)."""

    limbs: Tuple[Target, ...]

    def __post_init__(self):
        assert len(self.limbs) == NUM_LIMBS


def add_virtual_u256(b: CircuitBuilder, range_check: bool = True) -> U256Target:
    limbs = tuple(b.add_inputs(NUM_LIMBS))
    if range_check:
        for t in limbs:
            b.assert_u32(t)
    return U256Target(limbs)


def set_u256(inputs: dict, t: U256Target, value: int):
    """Fill a witness-inputs dict with the limb values."""
    for limb_t, v in zip(t.limbs, u256_to_fields(value)):
        inputs[limb_t] = v


def u256_constant(b: CircuitBuilder, value: int) -> U256Target:
    return U256Target(tuple(b.constant(v) for v in u256_to_fields(value)))


def u256_equal(b: CircuitBuilder, x: U256Target, y: U256Target) -> Target:
    acc = None
    for xi, yi in zip(x.limbs, y.limbs):
        e = b.is_equal(xi, yi)
        acc = e if acc is None else b.logic_and(acc, e)
    return acc


def u256_sub(
    b: CircuitBuilder, x: U256Target, y: U256Target
) -> Tuple[U256Target, Target]:
    """(x - y) mod 2^256 and the borrow-out bit, via the borrow chain
    d_i = x_i - y_i - borrow_in + 2^32 * borrow_out, d_i in [0, 2^32)."""
    borrow = b.zero()
    out: List[Target] = [None] * NUM_LIMBS
    # walk LSB -> MSB (limbs are big-endian)
    for i in range(NUM_LIMBS - 1, -1, -1):
        xi, yi = x.limbs[i], y.limbs[i]
        d = b.add_input()
        nb = b.add_input()

        def gen_pair(read, xi=xi, yi=yi, borrow=borrow):
            v = read(xi) - read(yi) - read(borrow)
            return v % TWO32, 1 if v < 0 else 0

        b.add_generator(d, lambda read, g=gen_pair: g(read)[0])
        b.add_generator(nb, lambda read, g=gen_pair: g(read)[1])
        b.decompose_bits(d, 32)
        b.decompose_bits(nb, 1)
        # x_i - y_i - borrow + 2^32*nb - d == 0
        lhs = b.sub(b.sub(xi, yi), borrow)
        lhs = b.add(lhs, b.mul_const(TWO32 % P, nb))
        lhs = b.sub(lhs, d)
        b.connect(lhs, b.zero())
        out[i] = d
        borrow = nb
    return U256Target(tuple(out)), borrow


def u256_less_than(b: CircuitBuilder, x: U256Target, y: U256Target) -> Target:
    """x < y as a boolean target (borrow-out of x - y)."""
    return u256_sub(b, x, y)[1]


def u256_is_zero(b: CircuitBuilder, x: U256Target) -> Target:
    acc = None
    for xi in x.limbs:
        z = b.is_zero(xi)
        acc = z if acc is None else b.logic_and(acc, z)
    return acc


def u256_from_bool(b: CircuitBuilder, bit: Target) -> U256Target:
    """Embed a boolean target as a u256 (value 0 or 1)."""
    z = b.zero()
    return U256Target(tuple([z] * (NUM_LIMBS - 1) + [bit]))


def u256_lte(b: CircuitBuilder, x: U256Target, y: U256Target) -> Target:
    return b.logic_not(u256_less_than(b, y, x))


def u256_add(
    b: CircuitBuilder, x: U256Target, y: U256Target
) -> Tuple[U256Target, Target]:
    """(x + y) mod 2^256 and the overflow bit, via the carry chain."""
    carry = b.zero()
    out: List[Target] = [None] * NUM_LIMBS
    for i in range(NUM_LIMBS - 1, -1, -1):
        xi, yi = x.limbs[i], y.limbs[i]
        s = b.add_input()
        nc = b.add_input()

        def gen_pair(read, xi=xi, yi=yi, carry=carry):
            v = read(xi) + read(yi) + read(carry)
            return v % TWO32, v >> 32

        b.add_generator(s, lambda read, g=gen_pair: g(read)[0])
        b.add_generator(nc, lambda read, g=gen_pair: g(read)[1])
        b.decompose_bits(s, 32)
        b.decompose_bits(nc, 1)
        # x_i + y_i + carry - 2^32*nc - s == 0
        lhs = b.add(b.add(xi, yi), carry)
        lhs = b.sub(lhs, b.mul_const(TWO32 % P, nc))
        lhs = b.sub(lhs, s)
        b.connect(lhs, b.zero())
        out[i] = s
        carry = nc
    return U256Target(tuple(out)), carry


def _split32(b: CircuitBuilder, t: Target) -> Tuple[Target, Target]:
    """t (< p, value < 2^64) == lo + 2^32 * hi with lo, hi range-checked.

    Canonicity: the constraint holds mod p, so for small t the witness
    (lo, hi) = (t+1, 2^32-1) would encode t + p and pass both 32-bit range
    checks.  The honest hi of a limb product is always <= 2^32 - 2, so we
    additionally exclude hi == 2^32 - 1 (as plonky2-u32's arithmetic gate
    does), making the split unique."""
    lo = b.add_input()
    hi = b.add_input()
    b.add_generator(lo, lambda read, t=t: read(t) % TWO32)
    b.add_generator(hi, lambda read, t=t: read(t) >> 32)
    b.decompose_bits(lo, 32)
    b.decompose_bits(hi, 32)
    hi_is_max = b.is_equal(hi, b.constant(TWO32 - 1))
    b.connect(hi_is_max, b.zero())
    lhs = b.sub(t, lo)
    lhs = b.sub(lhs, b.mul_const(TWO32 % P, hi))
    b.connect(lhs, b.zero())
    return lo, hi


def u256_mul(
    b: CircuitBuilder, x: U256Target, y: U256Target
) -> Tuple[U256Target, Target]:
    """(x * y) mod 2^256 and an overflow flag (any high column nonzero).

    Schoolbook with p-safe accumulation: each limb product x_i*y_j
    (< (2^32-1)^2 < p) is first split into 32-bit halves; output column k
    then sums only 32-bit pieces (max 16) plus a small carry, staying far
    below p, and splits into limb_k + 2^32 * carry_k (carry <= 8 bits)."""
    xle = list(reversed(x.limbs))
    yle = list(reversed(y.limbs))
    # split every product once
    plo: Dict[Tuple[int, int], Target] = {}
    phi: Dict[Tuple[int, int], Target] = {}
    for i in range(NUM_LIMBS):
        for j in range(NUM_LIMBS):
            prod = b.mul(xle[i], yle[j])
            plo[(i, j)], phi[(i, j)] = _split32(b, prod)

    out_le: List[Target] = []
    carry = b.zero()
    overflow = b.zero()
    for k in range(2 * NUM_LIMBS):
        acc = carry
        for i in range(NUM_LIMBS):
            j = k - i
            if 0 <= j < NUM_LIMBS:
                acc = b.add(acc, plo[(i, j)])
            j2 = k - 1 - i
            if 0 <= j2 < NUM_LIMBS:
                acc = b.add(acc, phi[(i, j2)])
        limb = b.add_input()
        new_carry = b.add_input()

        def gen_pair(read, acc=acc):
            v = read(acc)
            return v % TWO32, v >> 32

        b.add_generator(limb, lambda read, g=gen_pair: g(read)[0])
        b.add_generator(new_carry, lambda read, g=gen_pair: g(read)[1])
        b.decompose_bits(limb, 32)
        b.decompose_bits(new_carry, 8)
        lhs = b.sub(acc, limb)
        lhs = b.sub(lhs, b.mul_const(TWO32 % P, new_carry))
        b.connect(lhs, b.zero())
        if k < NUM_LIMBS:
            out_le.append(limb)
        else:
            nz = b.logic_not(b.is_zero(limb))
            overflow = b.logic_or(overflow, nz)
        carry = new_carry
    return U256Target(tuple(reversed(out_le))), overflow


def u256_div_mod(
    b: CircuitBuilder, x: U256Target, y: U256Target
) -> Tuple[U256Target, U256Target]:
    """(x // y, x % y) with the SQL convention x/0 = 0, x%0 = 0
    (mp2-common UInt256DivGenerator role: quotient/remainder are witnesses,
    verified by q*y + r == x, r < y)."""
    # range checks are deferred until after the value generators below are
    # registered (generators run in insertion order; the decompose bits
    # would otherwise be computed from the default-zero limbs)
    q = add_virtual_u256(b, range_check=False)
    r = add_virtual_u256(b, range_check=False)

    def read_u256(read, t):
        return u256_from_fields([read(l) for l in t.limbs])

    for i in range(NUM_LIMBS):

        def gen_q(read, i=i):
            xv = read_u256(read, x)
            yv = read_u256(read, y)
            qv = xv // yv if yv else 0
            from mp2_tpu_torch.utils.u256 import u256_to_fields

            return u256_to_fields(qv)[i]

        def gen_r(read, i=i):
            xv = read_u256(read, x)
            yv = read_u256(read, y)
            rv = xv % yv if yv else 0
            from mp2_tpu_torch.utils.u256 import u256_to_fields

            return u256_to_fields(rv)[i]

        b.add_generator(q.limbs[i], gen_q)
        b.add_generator(r.limbs[i], gen_r)

    for t in list(q.limbs) + list(r.limbs):
        b.assert_u32(t)

    qy, mul_ov = u256_mul(b, q, y)
    s, add_ov = u256_add(b, qy, r)
    y_is_zero = u256_is_zero(b, y)
    # if y != 0: q*y + r == x (no overflow) and r < y
    # if y == 0: q == 0 and r == 0
    eq_x = u256_equal(b, s, x)
    r_lt_y = u256_less_than(b, r, y)
    ok_nonzero = b.logic_and(eq_x, r_lt_y)
    ok_nonzero = b.logic_and(ok_nonzero, b.logic_not(mul_ov))
    ok_nonzero = b.logic_and(ok_nonzero, b.logic_not(add_ov))
    q_zero = u256_is_zero(b, q)
    r_zero = u256_is_zero(b, r)
    ok_zero = b.logic_and(q_zero, r_zero)
    ok = b.logic_or(
        b.logic_and(b.logic_not(y_is_zero), ok_nonzero),
        b.logic_and(y_is_zero, ok_zero),
    )
    b.connect(ok, b.one())
    return q, r


def u256_select(
    b: CircuitBuilder, cond: Target, x: U256Target, y: U256Target
) -> U256Target:
    """cond ? x : y (cond boolean)."""
    out = []
    for xi, yi in zip(x.limbs, y.limbs):
        d = b.sub(xi, yi)
        out.append(b.mul_add(cond, d, yi))
    return U256Target(tuple(out))
