"""In-circuit GF(p^2) arithmetic: extension targets as (c0, c1) pairs.

The challenge field of the proving system (X^2 = 7), needed by the
recursive verifier gadget: FRI fold consistency, opening combination and
the zeta identity are all extension arithmetic.  Mirrors the out-of-circuit
`mp2_tpu.field.ext2` semantics exactly (same Karatsuba shape as the
reference's QuadraticExtension arithmetic, plonky2 field/extension).

A jax-free copy of `mp2_tpu/circuit/gadgets/ext2.py`: only the imports
change.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.field.goldilocks import P

W = 7  # X^2 = 7

ExtTarget = Tuple[Target, Target]


def ext_zero(b: CircuitBuilder) -> ExtTarget:
    return (b.zero(), b.zero())


def ext_one(b: CircuitBuilder) -> ExtTarget:
    return (b.one(), b.zero())


def ext_constant(b: CircuitBuilder, c0: int, c1: int = 0) -> ExtTarget:
    return (b.constant(c0), b.constant(c1))


def ext_from_base(b: CircuitBuilder, t: Target) -> ExtTarget:
    return (t, b.zero())


def ext_add(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return (b.add(x[0], y[0]), b.add(x[1], y[1]))


def ext_sub(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return (b.sub(x[0], y[0]), b.sub(x[1], y[1]))


def ext_mul(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    """Karatsuba: 3 base muls. (x0+x1 X)(y0+y1 X) = x0y0 + 7 x1y1
    + (x0y1 + x1y0) X."""
    m0 = b.mul(x[0], y[0])
    m1 = b.mul(x[1], y[1])
    t = b.mul(b.add(x[0], x[1]), b.add(y[0], y[1]))
    c0 = b.mul_add(b.constant(W), m1, m0)
    c1 = b.sub(b.sub(t, m0), m1)
    return (c0, c1)


def ext_mul_base(b: CircuitBuilder, x: ExtTarget, t: Target) -> ExtTarget:
    return (b.mul(x[0], t), b.mul(x[1], t))


def ext_mul_const(b: CircuitBuilder, x: ExtTarget, c: int) -> ExtTarget:
    return (b.mul_const(c, x[0]), b.mul_const(c, x[1]))


def ext_add_const(b: CircuitBuilder, x: ExtTarget, c: int) -> ExtTarget:
    return (b.add_const(x[0], c), x[1])


def ext_neg(b: CircuitBuilder, x: ExtTarget) -> ExtTarget:
    return (b.mul_const(P - 1, x[0]), b.mul_const(P - 1, x[1]))


def ext_select(b: CircuitBuilder, bit: Target, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    """bit ? x : y (bit boolean)."""
    return (b.select(bit, x[0], y[0]), b.select(bit, x[1], y[1]))


def ext_inv(b: CircuitBuilder, x: ExtTarget) -> ExtTarget:
    """Witnessed inverse; constrains x * inv == 1 (hence x != 0)."""
    i0 = b.add_input()
    i1 = b.add_input()

    def gen(read, x=x):
        from mp2_tpu_torch.field.ext2 import host_inv

        return host_inv((read(x[0]), read(x[1])))

    b.add_generator(i0, lambda read, g=gen: g(read)[0])
    b.add_generator(i1, lambda read, g=gen: g(read)[1])
    prod = ext_mul(b, x, (i0, i1))
    b.connect(prod[0], b.one())
    b.connect(prod[1], b.zero())
    return (i0, i1)


def ext_div(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ext_mul(b, x, ext_inv(b, y))


def ext_exp7(b: CircuitBuilder, x: ExtTarget) -> ExtTarget:
    x2 = ext_mul(b, x, x)
    x3 = ext_mul(b, x2, x)
    x4 = ext_mul(b, x2, x2)
    return ext_mul(b, x4, x3)


def ext_exp_pow2(b: CircuitBuilder, x: ExtTarget, k: int) -> ExtTarget:
    for _ in range(k):
        x = ext_mul(b, x, x)
    return x


def ext_connect(b: CircuitBuilder, x: ExtTarget, y: ExtTarget):
    b.connect(x[0], y[0])
    b.connect(x[1], y[1])


def base_inv(b: CircuitBuilder, t: Target) -> Target:
    """Witnessed base-field inverse; constrains t * inv == 1."""
    inv = b.add_input()
    b.add_generator(
        inv, lambda read, t=t: pow(read(t), P - 2, P) if read(t) else 0
    )
    b.connect(b.mul(t, inv), b.one())
    return inv


class CircuitExtAlgebra:
    """Algebra adapter: gate constraint definitions evaluated IN-CIRCUIT
    over extension targets — the third evaluation site promised by
    mp2_tpu.prover.algebra (device quotient / host zeta / recursive
    verifier), letting the recursive verifier reuse every gate's
    `constraints()` verbatim."""

    def __init__(self, b: CircuitBuilder):
        self.b = b
        self.zero = ext_zero(b)
        self.one = ext_one(b)

    def constant(self, c: int):
        return ext_constant(self.b, c)

    def add(self, a, b_):
        return ext_add(self.b, a, b_)

    def sub(self, a, b_):
        return ext_sub(self.b, a, b_)

    def mul(self, a, b_):
        return ext_mul(self.b, a, b_)

    def mul_const(self, a, c: int):
        return ext_mul_const(self.b, a, c)

    def add_const(self, a, c: int):
        return ext_add_const(self.b, a, c)

    def exp7(self, a):
        return ext_exp7(self.b, a)
