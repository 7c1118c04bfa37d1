"""Quadratic extension GF(p^2) = GF(p)[X]/(X^2 - 7) on torch tensors.

Elements are pairs (c0, c1) of Goldilocks tensors: value = c0 + c1*X.
Port of `mp2_tpu/field/ext2.py`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.goldilocks import P

W = 7  # X^2 = 7


class GF2(NamedTuple):
    c0: torch.Tensor
    c1: torch.Tensor

    @property
    def shape(self):
        return self.c0.shape

    def __getitem__(self, idx):
        return GF2(self.c0[idx], self.c1[idx])


def ones(shape, device) -> GF2:
    return GF2(gl.ones(shape, device), gl.zeros(shape, device))


def add(a: GF2, b: GF2) -> GF2:
    return GF2(gl.add(a.c0, b.c0), gl.add(a.c1, b.c1))


def sub(a: GF2, b: GF2) -> GF2:
    return GF2(gl.sub(a.c0, b.c0), gl.sub(a.c1, b.c1))


def neg(a: GF2) -> GF2:
    return GF2(gl.neg(a.c0), gl.neg(a.c1))


def mul(a: GF2, b: GF2) -> GF2:
    # (a0 + a1 X)(b0 + b1 X) = a0b0 + 7 a1b1 + (a0b1 + a1b0) X
    t00 = gl.mul(a.c0, b.c0)
    t11 = gl.mul(a.c1, b.c1)
    t01 = gl.mul(a.c0, b.c1)
    t10 = gl.mul(a.c1, b.c0)
    return GF2(gl.add(t00, gl.mul_const(t11, W)), gl.add(t01, t10))


def scalar_mul(a: GF2, s) -> GF2:
    return GF2(gl.mul(a.c0, s), gl.mul(a.c1, s))


def mul_const(a: GF2, c: int) -> GF2:
    return GF2(gl.mul_const(a.c0, c), gl.mul_const(a.c1, c))


def inv(a: GF2) -> GF2:
    # norm = c0^2 - 7 c1^2 in GF(p); inv = conj / norm
    n = gl.sub(gl.sqr(a.c0), gl.mul_const(gl.sqr(a.c1), W))
    ninv = gl.inv(n)
    return GF2(gl.mul(a.c0, ninv), gl.mul(gl.neg(a.c1), ninv))


def pow_const(a: GF2, e: int) -> GF2:
    if e == 0:
        return GF2(torch.ones_like(a.c0), torch.zeros_like(a.c1))
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def cat(parts: Sequence[GF2], dim=0) -> GF2:
    return GF2(
        torch.cat([x.c0 for x in parts], dim), torch.cat([x.c1 for x in parts], dim)
    )


def sum_axis(a: GF2, axis=-1) -> GF2:
    return GF2(gl.sum_axis(a.c0, axis), gl.sum_axis(a.c1, axis))


# -- host helpers (python-int pairs) -----------------------------------------


def host_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 + W * a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def host_inv(a):
    a0, a1 = a
    n = (a0 * a0 - W * a1 * a1) % P
    ninv = pow(n, P - 2, P)
    return (a0 * ninv % P, (-a1) * ninv % P)


def host_pow(a, e: int):
    r = (1, 0)
    base = a
    while e:
        if e & 1:
            r = host_mul(r, base)
        base = host_mul(base, base)
        e >>= 1
    return r
