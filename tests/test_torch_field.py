"""The port's Goldilocks and GF(p^2) arithmetic against mp2_tpu.field and
Python ints, exactly, on seeded inputs that include 0, p-1 and 2^32*k."""

import numpy as np
import pytest
import torch

from mp2_tpu.field import ext2 as jext2
from mp2_tpu.field import goldilocks as jgl
from mp2_tpu_torch.field import ext2
from mp2_tpu_torch.field import goldilocks as gl

P = gl.P
EDGES = [0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1, 3 << 32, (1 << 32) + 1,
         1 << 63, (1 << 63) - 1, P - (1 << 32), 7]


def _vals(seed, n=256):
    rng = np.random.default_rng(seed)
    rand = [int(v) for v in rng.integers(0, P, n, dtype=np.uint64)]
    return EDGES + rand


def _ints(t):
    return [int(v) for v in gl.to_u64(t)]


BINARY = {
    "add": (gl.add, jgl.add, lambda a, b: a + b),
    "sub": (gl.sub, jgl.sub, lambda a, b: a - b),
    "mul": (gl.mul, jgl.mul, lambda a, b: a * b),
}
UNARY = {
    "neg": (gl.neg, jgl.neg, lambda a: -a),
    "sqr": (gl.sqr, jgl.sqr, lambda a: a * a),
    "exp7": (gl.exp7, jgl.exp7, lambda a: pow(a, 7, P)),
    "inv": (gl.inv, jgl.inv, lambda a: pow(a, P - 2, P)),
    "pow_const": (lambda a: gl.pow_const(a, 12345678901), lambda a: jgl.pow_const(a, 12345678901),
                  lambda a: pow(a, 12345678901, P)),
    "mul_const": (lambda a: gl.mul_const(a, P - 3), lambda a: jgl.mul_const(a, P - 3),
                  lambda a: a * (P - 3)),
    "add_const": (lambda a: gl.add_const(a, P - 1), lambda a: jgl.add_const(a, P - 1),
                  lambda a: a + P - 1),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops_match_reference(op):
    ours, ref, py = BINARY[op]
    a = _vals(1)
    b = _vals(2)[::-1]
    # every edge value against every edge value, plus the random pairs
    a = a + [x for x in EDGES for _ in EDGES]
    b = b + [y for _ in EDGES for y in EDGES]
    got = _ints(ours(gl.from_u64(a, "cpu"), gl.from_u64(b, "cpu")))
    want = [int(v) for v in jgl.to_u64(ref(jgl.from_u64(a), jgl.from_u64(b)))]
    assert got == want == [py(x, y) % P for x, y in zip(a, b)]


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_ops_match_reference(op):
    ours, ref, py = UNARY[op]
    a = _vals(3)
    got = _ints(ours(gl.from_u64(a, "cpu")))
    want = [int(v) for v in jgl.to_u64(ref(jgl.from_u64(a)))]
    assert got == want == [py(x) % P for x in a]


def test_conversions_and_canon():
    a = _vals(4)
    t = gl.from_u64(a, "cpu")
    assert t.dtype == torch.int64
    assert _ints(t) == a
    # from_u64 reduces mod p, from python ints and from uint64 arrays alike
    big = [P, P + 5, (1 << 64) - 1]
    assert _ints(gl.from_u64(big, "cpu")) == [v % P for v in big]
    assert _ints(gl.from_u64(np.array(big, dtype=np.uint64), "cpu")) == [v % P for v in big]
    # canon maps any u64 bit pattern to its residue
    raw = torch.from_numpy(np.array(big + [0, P - 1], dtype=np.uint64).view(np.int64))
    assert _ints(gl.canon(raw)) == [v % P for v in big + [0, P - 1]]
    assert gl.to_i64(P - 1) == -(1 << 32)


def test_sum_axis_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.integers(0, P, (7, 13), dtype=np.uint64)
    x[0, :] = P - 1
    for axis in (0, 1):
        got = gl.to_u64(gl.sum_axis(gl.from_u64(x, "cpu"), axis))
        want = jgl.to_u64(jgl.sum_axis(jgl.from_u64(x), axis))
        np.testing.assert_array_equal(got, want)


def _pairs(seed, n=64):
    a, b = _vals(seed, n), _vals(seed + 100, n)[::-1]
    return a, b


EXT_OPS = {
    "add": (ext2.add, jext2.add),
    "sub": (ext2.sub, jext2.sub),
    "mul": (ext2.mul, jext2.mul),
}


@pytest.mark.parametrize("op", sorted(EXT_OPS))
def test_ext2_binary_ops_match_reference(op):
    ours, ref = EXT_OPS[op]
    a0, a1 = _pairs(6)
    b0, b1 = _pairs(7)
    got = ours(ext2.GF2(gl.from_u64(a0, "cpu"), gl.from_u64(a1, "cpu")),
               ext2.GF2(gl.from_u64(b0, "cpu"), gl.from_u64(b1, "cpu")))
    want = ref(jext2.from_u64_pair(a0, a1), jext2.from_u64_pair(b0, b1))
    assert _ints(got.c0) == [int(v) for v in jgl.to_u64(want.c0)]
    assert _ints(got.c1) == [int(v) for v in jgl.to_u64(want.c1)]
    if op == "mul":
        host = [ext2.host_mul((x0, x1), (y0, y1)) for x0, x1, y0, y1 in zip(a0, a1, b0, b1)]
        assert list(zip(_ints(got.c0), _ints(got.c1))) == host


@pytest.mark.parametrize("op", ["inv", "pow_const", "mul_const", "neg"])
def test_ext2_unary_ops_match_reference(op):
    a0, a1 = _pairs(8)
    x = ext2.GF2(gl.from_u64(a0, "cpu"), gl.from_u64(a1, "cpu"))
    jx = jext2.from_u64_pair(a0, a1)
    if op == "inv":
        got, want = ext2.inv(x), jext2.inv(jx)
        host = [ext2.host_inv(p) if p != (0, 0) else (0, 0) for p in zip(a0, a1)]
        assert list(zip(_ints(got.c0), _ints(got.c1))) == host
    elif op == "pow_const":
        got, want = ext2.pow_const(x, 1000003), jext2.pow_const(jx, 1000003)
    elif op == "mul_const":
        got = ext2.mul_const(x, 12345)
        want = jext2.GF2(jgl.mul_const(jx.c0, 12345), jgl.mul_const(jx.c1, 12345))
    else:
        got, want = ext2.neg(x), jext2.neg(jx)
    assert _ints(got.c0) == [int(v) for v in jgl.to_u64(want.c0)]
    assert _ints(got.c1) == [int(v) for v in jgl.to_u64(want.c1)]
