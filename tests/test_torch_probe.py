"""P1's plain chains (ops/probe_cuda.probe_plain) against the reference's
gl_u32 limb primitives run in jnp on the CPU.

Each op's k-step chain x <- op(x, b) starts from the same numpy inputs in
both packages (u64 values in the port, (lo, hi) u32 planes in the
reference) and is compared after a final canonicalisation, exactly: the
lazy primitives compute the same residues as the canonical ones.  The
machine ops without a gl_u32 counterpart (the 64x64 -> 128 product, the
select, the warp shuffle as a roll within groups of 32) are held against
the same chains written in jnp or in Python integers.  The CUDA kernel runs
only on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp2_tpu.ops import gl_u32 as K
from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.ops import probe_cuda as PC

P = gl.P
M32 = np.uint64(0xFFFFFFFF)
N = 512  # two blocks of the kernel's 256 threads


def _inputs():
    a, b = PC.inputs("cpu", N, seed=5)
    return a, b, gl.to_u64(a), gl.to_u64(b)


def _pairs(v):
    return (jnp.asarray((v & M32).astype(np.uint32)),
            jnp.asarray((v >> np.uint64(32)).astype(np.uint32)))


def _u64(lo, hi):
    return np.asarray(lo, dtype=np.uint64) | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))


def _reference_chain(op, k, a, b):
    """The chain in gl_u32 on (lo, hi) planes, canonicalised."""
    lo, hi = _pairs(a)
    blo, bhi = _pairs(b)
    t = jnp.asarray(((b >> np.uint64(32)) * np.uint64(64) + (b & M32)) % np.uint64(192),
                    dtype=jnp.uint32)
    t_warp = jnp.asarray(((np.arange(a.size) >> 5) * 131) % 192, dtype=jnp.uint32)
    op = op.removesuffix("_sel")  # the compare-and-select forms: the lazy ops' residues
    for r in range(k):
        if op in ("mul", "mul_lazy"):
            lo, hi = (K.mul if op == "mul" else K.mul_lazy)(lo, hi, blo, bhi)
        elif op == "sqr":
            lo, hi = K.mul(lo, hi, lo, hi)
        elif op == "sqr_lazy":
            lo, hi = K.sq_lazy(lo, hi)
        elif op in ("add", "add_lazy"):
            lo, hi = (K.add if op == "add" else K.add_lazy)(lo, hi, blo, bhi)
        elif op in ("sub", "sub_lazy"):
            lo, hi = K.sub_lazy(lo, hi, blo, bhi)
        elif op == "canon":
            lo, hi = K.canon(lo ^ blo, hi ^ bhi)
        elif op == "mul_pow2_lazy":
            lo, hi = K.mul_pow2_lazy(lo, hi, t)
        elif op in ("mul_pow2_warp", "mul_pow2_uniform"):
            lo, hi = K.mul_pow2_lazy(lo, hi, t_warp)
        elif op == "mul32":
            lo, hi = lo * hi, hi + lo
        elif op == "select":
            lo, hi = (jnp.where((lo & jnp.uint32(1)) == 0, lo, hi),
                      jnp.where((hi & jnp.uint32(1)) == 0, hi, lo))
        elif op == "shfl":
            s = 1 + r % 7
            lo = jnp.roll(lo.reshape(-1, 32), -s, axis=1).reshape(-1)
            hi = jnp.roll(hi.reshape(-1, 32), -s, axis=1).reshape(-1)
        else:
            raise AssertionError(op)
    return _u64(*K.canon_lazy(lo, hi))


@pytest.mark.parametrize("op", [op for op in PC.OPS if op != "mul_wide"])
def test_plain_chain_matches_gl_u32(op):
    a, b, a64, b64 = _inputs()
    for k in PC.ks(op)[:2]:
        got = gl.to_u64(PC.probe(op, k, a, b))  # the plain twin on a CPU tensor
        np.testing.assert_array_equal(got, _reference_chain(op, k, a64, b64))


def test_plain_mul_wide_chain_matches_python_ints():
    """The 128-bit product, folded as lo ^ hi, k times, then canon."""
    a, b, a64, b64 = _inputs()
    for k in PC.ks("mul_wide")[:2]:
        want = []
        for x, y in zip(a64[:64].tolist(), b64[:64].tolist()):
            for _ in range(k):
                prod = x * y
                x = (prod & ((1 << 64) - 1)) ^ (prod >> 64)
            want.append(x - P if x >= P else x)
        got = gl.to_u64(PC.probe_plain("mul_wide", k, a, b))[:64]
        assert [int(v) for v in got] == want


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a, b, _, _ = _inputs()
    with pytest.raises(ValueError):
        PC.probe("div", 2, a, b)
    with pytest.raises(ValueError):
        PC.probe("mul", 3, a, b)
    with pytest.raises(ValueError):
        PC.probe("mul", 2, a[:100], b[:100])  # not a multiple of 256
    with pytest.raises(ValueError, match="no probe kernel"):
        PC.probe("mul", 2, a.to("meta"), b.to("meta"))
    before = PC.probe.launches
    PC.probe("add", 2, a, b)
    assert PC.probe.launches == before  # the CPU takes the plain chain
