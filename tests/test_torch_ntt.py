"""K2's and K2c's plain twins and the port's NTT against mp2_tpu on the CPU.

`ops/ntt_cuda.ntt_rows_plain` (K2) and `ops/ntt_t_cuda.ntt_four_step_plain`
(K2c) are held against the reference's Pallas NTT kernels run in interpret
mode (as tests/test_ntt_pallas.py runs them), the
port's `prover/ntt` transforms at the four-step sizes against
`mp2_tpu.prover.ntt`, and the kernel's flags against the reference's
formulas.  Inputs come from numpy with a seed; every comparison is exact.
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp2_tpu.field import goldilocks as jgl
from mp2_tpu.prover import ntt as jntt
from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.ops import ntt_cuda as N
from mp2_tpu_torch.ops import ntt_t_cuda as T
from mp2_tpu_torch.prover import ntt

P = gl.P
EDGES = np.array([0, P - 1, 1 << 32, (1 << 32) - 1], dtype=np.uint64)


def _rand(seed, shape):
    x = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    k = min(4, shape[-1])
    x[..., :k] = EDGES[:k]
    return x


def _plain(x, inverse, **kw):
    return gl.to_u64(N.ntt_rows_plain(gl.from_u64(x, "cpu"), inverse, **kw))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [9, 10])
def test_plain_matches_pallas_ntt_full(log_n, inverse):
    """ntt_full (K2, one fused pass, interpret mode) == ntt_rows_plain with
    the n^-1 scale of an inverse transform."""
    from mp2_tpu.ops.ntt_pallas import ntt_full

    x = _rand(log_n, (3, 1 << log_n))
    want = np.asarray(ntt_full(jnp.asarray(x), inverse))
    np.testing.assert_array_equal(_plain(x, inverse, scale=inverse), want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n, packed", [(10, "0"), (12, "1")])
def test_four_step_matches_pallas_four_step_fused(log_n, packed, inverse, monkeypatch):
    """ntt_four_step_fused (both passes, interpret mode) == the port's
    four-step, which runs ntt_rows on the CPU: at 2^10 with the unpacked
    stages (K2a; the interpreter wedges on the packed kernel at 32 lanes,
    tests/test_ntt_pallas.py:54-65) and at 2^12 with the packed default."""
    from mp2_tpu.ops.ntt_pallas import ntt_four_step_fused

    monkeypatch.setenv("MP2_NTT_PACKED", packed)
    x = _rand(7, (2, 1 << log_n))
    want = np.asarray(ntt_four_step_fused(jnp.asarray(x), inverse))
    got = gl.to_u64(ntt._ntt_four_step(gl.from_u64(x, "cpu"), inverse))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n", [15, 16])
def test_four_step_sizes_match_reference(log_n):
    """The port's ntt/intt at 2^15 and 2^16 and its LDE onto 2^log_n points
    (the wrap circuits' shapes), 2 rows, against mp2_tpu.prover.ntt."""
    x = _rand(log_n, (2, 1 << log_n))
    t = gl.from_u64(x, "cpu")
    jx = jgl.from_u64(x)
    if log_n == 15:  # at 2^16 the LDE below runs the forward transform
        np.testing.assert_array_equal(gl.to_u64(ntt.ntt(t)), jgl.to_u64(jntt.ntt(jx)))
    np.testing.assert_array_equal(gl.to_u64(ntt.intt(t)), jgl.to_u64(jntt.intt(jx)))
    coeffs = x[:, : 1 << (log_n - 3)]
    np.testing.assert_array_equal(
        gl.to_u64(ntt.lde(gl.from_u64(coeffs, "cpu"), 3)),
        jgl.to_u64(jntt.lde(jgl.from_u64(coeffs), 3)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [1, 4, 8, 11])
def test_plain_matches_reference_ntt(log_n, inverse):
    """No flags: the plain transform; with scale: the reference's intt."""
    x = _rand(100 + log_n, (5, 1 << log_n))
    jx = jgl.from_u64(x)
    if inverse:
        np.testing.assert_array_equal(_plain(x, True, scale=True), jgl.to_u64(jntt.intt(jx)))
    else:
        np.testing.assert_array_equal(_plain(x, False), jgl.to_u64(jntt.ntt(jx)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [1, 5, 10])
def test_bitrev_input_flag(log_n, inverse):
    """bitrev_input skips the load permutation: rows given in the order of
    the reference's _bitrev_indices transform like the natural rows."""
    x = _rand(200 + log_n, (3, 1 << log_n))
    rev = jntt._bitrev_indices(log_n)
    np.testing.assert_array_equal(_plain(x[:, rev], inverse, bitrev_input=True),
                                  _plain(x, inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [15, 16])
def test_twiddle_flag_is_the_four_step_middle_twiddle(log_n, inverse):
    """The twiddle epilogue multiplies row r by twiddle row r % T, and the
    four-step's (n2, n1) table is the reference's _four_step_twiddles
    transposed."""
    log1 = log_n // 2
    n1, n2 = 1 << log1, 1 << (log_n - log1)
    ref = np.ascontiguousarray(jntt._four_step_twiddles(log_n, inverse).T)  # (n2, n1)
    np.testing.assert_array_equal(
        gl.to_u64(T._four_step_twiddles(log_n, inverse, "cpu")), ref)
    x = _rand(300 + log_n, (2 * n2, n1))
    got = _plain(x, inverse, twiddle=gl.from_u64(ref, "cpu"), scale=inverse)
    cols = N.ntt_rows_plain(gl.from_u64(x, "cpu"), inverse, scale=inverse)
    want = gl.to_u64(gl.mul(cols, gl.from_u64(np.concatenate([ref, ref]), "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n", [2, 6, 12])
def test_scale_flag(log_n):
    x = _rand(400 + log_n, (2, 1 << log_n))
    n_inv = pow(1 << log_n, P - 2, P)
    want = [[int(v) * n_inv % P for v in row] for row in _plain(x, True)]
    np.testing.assert_array_equal(_plain(x, True, scale=True), np.array(want, dtype=np.uint64))


def test_all_flags_together():
    x = _rand(500, (8, 64))
    tw = _rand(501, (4, 64))
    rev = jntt._bitrev_indices(6)
    got = _plain(x[:, rev], True, twiddle=gl.from_u64(tw, "cpu"), scale=True,
                 bitrev_input=True)
    base = jgl.to_u64(jntt.intt(jgl.from_u64(x)))
    want = jgl.to_u64(jgl.mul(jgl.from_u64(base), jgl.from_u64(np.concatenate([tw, tw]))))
    np.testing.assert_array_equal(got, want)


def test_wrapper_takes_the_plain_path_on_the_cpu():
    x = gl.from_u64(_rand(600, (4, 32)), "cpu")
    before = N.ntt_rows.launches
    out = N.ntt_rows(x, False)
    assert N.ntt_rows.launches == before
    assert torch.equal(out, N.ntt_rows_plain(x, False))


@pytest.mark.parametrize("shape, kw", [
    ((4, 24), {}),  # not a power of two
    ((2, 1 << 15), {}),  # above one pass
    ((4, 32), {"twiddle": (3, 32)}),  # does not tile the rows
    ((4, 32), {"twiddle": (2, 16)}),  # wrong row length
])
def test_wrapper_refuses_shapes_the_kernel_does_not_take(shape, kw):
    x = torch.zeros(shape, dtype=torch.int64)
    if "twiddle" in kw:
        kw = {"twiddle": torch.zeros(kw["twiddle"], dtype=torch.int64)}
    with pytest.raises(ValueError):
        N.ntt_rows(x, False, **kw)


def test_wrapper_refuses_devices_without_the_kernel():
    with pytest.raises(ValueError, match="no NTT kernel"):
        N.ntt_rows(torch.zeros((2, 8), dtype=torch.int64, device="meta"), False)
    with pytest.raises(ValueError):
        N.ntt_rows(torch.zeros((2, 8), dtype=torch.int32), False)


def test_stage_table_layout():
    """Stage s occupies offset 2^(s-1) - 1: w_{2^s}^j for j < 2^(s-1)."""
    log_n = 5
    table = gl.to_u64(N._stage_table(log_n, False, "cpu"))
    assert len(table) == (1 << log_n) - 1
    for s in range(1, log_n + 1):
        h = 1 << (s - 1)
        w = jntt._root_of_unity(s)
        assert [int(v) for v in table[h - 1 : 2 * h - 1]] == [pow(w, j, P) for j in range(h)]


# ---------------------------------------------------------------------------
# K2c: the transpose-fused four-step (ops/ntt_t_cuda)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [6, 7, 8, 9, 10])
def test_four_step_t_plain_matches_pallas_fused_t(log_n, inverse):
    """ntt_four_step_fused_t (K2c, both transpose-fused passes, interpret
    mode) == ntt_four_step_plain, at every size from 2^6 (the kernel's
    least: n1, n2 >= 8) to 2^10."""
    from mp2_tpu.ops.ntt_pallas import ntt_four_step_fused_t

    x = _rand(700 + log_n, (2, 1 << log_n))
    want = np.asarray(ntt_four_step_fused_t(jnp.asarray(x), inverse))
    got = gl.to_u64(T.ntt_four_step_plain(gl.from_u64(x, "cpu"), inverse))
    np.testing.assert_array_equal(got, want)


def test_four_step_t_plain_matches_reference_xla_four_step():
    """At 2^15, both directions, against the reference's XLA four-step
    (mp2_tpu/prover/ntt.py::_ntt_four_step_xla), the route its prover takes
    without a Pallas kernel."""
    x = _rand(715, (1, 1 << 15))
    for inverse in (False, True):
        want = jgl.to_u64(jntt._ntt_four_step_xla(jgl.from_u64(x), inverse))
        np.testing.assert_array_equal(
            gl.to_u64(T.ntt_four_step_plain(gl.from_u64(x, "cpu"), inverse)), want)


def test_four_step_t_wrapper_takes_the_plain_path_on_the_cpu():
    """The prover's four-step is the wrapper; on the CPU it launches nothing."""
    x = gl.from_u64(_rand(800, (1, 1, 1 << 15)), "cpu")
    before = T.ntt_four_step_t.launches
    out = ntt.ntt(x)
    assert T.ntt_four_step_t.launches == before
    assert torch.equal(out[0], T.ntt_four_step_plain(x[0], False))


@pytest.mark.parametrize("shape, dtype", [
    ((2, 2), torch.int64),  # below 4
    ((2, 96), torch.int64),  # not a power of two
    ((2, 64), torch.int32),
    ((2, 2, 64), torch.int64),  # not (B, n)
])
def test_four_step_t_wrapper_refuses_shapes_the_kernel_does_not_take(shape, dtype):
    with pytest.raises(ValueError):
        T.ntt_four_step_t(torch.zeros(shape, dtype=dtype), False)


def test_four_step_t_wrapper_refuses_devices_without_the_kernel():
    with pytest.raises(ValueError, match="no four-step NTT kernel"):
        T.ntt_four_step_t(torch.zeros((2, 64), dtype=torch.int64, device="meta"), False)



# ---------------------------------------------------------------------------
# K2c's LDE and coset-iNTT entries (ops/ntt_t_cuda.lde_t, coset_intt_t)
# ---------------------------------------------------------------------------

SHIFT = gl.MULTIPLICATIVE_GROUP_GENERATOR


@pytest.mark.parametrize("log_big, rate", [(6, 1), (8, 3), (10, 2)])
def test_lde_and_coset_intt_twins_match_reference(log_big, rate):
    """lde_t_plain against mp2_tpu.prover.ntt.lde (2^log_big points from
    2^(log_big - rate) coefficients; the sizes span 2^6 to 2^10 and the
    rates 1 to 3, one compiled reference shape each) and coset_intt_t_plain against its
    coset_intt, both on the reference's default coset; the wrappers on a CPU
    tensor are the twins and launch nothing."""
    coeffs = _rand(900 + log_big, (2, 1 << (log_big - rate)))
    want = jgl.to_u64(jntt.lde(jgl.from_u64(coeffs), rate, SHIFT))
    c = gl.from_u64(coeffs, "cpu")
    np.testing.assert_array_equal(gl.to_u64(T.lde_t_plain(c, rate, SHIFT)), want)
    evals = _rand(950 + log_big, (2, 1 << log_big))
    want_c = jgl.to_u64(jntt.coset_intt(jgl.from_u64(evals), SHIFT))
    e = gl.from_u64(evals, "cpu")
    np.testing.assert_array_equal(gl.to_u64(T.coset_intt_t_plain(e, SHIFT)), want_c)
    before = T.ntt_four_step_t.launches
    assert torch.equal(T.lde_t(c, rate, SHIFT), T.lde_t_plain(c, rate, SHIFT))
    assert torch.equal(T.coset_intt_t(e, SHIFT), T.coset_intt_t_plain(e, SHIFT))
    assert T.ntt_four_step_t.launches == before


def test_prover_lde_and_coset_intt_take_the_entries_from_2_15():
    """prover/ntt routes an LDE of 2^15 points and up, and a coset iNTT of
    2^15 points and up, through K2c's entries (here their plain twins), and
    keeps the K2 compositions below; the results are the same functions."""
    coeffs = gl.from_u64(_rand(960, (1, 1 << 12)), "cpu")
    calls = []
    orig = (ntt.lde_t, ntt.coset_intt_t)
    ntt.lde_t = lambda *a: calls.append("lde") or orig[0](*a)
    ntt.coset_intt_t = lambda *a: calls.append("coset_intt") or orig[1](*a)
    try:
        big = ntt.lde(coeffs[None], 3, SHIFT)  # 2^15 points, a (1, 1, n) batch
        back = ntt.coset_intt(big, SHIFT)
        small = ntt.lde(coeffs[:, :1 << 10], 3, SHIFT)  # 2^13 points: K2's path
    finally:
        ntt.lde_t, ntt.coset_intt_t = orig
    assert calls == ["lde", "coset_intt"]
    assert big.shape == (1, 1, 1 << 15) and small.shape == (1, 1 << 13)
    assert torch.equal(back[..., :1 << 12], coeffs[None])
    assert not back[..., 1 << 12:].any()


@pytest.mark.parametrize("call", [
    lambda: T.lde_t(torch.zeros((2, 96), dtype=torch.int64), 1, SHIFT),  # not 2^k
    lambda: T.lde_t(torch.zeros((2, 2, 64), dtype=torch.int64), 1, SHIFT),  # not (B, n)
    lambda: T.coset_intt_t(torch.zeros((2, 64), dtype=torch.int32), SHIFT),
])
def test_lde_and_coset_intt_wrappers_refuse_shapes(call):
    with pytest.raises(ValueError):
        call()


def test_lde_and_coset_intt_wrappers_refuse_devices_without_the_kernel():
    x = torch.zeros((2, 1 << 12), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no four-step NTT kernel"):
        T.lde_t(x, 3, SHIFT)
    with pytest.raises(ValueError, match="no four-step NTT kernel"):
        T.coset_intt_t(x, SHIFT)


# ---------------------------------------------------------------------------
# Strided input, K2's entries, the nested four-step and the vectorised tables
# ---------------------------------------------------------------------------


def test_prover_ntt_takes_strided_input_from_2_15():
    """A (2, 3, 2^15) tensor made by a transpose goes through ntt, intt, lde
    (from 2^12 coefficients, rate 3) and coset_intt like its contiguous copy
    (the four-step's flattening copies it), and ntt equals mp2_tpu's."""
    base = _rand(970, (3, 2, 1 << 15))
    x = gl.from_u64(base, "cpu").transpose(0, 1)
    assert not x.is_contiguous()
    xc = x.contiguous()
    c = x[..., : 1 << 12]
    assert torch.equal(ntt.ntt(x), ntt.ntt(xc))
    assert torch.equal(ntt.intt(x), ntt.intt(xc))
    assert torch.equal(ntt.lde(c, 3, SHIFT), ntt.lde(c.contiguous(), 3, SHIFT))
    assert torch.equal(ntt.coset_intt(x, SHIFT), ntt.coset_intt(xc, SHIFT))
    want = jgl.to_u64(jntt.ntt(jgl.from_u64(np.ascontiguousarray(base.transpose(1, 0, 2)))))
    np.testing.assert_array_equal(gl.to_u64(ntt.ntt(x)), want)


@pytest.mark.parametrize("log_big, rate", [(4, 1), (7, 3), (10, 2)])
def test_k2_entry_twins_match_reference(log_big, rate):
    """lde_rows_plain and coset_intt_rows_plain (K2's entries' plain twins)
    against mp2_tpu.prover.ntt.lde and coset_intt, 2^4 to 2^10 points; the
    prover's lde and coset_intt below 2^15 points are these entries."""
    coeffs = _rand(980 + log_big, (2, 1 << (log_big - rate)))
    want = jgl.to_u64(jntt.lde(jgl.from_u64(coeffs), rate, SHIFT))
    c = gl.from_u64(coeffs, "cpu")
    np.testing.assert_array_equal(gl.to_u64(N.lde_rows_plain(c, rate, SHIFT)), want)
    evals = _rand(990 + log_big, (2, 1 << log_big))
    want_c = jgl.to_u64(jntt.coset_intt(jgl.from_u64(evals), SHIFT))
    e = gl.from_u64(evals, "cpu")
    np.testing.assert_array_equal(gl.to_u64(N.coset_intt_rows_plain(e, SHIFT)), want_c)
    calls = []
    orig = (ntt.lde_rows, ntt.coset_intt_rows)
    ntt.lde_rows = lambda *a: calls.append("lde") or orig[0](*a)
    ntt.coset_intt_rows = lambda *a: calls.append("coset_intt") or orig[1](*a)
    try:
        np.testing.assert_array_equal(gl.to_u64(ntt.lde(c[None], rate, SHIFT))[0], want)
        np.testing.assert_array_equal(gl.to_u64(ntt.coset_intt(e, SHIFT)), want_c)
    finally:
        ntt.lde_rows, ntt.coset_intt_rows = orig
    assert calls == ["lde", "coset_intt"]


@pytest.mark.parametrize("log_n, max_log_l", [(9, 3), (8, 2)])
def test_nested_four_step_plain_matches_reference(log_n, max_log_l):
    """ntt_four_step_plain cut into passes of at most 2^max_log_l points
    (three and four passes: the decomposition K2c runs above 2^20 points)
    against mp2_tpu.prover.ntt's ntt and intt."""
    x = _rand(1000 + log_n, (2, 1 << log_n))
    assert len(T.passes(log_n, max_log_l)) == -(-log_n // max_log_l) > 2
    t = gl.from_u64(x, "cpu")
    for inverse, ref in ((False, jntt.ntt), (True, jntt.intt)):
        got = gl.to_u64(T.ntt_four_step_plain(t, inverse, max_log_l=max_log_l))
        np.testing.assert_array_equal(got, jgl.to_u64(ref(jgl.from_u64(x))))


def test_passes_reach_2_30_in_three():
    """Two passes up to 2^20 (floor(log n / 2) points, then the rest),
    three from 2^21 to 2^30, each at most 2^10 points."""
    for log_n in range(T.MIN_LOG_N, T.MAX_LOG_N + 1):
        lens = T.passes(log_n)
        assert sum(lens) == log_n and max(lens) <= T.MAX_LOG_L
        assert len(lens) == (2 if log_n <= 20 else 3)
        if len(lens) == 2:
            assert lens == [log_n // 2, log_n - log_n // 2]


def test_vectorised_tables_equal_the_loop():
    """The tables built by doubling equal the power loops they replaced:
    _power_table, the four-step middle twiddles (w^(j*k) as (n / n1, n1))
    and K2's pass twiddles (w_{Ns R}^(r*k) at (r - 1) * Ns + k)."""
    base = 0x123456789ABCDEF
    loop, cur = [], 1
    for _ in range(37):
        loop.append(cur)
        cur = cur * base % P
    assert [int(v) for v in N._power_table(base, 37)] == loop
    for log_n, inverse in ((6, False), (9, True), (21, False)):
        log_l = T.passes(log_n)[0] if log_n < 21 else 3
        w = pow(N._root_of_unity(log_n), P - 2 if inverse else 1, P)
        rows = 1 << (log_n - log_l)
        got = gl.to_u64(T._pass_twiddles(log_n, log_l, inverse, "cpu"))
        assert got.shape == (rows, 1 << log_l)
        for j in (0, 1, rows // 3, rows - 1):
            assert [int(v) for v in got[j]] == [pow(w, j * k, P) for k in range(1 << log_l)]
    for log_n in (5, 13):
        table = [int(v) for v in gl.to_u64(N._pass_table(log_n, True, "cpu"))]
        off, log_ns = 0, 0
        for i, lr in enumerate(N._radices(log_n)):
            if i:
                w = pow(N._root_of_unity(log_ns + lr), P - 2, P)
                for r in range(1, 1 << lr):
                    seg = table[off + ((r - 1) << log_ns): off + (r << log_ns)]
                    assert seg == [pow(w, r * k, P) for k in range(1 << log_ns)]
                off += ((1 << lr) - 1) << log_ns
            log_ns += lr
        assert off == len(table)
