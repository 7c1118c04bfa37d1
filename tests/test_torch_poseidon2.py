"""The port's Poseidon2 (K1's plain version, sponge, challenger) against
mp2_tpu: the Pallas kernel in interpret mode, the XLA path and the host
model, exactly.  K1 itself runs only on the card (tests/test_torch_cuda.py
and chip_smoke.py)."""

import re

import numpy as np
import pytest
import torch

from mp2_tpu.field import goldilocks as jgl
from mp2_tpu.hash import poseidon2 as jp2
from mp2_tpu.hash import poseidon2_host as jp2h
from mp2_tpu.hash.challenger import Challenger as JChallenger
from mp2_tpu.hash.challenger import HostChallenger as JHostChallenger
from mp2_tpu.hash.constants import load_table as jload_table
from mp2_tpu.ops.poseidon2_pallas import permute_batch_u64_interpret
from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.hash import poseidon2 as p2
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.hash.challenger import Challenger, HostChallenger
from mp2_tpu_torch.hash.constants import load_table
from mp2_tpu_torch.ops import poseidon2_cuda as K

P = gl.P
EDGES = [0, P - 1, 1 << 32, (1 << 32) - 1]


def _states(seed, batch):
    rng = np.random.default_rng(seed)
    st = rng.integers(0, P, size=(batch, 12), dtype=np.uint64)
    for k, v in enumerate(EDGES):
        st[k, :] = v
        st[len(EDGES) + k, :] = [EDGES[(k + i) % 4] for i in range(12)]
    return st


def test_tables_identical_to_reference():
    assert load_table() == jload_table()
    # the kernel's generated header carries exactly these constants
    ext, intr, diag = load_table()
    nums = [int(v) for v in re.findall(r"(\d+)ull", K._tables_header())]
    assert nums == [v for row in ext for v in row] + list(intr) + [(d - 1) % P for d in diag]


def test_permute_matches_pallas_interpret_and_host():
    st = _states(0, 37)
    got = gl.to_u64(p2.permute(gl.from_u64(st, "cpu")))
    want = np.asarray(permute_batch_u64_interpret(st))
    np.testing.assert_array_equal(got, want)
    for i in range(st.shape[0]):
        assert [int(v) for v in got[i]] == p2h.permute([int(v) for v in st[i]])


def test_permute_lanes_matches_reference_planar():
    st = _states(1, 19)
    got = gl.to_u64(p2.permute_lanes(gl.from_u64(st.T.copy(), "cpu")))
    want = jp2.permute_lanes([jgl.from_u64(st[:, i]) for i in range(12)])
    np.testing.assert_array_equal(got, np.stack([jgl.to_u64(w) for w in want]))
    # batch dims beyond one are carried through
    got3 = p2.permute_lanes(gl.from_u64(st.T.copy(), "cpu").reshape(12, 1, 19))
    np.testing.assert_array_equal(gl.to_u64(got3).reshape(12, 19), got)


def test_plain_kernel_twin_reduces_raw_u64_inputs():
    raw = np.array([[(1 << 64) - 1] * 12, [P + 3] * 12], dtype=np.uint64)
    got = gl.to_u64(K.permute_planar_plain(torch.from_numpy(raw.T.copy().view(np.int64))))
    for i in range(2):
        assert [int(v) for v in got[:, i]] == p2h.permute([int(v) for v in raw[i]])


def test_wrapper_dispatch_and_checks():
    x = gl.from_u64(_states(2, 9).T.copy(), "cpu")
    before = K.permute_planar.launches
    np.testing.assert_array_equal(
        gl.to_u64(K.permute_planar(x)), gl.to_u64(K.permute_planar_plain(x)))
    assert K.permute_planar.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError):
        K.permute_planar(x[:11])
    with pytest.raises(ValueError):
        K.permute_planar(x.to(torch.int32))
    with pytest.raises(ValueError):
        K.permute_planar(torch.zeros((12, 4), dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("n_in,n_out", [(0, 4), (3, 4), (8, 4), (13, 4), (17, 9), (37, 4)])
def test_sponge_matches_reference(n_in, n_out):
    rng = np.random.default_rng(n_in)
    x = rng.integers(0, P, size=(3, 2, n_in), dtype=np.uint64)
    got = gl.to_u64(p2.hash_n_to_m_no_pad(gl.from_u64(x, "cpu"), n_out))
    want = jgl.to_u64(jp2.hash_n_to_m_no_pad(jgl.from_u64(x), n_out))
    np.testing.assert_array_equal(got, want)
    assert [int(v) for v in got[1, 0]] == p2h.hash_n_to_m_no_pad(
        [int(v) for v in x[1, 0]], n_out)


@pytest.mark.parametrize("width", [2, 4, 5, 12])
def test_hash_or_noop_and_two_to_one(width):
    rng = np.random.default_rng(width)
    x = rng.integers(0, P, size=(6, width), dtype=np.uint64)
    got = gl.to_u64(p2.hash_or_noop(gl.from_u64(x, "cpu")))
    np.testing.assert_array_equal(got, jgl.to_u64(jp2.hash_or_noop(jgl.from_u64(x))))
    left, right = got[0::2], got[1::2]
    pair = gl.to_u64(p2.two_to_one(gl.from_u64(left, "cpu"), gl.from_u64(right, "cpu")))
    want = jgl.to_u64(jp2.two_to_one(jgl.from_u64(left), jgl.from_u64(right)))
    np.testing.assert_array_equal(pair, want)
    assert tuple(int(v) for v in pair[0]) == jp2h.two_to_one(
        tuple(int(v) for v in left[0]), tuple(int(v) for v in right[0]))


def test_challenger_matches_reference():
    rng = np.random.default_rng(9)
    ours = Challenger((3,), "cpu")
    ref = JChallenger(batch=(3,))
    out, want = [], []
    for n_obs, n_chal in [(5, 2), (21, 3), (0, 9), (1, 1), (8, 0), (3, 4)]:
        x = rng.integers(0, P, size=(3, n_obs), dtype=np.uint64)
        if n_obs == 1:
            ours.observe(gl.from_u64(x[:, 0], "cpu"))
            ref.observe(jgl.from_u64(x[:, 0]))
        elif n_obs:
            ours.observe(gl.from_u64(x, "cpu"))
            ref.observe(jgl.from_u64(x))
        out += [gl.to_u64(c) for c in ours.get_n_challenges(n_chal)]
        want += [jgl.to_u64(c) for c in ref.get_n_challenges(n_chal)]
    e, je = ours.get_extension_challenge(), ref.get_extension_challenge()
    out += [gl.to_u64(e.c0), gl.to_u64(e.c1)]
    want += [jgl.to_u64(je.c0), jgl.to_u64(je.c1)]
    np.testing.assert_array_equal(np.stack(out), np.stack(want))
    with pytest.raises(ValueError):
        ours.observe(gl.zeros((4, 2), "cpu"))


def test_host_challenger_matches_reference():
    ours, ref = HostChallenger(), JHostChallenger()
    for obs in ([1, 2, 3], list(range(11)), [P - 1] * 8, []):
        ours.observe(obs)
        ref.observe(obs)
        assert ours.get_n_challenges(3) == ref.get_n_challenges(3)
    assert ours.get_extension_challenge() == ref.get_extension_challenge()

