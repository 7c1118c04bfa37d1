"""Poseidon2 host golden model (python ints): the canonical semantics.

A jax-free copy of `mp2_tpu/hash/poseidon2_host.py`: only the imports
change.

Used by host-side tree building (ryhope equivalents), digest computation, and
as the reference for the vectorized JAX/Pallas implementations — which must
match it bit-for-bit (tests/test_poseidon2.py).

Structure per the Poseidon2 paper for t = 12 over Goldilocks:
  state <- M_E(state)
  4 external rounds:  state <- M_E((state + rc)^7)
  22 internal rounds: state[0] <- (state[0] + rc)^7 ; state <- M_I(state)
  4 external rounds:  state <- M_E((state + rc)^7)
Sponge: rate 8 / capacity 4, overwrite-mode absorption, no padding —
mirroring plonky2's `hash_n_to_m_no_pad` semantics used throughout the
reference (e.g. the reference's mp2-common/src/group_hashing/field_to_curve.rs:44).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash.constants import (
    CAPACITY,
    M4,
    RATE,
    ROUNDS_F,
    ROUNDS_P,
    WIDTH,
    load_table,
)

_EXT_RC, _INT_RC, _INT_DIAG = load_table()

HashOut = Tuple[int, int, int, int]
ZERO_HASH: HashOut = (0, 0, 0, 0)


def _sbox(x: int) -> int:
    x2 = x * x % P
    x3 = x2 * x % P
    x4 = x2 * x2 % P
    return x4 * x3 % P


def _apply_m4(c: Sequence[int]) -> List[int]:
    return [sum(M4[i][j] * c[j] for j in range(4)) % P for i in range(4)]


def _external_linear(state: List[int]) -> List[int]:
    chunks = [_apply_m4(state[i : i + 4]) for i in range(0, WIDTH, 4)]
    total = [sum(ch[i] for ch in chunks) % P for i in range(4)]
    out = []
    for ch in chunks:
        out.extend((ch[i] + total[i]) % P for i in range(4))
    return out


def _internal_linear(state: List[int]) -> List[int]:
    s = sum(state) % P
    return [(s + (_INT_DIAG[i] - 1) * state[i]) % P for i in range(WIDTH)]


def permute(state: Sequence[int]) -> List[int]:
    assert len(state) == WIDTH
    st = _external_linear([x % P for x in state])
    half = ROUNDS_F // 2
    for r in range(half):
        st = [(x + rc) % P for x, rc in zip(st, _EXT_RC[r])]
        st = [_sbox(x) for x in st]
        st = _external_linear(st)
    for r in range(ROUNDS_P):
        st[0] = _sbox((st[0] + _INT_RC[r]) % P)
        st = _internal_linear(st)
    for r in range(half, ROUNDS_F):
        st = [(x + rc) % P for x, rc in zip(st, _EXT_RC[r])]
        st = [_sbox(x) for x in st]
        st = _external_linear(st)
    return st


def permute_trace(state: Sequence[int]):
    """Permutation with all single-row-gate intermediate values exposed:
    returns (sf_first[4][12] states after full rounds 0..3,
             p_sbox[22] partial-round s-box outputs,
             sf_last[3][12] states after full rounds 4..6,
             out[12]).  Wire-for-wire the witness of gates.Poseidon2Gate."""
    st = _external_linear([x % P for x in state])
    half = ROUNDS_F // 2
    sf_first = []
    for r in range(half):
        st = [_sbox((x + rc) % P) for x, rc in zip(st, _EXT_RC[r])]
        st = _external_linear(st)
        sf_first.append(list(st))
    p_sbox = []
    for r in range(ROUNDS_P):
        s0 = _sbox((st[0] + _INT_RC[r]) % P)
        p_sbox.append(s0)
        st = _internal_linear([s0] + st[1:])
    sf_last = []
    for r in range(half, ROUNDS_F):
        st = [_sbox((x + rc) % P) for x, rc in zip(st, _EXT_RC[r])]
        st = _external_linear(st)
        if r < ROUNDS_F - 1:
            sf_last.append(list(st))
    return sf_first, p_sbox, sf_last, list(st)


def hash_n_to_m_no_pad(inputs: Sequence[int], num_outputs: int) -> List[int]:
    """Overwrite-mode sponge, no padding (plonky2 semantics)."""
    state = [0] * WIDTH
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i : i + RATE]
        state[: len(chunk)] = [x % P for x in chunk]
        state = permute(state)
    outputs: List[int] = []
    while True:
        for x in state[:RATE]:
            outputs.append(x)
            if len(outputs) == num_outputs:
                return outputs
        state = permute(state)


def hash_no_pad(inputs: Sequence[int]) -> HashOut:
    return tuple(hash_n_to_m_no_pad(inputs, 4))


def hash_or_noop(inputs: Sequence[int]) -> HashOut:
    """plonky2 semantics: <= 4 inputs are returned zero-padded (no hashing)."""
    if len(inputs) <= 4:
        return tuple(list(inputs) + [0] * (4 - len(inputs)))
    return hash_no_pad(inputs)


def two_to_one(left: HashOut, right: HashOut) -> HashOut:
    return hash_no_pad(list(left) + list(right))


def hash_pair_sorted(a: HashOut, b: HashOut, swap: bool) -> HashOut:
    """hash_maybe_swap equivalent (mp2-common/src/poseidon.rs:136)."""
    return two_to_one(b, a) if swap else two_to_one(a, b)


def empty_poseidon_hash() -> HashOut:
    """Hash of the empty input (mp2-common/src/poseidon.rs:49-52,
    `H::hash_no_pad(&[])`).  With the no-pad overwrite sponge, empty input
    performs zero permutations and squeezes the zero state: (0, 0, 0, 0)."""
    return hash_no_pad([])


def hash_to_quintic(inputs: Sequence[int]) -> Tuple[int, int, int, int, int]:
    """Hash to 5 base-field elements = one GF(p^5) element (map-to-curve
    preimage, field_to_curve.rs:37-49)."""
    return tuple(hash_n_to_m_no_pad(inputs, 5))


def hash_to_int(h: HashOut) -> int:
    """128-bit scalar from the first two hash limbs, little-endian u32 limbs
    (mp2-common/src/poseidon.rs:120-131)."""
    e0, e1 = h[0], h[1]
    limbs = [e0 & 0xFFFFFFFF, e0 >> 32, e1 & 0xFFFFFFFF, e1 >> 32]
    return sum(l << (32 * i) for i, l in enumerate(limbs))


def map_to_curve_point(values: Sequence[int]):
    """Poseidon-hash values to GF(p^5), then SSWU to the digest curve
    (mp2-common/src/group_hashing/field_to_curve.rs:37-49)."""
    from mp2_tpu_torch.field.sswu import simple_swu

    return simple_swu(hash_to_quintic(values))
