"""Poseidon2 parameter tables for Goldilocks, width 12.

The reference pins its hasher to `Poseidon2GoldilocksConfig` from the
`poseidon2_plonky2` crate (the reference's mp2-common/src/lib.rs:36-47).  That
crate's constant tables are not redistributable inside this build environment
(zero egress), so this module generates deterministic, nothing-up-my-sleeve
tables via SHA-256 counter-mode rejection sampling.  The *structure* (widths,
round counts, matrix shapes, s-box) matches Poseidon2 for Goldilocks t=12
exactly; to obtain bit-exact interop with the reference, drop the canonical
tables into `load_table()` — every consumer reads through this module.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

from mp2_tpu_torch.field.goldilocks import P

WIDTH = 12
RATE = 8
CAPACITY = 4
SBOX_DEGREE = 7
ROUNDS_F = 8  # external (full) rounds, split 4 + 4
ROUNDS_P = 22  # internal (partial) rounds

# Table-set selector: every consumer (host golden model, Pallas kernel,
# in-circuit gate, in-SNARK replay) reads through load_table(), so swapping
# the set — e.g. dropping in the canonical poseidon2_plonky2 tables for
# transcript interop — is a constants-only change.  MP2_P2_DOMAIN picks an
# alternative deterministic set; tests/test_poseidon2.py proves the whole
# pipeline (params rebuild -> prove -> verify) re-derives under a second set.
import os as _os

_DOMAIN = (
    b"mp2-tpu/poseidon2/goldilocks/t12/"
    + _os.environ.get("MP2_P2_DOMAIN", "v1").encode()
)


def _sample_field_elements(tag: bytes, count: int) -> list[int]:
    """Uniform elements of [0, p) via SHA-256(domain || tag || counter),
    rejection-sampling 8-byte draws >= p."""
    out = []
    counter = 0
    while len(out) < count:
        h = hashlib.sha256(
            _DOMAIN + b"/" + tag + b"/" + counter.to_bytes(8, "little")
        ).digest()
        counter += 1
        for off in range(0, 32, 8):
            v = int.from_bytes(h[off : off + 8], "little")
            if v < P and len(out) < count:
                out.append(v)
    return out


@lru_cache(maxsize=None)
def load_table():
    """Returns (external_rc, internal_rc, internal_diag):

    external_rc: ROUNDS_F lists of WIDTH round constants
    internal_rc: ROUNDS_P round constants (lane 0 only)
    internal_diag: WIDTH diagonal entries mu_i of the internal matrix
        M_I[i][j] = 1 + (i == j) * (mu_i - 1)
    """
    ext = _sample_field_elements(b"external-rc", ROUNDS_F * WIDTH)
    external_rc = [ext[r * WIDTH : (r + 1) * WIDTH] for r in range(ROUNDS_F)]
    internal_rc = _sample_field_elements(b"internal-rc", ROUNDS_P)
    # Internal diagonal: mu_i must keep M_I invertible & secure; sampled
    # uniformly, then CHECKED (Poseidon2 paper §5.3 conditions) below.
    internal_diag = _sample_field_elements(b"internal-diag", WIDTH)
    check_internal_matrix(internal_diag)
    return external_rc, internal_rc, internal_diag


def _internal_matrix(diag: list[int]) -> list[list[int]]:
    """M_I[i][j] = 1 + (i == j) * (mu_i - 1)."""
    return [
        [(1 + (diag[i] - 1 if i == j else 0)) % P for j in range(WIDTH)]
        for i in range(WIDTH)
    ]


def check_internal_matrix(diag: list[int]) -> None:
    """Security checks on the internal matrix (Poseidon2 paper §5.3):

    1. distinct, nonzero diagonal entries (mu_i != mu_j, mu_i != 0, 1);
    2. M_I invertible over GF(p);
    3. no invariant subspace trails through the single s-box lane: the
       Krylov space span{e_1, M e_1, M^2 e_1, ...} must be the full space
       (the published Poseidon2 parameter scripts' subspace-trail test) —
       otherwise differences confined to a proper invariant subspace would
       bypass the partial-round s-box indefinitely.
    """
    assert len(set(diag)) == WIDTH, "internal diagonal entries must be distinct"
    assert all(d % P not in (0, 1) for d in diag), "degenerate diagonal entry"
    m = _internal_matrix(diag)
    # invertibility: det != 0 for the diag-plus-rank-one matrix
    # M_I = (J + diag(mu_i - 1)): det = prod(mu_i - 1) * (1 + sum 1/(mu_i-1))
    prod = 1
    inv_sum = 0
    for d in diag:
        prod = prod * ((d - 1) % P) % P
        inv_sum = (inv_sum + pow((d - 1) % P, P - 2, P)) % P
    assert prod * ((1 + inv_sum) % P) % P != 0, "internal matrix singular"
    # Krylov full-rank test from the s-box lane (gaussian elim over GF(p))
    basis: list[list[int]] = []
    v = [1] + [0] * (WIDTH - 1)
    for _ in range(WIDTH):
        w = list(v)
        for b in basis:
            pivot = next(i for i, x in enumerate(b) if x)
            if w[pivot]:
                f = w[pivot] * pow(b[pivot], P - 2, P) % P
                w = [(wi - f * bi) % P for wi, bi in zip(w, b)]
        if any(w):
            basis.append(w)
        v = [sum(m[i][j] * v[j] for j in range(WIDTH)) % P for i in range(WIDTH)]
    assert len(basis) == WIDTH, (
        "invariant subspace through the s-box lane: insecure internal matrix"
    )


# The 4x4 block of the external matrix (Poseidon2 paper, eq. for M_E):
# M_E = circ(2*M4, M4, M4) over three 4-lane chunks.
M4 = [
    [5, 7, 1, 3],
    [4, 6, 1, 1],
    [1, 3, 5, 7],
    [1, 1, 4, 6],
]
