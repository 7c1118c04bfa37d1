"""FRI low-degree proof system: the batched prove side and the host verifier.

Port of `mp2_tpu/prover/fri.py` and of the FRI commit phase of
`mp2_tpu/prover/batch.py` (`_fold_batched`, `_ext_leaves_batched` and the
fold loop of `_stage1b_fn`).  Evaluation vectors live on the coset g*H in
BIT-REVERSED order so arity-2 fold partners are adjacent.

Transcript order (prove and verify in lockstep):
  [caller: observed oracles, sampled alphas, observed openings]
  for each fold round: observe cap -> sample beta (extension)
  observe final poly coefficients (extension)
  grind pow_bits -> observe pow witness
  sample num_queries indices (low bits of base-field challenges)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from mp2_tpu_torch.field import ext2
from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.ext2 import GF2
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash.challenger import Challenger, HostChallenger
from mp2_tpu_torch.prover import ntt
from mp2_tpu_torch.prover.merkle import BatchedMerkleTree, verify_merkle_proof


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 28

    def salt_size(self) -> int:
        return 0  # zero-knowledge off, like the reference's configs


@dataclass
class FriQueryStep:
    """One fold round of one query: the sibling pair and its Merkle path."""

    pair: Tuple[Tuple[int, int], Tuple[int, int]]  # two extension values
    siblings: np.ndarray  # (depth, 4) uint64


@dataclass
class FriQueryRound:
    initial_leaves: List[np.ndarray]  # per oracle: opened row
    initial_siblings: List[np.ndarray]  # per oracle: (depth, 4)
    steps: List[FriQueryStep]


@dataclass
class FriProof:
    commit_caps: List[np.ndarray]  # per fold round: (2^cap, 4) uint64
    final_poly: List[Tuple[int, int]]  # extension coefficients
    pow_witness: int
    query_rounds: List[FriQueryRound]


# ---------------------------------------------------------------------------
# domain helpers
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _bitrev(log_n: int) -> np.ndarray:
    return ntt._bitrev_indices(log_n)


@lru_cache(maxsize=None)
def _fold_inv_2x(log_n: int, shift: int) -> np.ndarray:
    """inv(2*x_i) for rev-order pair index i in a domain of size 2^log_n
    with coset shift; x_i = shift * w^bitrev(2i).  As bitrev(2i) < n/2,
    inv(2 x_i) = inv(2 shift) * (1/w)^bitrev(2i): one table of n/2 powers
    and one product per point (an inversion per point took 11 s at 2^19
    on the host, once per process and domain)."""
    assert log_n >= 1
    w_inv = pow(ntt._root_of_unity(log_n), P - 2, P)
    powers = gl.from_u64(ntt._power_table(w_inv, 1 << (log_n - 1)), "cpu")
    c = gl.from_u64(np.array([pow(2 * shift % P, P - 2, P)], dtype=np.uint64), "cpu")
    out = gl.to_u64(gl.mul(powers, c)).copy()
    return out[_bitrev(log_n)[0::2]]


def bit_reverse(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    return torch.index_select(x, -1, ntt._bitrev_t(n.bit_length() - 1, x.device))


def bit_reverse_ext(x: GF2) -> GF2:
    return GF2(bit_reverse(x.c0), bit_reverse(x.c1))


# ---------------------------------------------------------------------------
# batched prove side
# ---------------------------------------------------------------------------


def ext_leaves(v: GF2) -> torch.Tensor:
    """Rev-order extension vectors (B, m) -> arity-2 leaves (B, m/2, 4)."""
    return torch.stack(
        [v.c0[:, 0::2], v.c1[:, 0::2], v.c0[:, 1::2], v.c1[:, 1::2]], dim=-1
    )


def fold(v: GF2, beta: GF2, inv_2x: torch.Tensor) -> GF2:
    """Arity-2 fold in rev order, per batch element:
    next_i = (e + o)/2 + beta * (e - o) * inv(2 x_i)."""
    e = GF2(v.c0[:, 0::2], v.c1[:, 0::2])
    o = GF2(v.c0[:, 1::2], v.c1[:, 1::2])
    half = gl.full((), (P + 1) // 2, v.c0.device)
    half_sum = ext2.scalar_mul(ext2.add(e, o), half)
    diff = ext2.scalar_mul(ext2.sub(e, o), inv_2x[None])
    beta_b = GF2(beta.c0[:, None], beta.c1[:, None])
    return ext2.add(half_sum, ext2.mul(beta_b, diff))


def commit_phase(
    ch: Challenger, final_rev: GF2, config: FriConfig, log_n: int,
    final_poly_bits: int, lde_shift: int,
):
    """Fold the combined codeword (B, n << rate) down to the final
    polynomial, committing each round.  Returns (fold trees, final
    coefficients c0, c1 of shape (B, 2^(final_poly_bits + rate)))."""
    B = final_rev.c0.shape[0]
    device = final_rev.c0.device
    cur = final_rev
    cur_shift = lde_shift
    cur_log = log_n + config.rate_bits
    trees: List[BatchedMerkleTree] = []
    for _ in range(log_n - final_poly_bits):
        t = BatchedMerkleTree(
            ext_leaves(cur), cap_height=min(config.cap_height, cur_log - 1)
        )
        trees.append(t)
        ch.observe(t.cap.reshape(B, -1))
        beta = ch.get_extension_challenge()
        inv2x = gl.from_u64(_fold_inv_2x(cur_log, cur_shift), device)
        cur = fold(cur, beta, inv2x)
        cur_shift = cur_shift * cur_shift % P
        cur_log -= 1
    nat = bit_reverse_ext(cur)
    c0 = ntt.coset_intt(nat.c0, cur_shift)
    c1 = ntt.coset_intt(nat.c1, cur_shift)
    final_len = 1 << final_poly_bits
    ch.observe(
        torch.stack([c0[:, :final_len], c1[:, :final_len]], dim=2).reshape(B, -1)
    )
    return trees, c0, c1


# ---------------------------------------------------------------------------
# host verifier (golden model, a copy of mp2_tpu.prover.fri.verify)
# ---------------------------------------------------------------------------

ExpectedEvalFn = Callable[[int, List[np.ndarray]], Tuple[int, int]]


def verify(
    challenger: HostChallenger,
    proof: FriProof,
    initial_caps: Sequence[Sequence[Tuple[int, int, int, int]]],
    config: FriConfig,
    final_poly_bits: int,
    log_n: int,
    expected_eval: ExpectedEvalFn,
    lde_shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR,
) -> bool:
    n = 1 << log_n
    num_folds = log_n - config.rate_bits - final_poly_bits
    # --- proof-shape validation (mirrors plonky2's validate_proof_shape):
    # without these, a prover could send zero fold steps plus an oversized
    # final_poly interpolating the claimed values, voiding the LDT.
    if len(proof.commit_caps) != num_folds:
        return False
    if len(proof.final_poly) != (1 << final_poly_bits):
        return False
    for r, cap in enumerate(proof.commit_caps):
        ch = min(config.cap_height, log_n - r - 1)
        if len(cap) != (1 << ch):
            return False
    for qr in proof.query_rounds:
        if len(qr.steps) != num_folds:
            return False

    betas: List[Tuple[int, int]] = []
    for cap in proof.commit_caps:
        for row in cap:
            challenger.observe([int(x) for x in row])
        betas.append(challenger.get_extension_challenge())
    for a, b in proof.final_poly:
        challenger.observe(a)
        challenger.observe(b)

    challenger.observe(proof.pow_witness)
    pow_response = challenger.get_challenge()
    if config.proof_of_work_bits and (
        pow_response >> (64 - config.proof_of_work_bits)
    ):
        return False

    indices = [
        challenger.get_challenge() % n for _ in range(config.num_query_rounds)
    ]
    if len(proof.query_rounds) != len(indices):
        return False

    w_tables = {}
    for qr, idx in zip(proof.query_rounds, indices):
        # 1. initial oracle openings
        if len(qr.initial_leaves) != len(initial_caps):
            return False
        for leaf, sibs, cap in zip(qr.initial_leaves, qr.initial_siblings, initial_caps):
            depth = log_n - (len(cap).bit_length() - 1)
            if not verify_merkle_proof(leaf, idx, sibs, cap, depth=depth):
                return False
        # 2. derived evaluation at idx
        ev = expected_eval(idx, qr.initial_leaves)
        # 3. fold rounds
        i = idx
        cur_log = log_n
        cur_shift = lde_shift
        for r, step in enumerate(qr.steps):
            pair_idx = i // 2
            leaf = [
                step.pair[0][0],
                step.pair[0][1],
                step.pair[1][0],
                step.pair[1][1],
            ]
            step_depth = (cur_log - 1) - min(config.cap_height, cur_log - 1)
            if not verify_merkle_proof(
                leaf, pair_idx, step.siblings, proof.commit_caps[r],
                depth=step_depth,
            ):
                return False
            # consistency: our derived value must equal the opened slot
            mine = step.pair[i & 1]
            if (ev[0] % P, ev[1] % P) != (mine[0] % P, mine[1] % P):
                return False
            # fold
            e, o = step.pair
            if cur_log not in w_tables:
                w_tables[cur_log] = ntt._root_of_unity(cur_log)
            w = w_tables[cur_log]
            rev = _bitrev(cur_log)
            x = cur_shift * pow(w, int(rev[2 * pair_idx]), P) % P
            inv2x = pow(2 * x % P, P - 2, P)
            half = (P + 1) // 2
            s = ext2.host_mul(
                ((e[0] + o[0]) % P, (e[1] + o[1]) % P), (half, 0)
            )
            d = ext2.host_mul(
                ((e[0] - o[0]) % P, (e[1] - o[1]) % P), (inv2x, 0)
            )
            ev = tuple(
                (a + b) % P
                for a, b in zip(s, ext2.host_mul(betas[r], d))
            )
            i = pair_idx
            cur_log -= 1
            cur_shift = cur_shift * cur_shift % P
        # 4. final polynomial evaluation at the residual domain point
        rev = _bitrev(cur_log)
        w = ntt._root_of_unity(cur_log)
        x = cur_shift * pow(w, int(rev[i]), P) % P
        acc = (0, 0)
        for c in reversed(proof.final_poly):
            acc = ext2.host_mul(acc, (x, 0))
            acc = ((acc[0] + c[0]) % P, (acc[1] + c[1]) % P)
        if (ev[0] % P, ev[1] % P) != acc:
            return False
    return True
