"""TP2 host verifier (python-int exact; golden model for the recursive
verifier gadget).

A copy of `mp2_tpu/prover/verify.py` on the port's host modules, so that a
machine without JAX can check the port's proofs.

Checks, in order: transcript replay, the quotient identity at zeta
(gate constraints + permutation argument), and the batched FRI opening
proof (Merkle openings, fold consistency, final-poly degree, PoW).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from mp2_tpu_torch.field import ext2
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.hash.challenger import HostChallenger
from mp2_tpu_torch.prover import fri as fri_mod
from mp2_tpu_torch.prover import ntt
from mp2_tpu_torch.prover.algebra import HostExtAlgebra as A
from mp2_tpu_torch.prover.prove import SHIFT, CircuitData, Proof, _gate_terms


def verify(data: CircuitData, proof: Proof) -> bool:
    cfg = data.config
    n, log_n = data.n, data.log_n
    W = cfg.num_wires
    nc = cfg.num_challenges
    rate = cfg.fri.rate_bits
    T = data.num_gate_types
    nC = cfg.num_constants

    pi_hash = p2h.hash_no_pad(proof.public_inputs)

    ch = HostChallenger()
    ch.observe(list(data.circuit_digest))
    ch.observe(list(pi_hash))
    for row in proof.wires_cap:
        ch.observe([int(x) for x in row])
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    for row in proof.zs_cap:
        ch.observe([int(x) for x in row])
    alphas = ch.get_n_challenges(nc)
    for row in proof.quotient_cap:
        ch.observe([int(x) for x in row])
    zeta = ch.get_extension_challenge()
    for a, b in proof.openings.flat():
        ch.observe(a)
        ch.observe(b)
    alpha_fri = ch.get_extension_challenge()

    # ---- quotient identity at zeta ----
    if not _check_zeta_identity(
        data, proof, zeta, betas, gammas, alphas, pi_hash
    ):
        return False

    # ---- FRI ----
    o = proof.openings
    b1 = o.batch1()
    n1 = len(b1)
    g = ntt._root_of_unity(log_n)
    gzeta = A.mul_const(zeta, g)
    z_col_offsets = [c * (1 + cfg.num_partial_products) for c in range(nc)]
    F = T + nC + W  # fixed column count

    def expected_eval(idx: int, leaves: List[np.ndarray]) -> Tuple[int, int]:
        fixed_row, wire_row, zs_row, quo_row = leaves
        vals = (
            [int(v) for v in fixed_row]
            + [int(v) for v in wire_row]
            + [int(v) for v in zs_row]
            + [int(v) for v in quo_row]
        )
        big_log = log_n + rate
        w_big = ntt._root_of_unity(big_log)
        x = SHIFT * pow(w_big, int(fri_mod._bitrev(big_log)[idx]), P) % P
        # batch 1
        acc1 = (0, 0)
        ap = (1, 0)
        for v, op in zip(vals, b1):
            acc1 = A.add(acc1, ext2.host_mul(ap, A.sub((v, 0), op)))
            ap = ext2.host_mul(ap, alpha_fri)
        inv1 = ext2.host_inv(A.sub((x, 0), zeta))
        acc1 = ext2.host_mul(acc1, inv1)
        # batch 2 (Z columns at g*zeta)
        acc2 = (0, 0)
        ap = (1, 0)
        for off, op in zip(z_col_offsets, o.zs_next):
            v = int(zs_row[off])
            acc2 = A.add(acc2, ext2.host_mul(ap, A.sub((v, 0), op)))
            ap = ext2.host_mul(ap, alpha_fri)
        inv2 = ext2.host_inv(A.sub((x, 0), gzeta))
        acc2 = ext2.host_mul(acc2, inv2)
        shift_pow = ext2.host_pow(alpha_fri, n1)
        return A.add(acc1, ext2.host_mul(shift_pow, acc2))

    caps = [
        data.fixed_cap_host,
        _cap_host(proof.wires_cap),
        _cap_host(proof.zs_cap),
        _cap_host(proof.quotient_cap),
    ]
    return fri_mod.verify(
        ch,
        proof.fri,
        caps,
        cfg.fri,
        cfg.fri_final_poly_bits,
        log_n + rate,
        expected_eval,
    )


def _cap_host(cap: np.ndarray):
    return [tuple(int(x) for x in row) for row in cap]


def _check_zeta_identity(
    data: CircuitData, proof: Proof, zeta, betas, gammas, alphas, pi_hash
) -> bool:
    cfg = data.config
    n = data.n
    W = cfg.num_wires
    nc = cfg.num_challenges
    T = data.num_gate_types
    nC = cfg.num_constants
    chunk = cfg.permutation_chunk_size
    n_chunks = -(-W // chunk)

    o = proof.openings
    sel = o.fixed[:T]
    consts = o.fixed[T : T + nC]
    sigmas = o.fixed[T + nC :]
    wires = o.wires
    extras = {"pi_hash": [(h % P, 0) for h in pi_hash]}

    terms = _gate_terms(data, A, sel, consts, wires, extras)

    # Z_H(zeta) and L0(zeta)
    zeta_n = ext2.host_pow(zeta, n)
    zh = A.sub(zeta_n, (1, 0))
    l0 = ext2.host_mul(
        zh, ext2.host_inv(A.mul_const(A.sub(zeta, (1, 0)), n))
    )

    for c in range(nc):
        beta, gamma = betas[c], gammas[c]
        base = c * (1 + cfg.num_partial_products)
        z = o.zs_partials[base]
        partials = [o.zs_partials[base + 1 + t] for t in range(cfg.num_partial_products)]
        z_next = o.zs_next[c]
        terms.append(ext2.host_mul(l0, A.sub(z, (1, 0))))
        pps = [z] + partials + [z_next]
        for t in range(n_chunks):
            num = (1, 0)
            den = (1, 0)
            for j in range(t * chunk, min((t + 1) * chunk, W)):
                kx = A.mul_const(zeta, data.k_coeffs[j] * beta % P)
                nj = A.add(A.add(wires[j], kx), (gamma, 0))
                sj = A.add(
                    A.add(wires[j], A.mul_const(sigmas[j], beta)), (gamma, 0)
                )
                num = ext2.host_mul(num, nj)
                den = ext2.host_mul(den, sj)
            terms.append(
                A.sub(ext2.host_mul(pps[t + 1], den), ext2.host_mul(pps[t], num))
            )

    # combine and compare against quotient openings
    qk = cfg.quotient_degree_factor
    for c in range(nc):
        acc = (0, 0)
        ap = (1, 0)
        for term in terms:
            acc = A.add(acc, ext2.host_mul(ap, term))
            ap = (ap[0] * alphas[c] % P, ap[1] * alphas[c] % P)
        # q_c(zeta) = sum_k zeta^(k n) chunk_{c,k}(zeta)
        q = (0, 0)
        zp = (1, 0)
        for k in range(qk):
            q = A.add(q, ext2.host_mul(zp, o.quotient[c * qk + k]))
            zp = ext2.host_mul(zp, zeta_n)
        if acc != ext2.host_mul(zh, q):
            return False
    return True
