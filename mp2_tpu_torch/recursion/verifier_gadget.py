"""The universal verifier gadget: TP2 proof verification IN-CIRCUIT.

Role of the reference's recursion-framework universal verifier
(recursion-framework/src/universal_verifier_gadget/verifier_gadget.rs): an
outer circuit that contains a complete verifier for an inner TP2 proof of a
fixed shape (`CommonData`), so aggregation circuits verify their children
cryptographically instead of host-side.  Structure mirrors the host golden
models line-for-line:

  * transcript replay        -> gadgets/transcript.CircuitChallenger
  * zeta identity            -> the SAME gate `constraints()` definitions,
                                evaluated through CircuitExtAlgebra
                                (prover/verify.py:_check_zeta_identity)
  * batched FRI opening      -> Merkle paths with index-bit-selected order,
                                fold consistency, final-poly Horner eval
                                (prover/fri.py:verify)

Non-canonicity note: query indices derive from a 64-bit decomposition of a
field challenge; values < 2^64 - p have two valid bit representations (the
prover picks the canonical one).  plonky2's recursive verifier shares this
exact slack; it lets a prover occasionally choose between two query indices,
both of which still demand valid Merkle openings — no soundness loss beyond
a ~2^-32 bias per query.

A jax-free copy of `mp2_tpu/recursion/verifier_gadget.py`: only the imports
change (`_root_of_unity` comes from the port's `prover/ntt`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.ext2 import (
    CircuitExtAlgebra,
    ExtTarget,
    base_inv,
    ext_add,
    ext_connect,
    ext_from_base,
    ext_inv,
    ext_mul,
    ext_mul_base,
    ext_mul_const,
    ext_select,
    ext_sub,
)
from mp2_tpu_torch.circuit.gadgets.transcript import CircuitChallenger
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.prover import ntt
from mp2_tpu_torch.prover.config import CircuitConfig
from mp2_tpu_torch.prover.prove import SHIFT, CircuitData, Proof


# ---------------------------------------------------------------------------
# common data: the fixed proof shape the gadget is built against
# ---------------------------------------------------------------------------


@dataclass
class CommonData:
    """Everything shape-defining about an inner circuit (the counterpart of
    plonky2's CommonCircuitData): two circuits with equal CommonData produce
    proofs verifiable by the SAME gadget instance."""

    config: CircuitConfig
    n: int
    log_n: int
    gate_types: List  # [(name, gate_instance)] in canonical order
    k_coeffs: List[int]
    num_public_inputs: int

    @staticmethod
    def of(data: CircuitData, num_public_inputs: int = None) -> "CommonData":
        return CommonData(
            config=data.config,
            n=data.n,
            log_n=data.log_n,
            gate_types=list(data.gate_types),
            k_coeffs=list(data.k_coeffs),
            num_public_inputs=(
                len(data.public_inputs)
                if num_public_inputs is None
                else num_public_inputs
            ),
        )

    # -- derived shape ------------------------------------------------------
    @property
    def T(self) -> int:
        return len(self.gate_types)

    @property
    def num_fixed_cols(self) -> int:
        return self.T + self.config.num_constants + self.config.num_wires

    @property
    def log_big(self) -> int:
        return self.log_n + self.config.fri.rate_bits

    @property
    def num_folds(self) -> int:
        return self.log_big - self.config.fri.rate_bits - self.config.fri_final_poly_bits

    @property
    def cap_height(self) -> int:
        return min(self.config.fri.cap_height, self.log_n)

    def fold_cap_height(self, r: int) -> int:
        return min(self.config.fri.cap_height, self.log_big - r - 1)

    def fold_depth(self, r: int) -> int:
        return (self.log_big - r - 1) - self.fold_cap_height(r)

    @property
    def initial_depth(self) -> int:
        return self.log_big - self.cap_height

    def oracle_widths(self) -> List[int]:
        cfg = self.config
        return [
            self.num_fixed_cols,
            cfg.num_wires,
            cfg.num_challenges * (1 + cfg.num_partial_products),
            cfg.num_challenges * cfg.quotient_degree_factor,
        ]

    def shape_key(self) -> Tuple:
        """Hashable identity of the proof shape (for wrap fixed points)."""
        return (
            self.n,
            self.config.num_wires,
            self.config.num_constants,
            self.config.num_challenges,
            self.config.fri,
            self.config.fri_final_poly_bits,
            tuple(name for name, _ in self.gate_types),
            self.num_public_inputs,
        )


# ---------------------------------------------------------------------------
# proof targets
# ---------------------------------------------------------------------------


@dataclass
class StepTargets:
    pair: Tuple[ExtTarget, ExtTarget]
    siblings: List[List[Target]]  # (depth, 4)


@dataclass
class QueryRoundTargets:
    initial_leaves: List[List[Target]]  # per oracle
    initial_siblings: List[List[List[Target]]]  # per oracle (depth, 4)
    steps: List[StepTargets]


@dataclass
class ProofTargets:
    wires_cap: List[List[Target]]
    zs_cap: List[List[Target]]
    quotient_cap: List[List[Target]]
    openings: List[ExtTarget]  # flat: fixed|wires|zs_partials|quotient|zs_next
    fri_commit_caps: List[List[List[Target]]]
    fri_final_poly: List[ExtTarget]
    fri_pow_witness: Target
    fri_query_rounds: List[QueryRoundTargets]
    public_inputs: List[Target]

    def openings_split(self, common: CommonData):
        cfg = common.config
        F = common.num_fixed_cols
        W = cfg.num_wires
        zc = cfg.num_challenges * (1 + cfg.num_partial_products)
        qc = cfg.num_challenges * cfg.quotient_degree_factor
        o = self.openings
        i = 0
        fixed = o[i : i + F]; i += F
        wires = o[i : i + W]; i += W
        zs = o[i : i + zc]; i += zc
        quo = o[i : i + qc]; i += qc
        zs_next = o[i:]
        return fixed, wires, zs, quo, zs_next


def _cap_targets(b: CircuitBuilder, height: int) -> List[List[Target]]:
    return [b.add_inputs(4) for _ in range(1 << height)]


def add_virtual_proof(b: CircuitBuilder, common: CommonData) -> ProofTargets:
    cfg = common.config
    ch = common.cap_height
    nc = cfg.num_challenges
    n_open = (
        common.num_fixed_cols
        + cfg.num_wires
        + nc * (1 + cfg.num_partial_products)
        + nc * cfg.quotient_degree_factor
        + nc
    )
    widths = common.oracle_widths()
    rounds = []
    for _ in range(cfg.fri.num_query_rounds):
        leaves = [b.add_inputs(w) for w in widths]
        sibs = [
            [b.add_inputs(4) for _ in range(common.initial_depth)]
            for _ in widths
        ]
        steps = []
        for r in range(common.num_folds):
            pair = (
                (b.add_input(), b.add_input()),
                (b.add_input(), b.add_input()),
            )
            ssibs = [b.add_inputs(4) for _ in range(common.fold_depth(r))]
            steps.append(StepTargets(pair=pair, siblings=ssibs))
        rounds.append(
            QueryRoundTargets(
                initial_leaves=leaves, initial_siblings=sibs, steps=steps
            )
        )
    return ProofTargets(
        wires_cap=_cap_targets(b, ch),
        zs_cap=_cap_targets(b, ch),
        quotient_cap=_cap_targets(b, ch),
        openings=[(b.add_input(), b.add_input()) for _ in range(n_open)],
        fri_commit_caps=[
            _cap_targets(b, common.fold_cap_height(r))
            for r in range(common.num_folds)
        ],
        fri_final_poly=[
            (b.add_input(), b.add_input())
            for _ in range(1 << cfg.fri_final_poly_bits)
        ],
        fri_pow_witness=b.add_input(),
        fri_query_rounds=rounds,
        public_inputs=b.add_inputs(common.num_public_inputs),
    )


def set_proof_witness(inputs: Dict, pt: ProofTargets, proof: Proof) -> None:
    """Fill the witness-inputs dict from a host proof object."""

    def set_cap(ts, cap):
        for row_t, row in zip(ts, cap):
            for t, v in zip(row_t, row):
                inputs[t] = int(v)

    set_cap(pt.wires_cap, proof.wires_cap)
    set_cap(pt.zs_cap, proof.zs_cap)
    set_cap(pt.quotient_cap, proof.quotient_cap)
    flat_openings = proof.openings.flat()
    assert len(flat_openings) == len(pt.openings)
    for (t0, t1), (a, bb) in zip(pt.openings, flat_openings):
        inputs[t0] = int(a)
        inputs[t1] = int(bb)
    for ts, cap in zip(pt.fri_commit_caps, proof.fri.commit_caps):
        set_cap(ts, cap)
    for (t0, t1), (a, bb) in zip(pt.fri_final_poly, proof.fri.final_poly):
        inputs[t0] = int(a)
        inputs[t1] = int(bb)
    inputs[pt.fri_pow_witness] = int(proof.fri.pow_witness)
    assert len(pt.fri_query_rounds) == len(proof.fri.query_rounds)
    for qt, qr in zip(pt.fri_query_rounds, proof.fri.query_rounds):
        for leaf_t, leaf in zip(qt.initial_leaves, qr.initial_leaves):
            for t, v in zip(leaf_t, leaf):
                inputs[t] = int(v)
        for sibs_t, sibs in zip(qt.initial_siblings, qr.initial_siblings):
            for row_t, row in zip(sibs_t, sibs):
                for t, v in zip(row_t, row):
                    inputs[t] = int(v)
        for st, step in zip(qt.steps, qr.steps):
            (e0, e1), (o0, o1) = st.pair
            inputs[e0] = int(step.pair[0][0])
            inputs[e1] = int(step.pair[0][1])
            inputs[o0] = int(step.pair[1][0])
            inputs[o1] = int(step.pair[1][1])
            for row_t, row in zip(st.siblings, step.siblings):
                for t, v in zip(row_t, row):
                    inputs[t] = int(v)
    for t, v in zip(pt.public_inputs, proof.public_inputs):
        inputs[t] = int(v)


# ---------------------------------------------------------------------------
# sub-gadgets
# ---------------------------------------------------------------------------


def _mux_rows(
    b: CircuitBuilder, rows: List[List[Target]], bits: List[Target]
) -> List[Target]:
    """Select rows[sum bits_k 2^k] via a log-depth mux tree."""
    cur = [list(r) for r in rows]
    for bit in bits:
        cur = [
            [b.select(bit, hi, lo) for lo, hi in zip(cur[2 * i], cur[2 * i + 1])]
            for i in range(len(cur) // 2)
        ]
    assert len(cur) == 1
    return cur[0]


def verify_merkle_path_circuit(
    b: CircuitBuilder,
    leaf: List[Target],
    idx_bits: List[Target],
    siblings: List[List[Target]],
    cap_rows: List[List[Target]],
) -> None:
    """In-circuit Merkle path to a cap, sibling order selected by index bits.

    Consumes idx_bits[:depth] for ordering and idx_bits[depth:depth+ch] for
    cap selection (depth = len(siblings), ch = log2 len(cap))."""
    if len(leaf) <= 4:
        digest = list(leaf) + [b.zero()] * (4 - len(leaf))
    else:
        digest = b.hash_no_pad(leaf)
    depth = len(siblings)
    for lvl in range(depth):
        bit = idx_bits[lvl]
        sib = siblings[lvl]
        left = [b.select(bit, sib[i], digest[i]) for i in range(4)]
        right = [b.select(bit, digest[i], sib[i]) for i in range(4)]
        digest = b.hash_no_pad(left + right)
    ch = (len(cap_rows)).bit_length() - 1
    cap_bits = idx_bits[depth : depth + ch]
    expected = _mux_rows(b, cap_rows, cap_bits)
    for i in range(4):
        b.connect(digest[i], expected[i])


def _x_from_bits(
    b: CircuitBuilder, bits: List[Target], log_size: int, shift: int
) -> Target:
    """Domain point shift * w^rev(i) from the LSB-first bits of i.

    Bit j of i contributes exponent 2^(log_size-1-j) after bit-reversal."""
    w = ntt._root_of_unity(log_size)
    acc = b.constant(shift)
    for j, bit in enumerate(bits[:log_size]):
        wp = pow(w, 1 << (log_size - 1 - j), P)
        factor = b.select(bit, b.constant(wp), b.one())
        acc = b.mul(acc, factor)
    return acc


def _ext_pow_const(b: CircuitBuilder, x: ExtTarget, e: int) -> ExtTarget:
    """x^e for a compile-time exponent (square-and-multiply)."""
    from mp2_tpu_torch.circuit.gadgets.ext2 import ext_one

    acc = ext_one(b)
    base = x
    while e:
        if e & 1:
            acc = ext_mul(b, acc, base)
        base = ext_mul(b, base, base)
        e >>= 1
    return acc


def _horner_ext(
    b: CircuitBuilder, terms: List[ExtTarget], alpha: ExtTarget
) -> ExtTarget:
    """sum_i alpha^i terms[i] via Horner (terms[0] gets alpha^0)."""
    from mp2_tpu_torch.circuit.gadgets.ext2 import ext_zero

    acc = ext_zero(b)
    for t in reversed(terms):
        acc = ext_add(b, ext_mul(b, acc, alpha), t)
    return acc


# ---------------------------------------------------------------------------
# the verifier
# ---------------------------------------------------------------------------


def verify_proof_circuit(
    b: CircuitBuilder,
    common: CommonData,
    pt: ProofTargets,
    fixed_cap: List[List[Target]],
) -> List[Target]:
    """Add the complete verification constraint system for `pt` against the
    inner circuit committed by `fixed_cap`.  Returns the inner circuit
    digest targets (for circuit-set membership checks by the caller)."""
    cfg = common.config
    nc = cfg.num_challenges
    T = common.T
    nC = cfg.num_constants
    W = cfg.num_wires
    npp = cfg.num_partial_products
    chunk = cfg.permutation_chunk_size
    n_chunks = -(-W // chunk)
    qk = cfg.quotient_degree_factor
    log_big = common.log_big

    pi_hash = b.hash_no_pad(pt.public_inputs)

    # inner circuit digest, recomputed from the committed fixed cap
    # (prove.py:_build_fixed) — a prover cannot claim a digest that does not
    # match the cap it opens against
    flat_cap = [t for row in fixed_cap for t in row]
    digest = b.hash_no_pad(
        flat_cap
        + [b.constant(common.n), b.constant(W), b.constant(nc)]
    )

    ch = CircuitChallenger(b)
    ch.observe(digest)
    ch.observe(pi_hash)
    for row in pt.wires_cap:
        ch.observe(row)
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    for row in pt.zs_cap:
        ch.observe(row)
    alphas = ch.get_n_challenges(nc)
    for row in pt.quotient_cap:
        ch.observe(row)
    zeta = ch.get_extension_challenge()
    for o in pt.openings:
        ch.observe(o[0])
        ch.observe(o[1])
    alpha_fri = ch.get_extension_challenge()

    fixed_o, wires_o, zs_o, quo_o, zs_next_o = pt.openings_split(common)
    sel = fixed_o[:T]
    consts = fixed_o[T : T + nC]
    sigmas = fixed_o[T + nC :]

    # ---- zeta identity ----
    alg = CircuitExtAlgebra(b)
    extras = {"pi_hash": [ext_from_base(b, h) for h in pi_hash]}
    terms: List[ExtTarget] = []
    for t, (name, gate) in enumerate(common.gate_types):
        for c in gate.constraints(alg, wires_o, consts, extras):
            terms.append(ext_mul(b, sel[t], c))

    zeta_n = zeta
    for _ in range(common.log_n):
        zeta_n = ext_mul(b, zeta_n, zeta_n)
    one = alg.one
    zh = ext_sub(b, zeta_n, one)
    denom = ext_mul_const(b, ext_sub(b, zeta, one), common.n)
    l0 = ext_mul(b, zh, ext_inv(b, denom))

    for c in range(nc):
        beta, gamma = betas[c], gammas[c]
        gamma_e = ext_from_base(b, gamma)
        base = c * (1 + npp)
        z = zs_o[base]
        partials = [zs_o[base + 1 + t] for t in range(npp)]
        z_next = zs_next_o[c]
        terms.append(ext_mul(b, l0, ext_sub(b, z, one)))
        pps = [z] + partials + [z_next]
        for t in range(n_chunks):
            num = one
            den = one
            for j in range(t * chunk, min((t + 1) * chunk, W)):
                kx = ext_mul_base(
                    b, ext_mul_const(b, zeta, common.k_coeffs[j]), beta
                )
                nj = ext_add(b, ext_add(b, wires_o[j], kx), gamma_e)
                sj = ext_add(
                    b,
                    ext_add(b, wires_o[j], ext_mul_base(b, sigmas[j], beta)),
                    gamma_e,
                )
                num = ext_mul(b, num, nj)
                den = ext_mul(b, den, sj)
            terms.append(
                ext_sub(
                    b, ext_mul(b, pps[t + 1], den), ext_mul(b, pps[t], num)
                )
            )

    for c in range(nc):
        alpha_e = ext_from_base(b, alphas[c])
        acc = _horner_ext(b, terms, alpha_e)
        q = _horner_ext(b, quo_o[c * qk : (c + 1) * qk], zeta_n)
        ext_connect(b, acc, ext_mul(b, zh, q))

    # ---- FRI ----
    betas_fri: List[ExtTarget] = []
    for cap in pt.fri_commit_caps:
        for row in cap:
            ch.observe(row)
        betas_fri.append(ch.get_extension_challenge())
    for a, bb in pt.fri_final_poly:
        ch.observe(a)
        ch.observe(bb)
    ch.observe(pt.fri_pow_witness)
    pow_response = ch.get_challenge()
    if cfg.fri.proof_of_work_bits:
        # response < 2^(64 - pow_bits) <=> top pow_bits are zero
        b.decompose_bits(pow_response, 64 - cfg.fri.proof_of_work_bits)

    query_challenges = ch.get_n_challenges(cfg.fri.num_query_rounds)

    z_col_offsets = [c * (1 + npp) for c in range(nc)]
    b1_openings = fixed_o + wires_o + zs_o + quo_o
    n1 = len(b1_openings)
    shift_pow = _ext_pow_const(b, alpha_fri, n1)
    g = ntt._root_of_unity(common.log_n)
    gzeta = ext_mul_const(b, zeta, g)

    oracle_caps = [fixed_cap, pt.wires_cap, pt.zs_cap, pt.quotient_cap]

    for qt, xc in zip(pt.fri_query_rounds, query_challenges):
        bits = b.decompose_bits(xc, 64)
        idx_bits = bits[:log_big]

        # 1. initial oracle openings
        for leaf, sibs, cap in zip(
            qt.initial_leaves, qt.initial_siblings, oracle_caps
        ):
            verify_merkle_path_circuit(b, leaf, idx_bits, sibs, cap)

        # 2. expected evaluation of the combined polynomial at idx
        x = _x_from_bits(b, idx_bits, log_big, SHIFT)
        vals = [t for leaf in qt.initial_leaves for t in leaf]
        assert len(vals) == n1
        diffs1 = [
            (b.sub(v, o[0]), b.mul_const(P - 1, o[1]))
            for v, o in zip(vals, b1_openings)
        ]
        acc1 = _horner_ext(b, diffs1, alpha_fri)
        xe = ext_from_base(b, x)
        acc1 = ext_mul(b, acc1, ext_inv(b, ext_sub(b, xe, zeta)))
        zs_leaf = qt.initial_leaves[2]
        diffs2 = [
            (b.sub(zs_leaf[off], o[0]), b.mul_const(P - 1, o[1]))
            for off, o in zip(z_col_offsets, zs_next_o)
        ]
        acc2 = _horner_ext(b, diffs2, alpha_fri)
        acc2 = ext_mul(b, acc2, ext_inv(b, ext_sub(b, xe, gzeta)))
        ev = ext_add(b, acc1, ext_mul(b, shift_pow, acc2))

        # 3. fold rounds
        cur_shift = SHIFT
        for r, st in enumerate(qt.steps):
            cur_log = log_big - r
            pair_bits = idx_bits[r + 1 :]
            leaf4 = [st.pair[0][0], st.pair[0][1], st.pair[1][0], st.pair[1][1]]
            verify_merkle_path_circuit(
                b, leaf4, pair_bits, st.siblings, pt.fri_commit_caps[r]
            )
            parity = idx_bits[r]
            mine = ext_select(b, parity, st.pair[1], st.pair[0])
            ext_connect(b, ev, mine)
            # x at the pair's even slot: cur_shift * w^rev(2*pair_idx);
            # bit k of pair_idx contributes exponent 2^(cur_log-2-k)
            w = ntt._root_of_unity(cur_log)
            xacc = b.constant(cur_shift)
            for k in range(cur_log - 1):
                wp = pow(w, 1 << (cur_log - 2 - k), P)
                xacc = b.mul(
                    xacc, b.select(idx_bits[r + 1 + k], b.constant(wp), b.one())
                )
            inv2x = base_inv(b, b.mul_const(2, xacc))
            e, o = st.pair
            s = ext_mul_const(b, ext_add(b, e, o), (P + 1) // 2)
            d = ext_mul_base(b, ext_sub(b, e, o), inv2x)
            ev = ext_add(b, s, ext_mul(b, betas_fri[r], d))
            cur_shift = cur_shift * cur_shift % P

        # 4. final polynomial evaluation at the residual point
        nf = common.num_folds
        cur_log = log_big - nf
        w = ntt._root_of_unity(cur_log)
        xacc = b.constant(cur_shift)
        for k in range(cur_log):
            wp = pow(w, 1 << (cur_log - 1 - k), P)
            xacc = b.mul(
                xacc, b.select(idx_bits[nf + k], b.constant(wp), b.one())
            )
        from mp2_tpu_torch.circuit.gadgets.ext2 import ext_zero

        facc = ext_zero(b)
        for cterm in reversed(pt.fri_final_poly):
            facc = ext_add(b, ext_mul_base(b, facc, xacc), cterm)
        ext_connect(b, ev, facc)

    return digest
