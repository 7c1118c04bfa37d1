"""Wrap chain + circuit-set membership + universal verifier: the fixed-VK
recursion core.

Protocol (reference: recursion-framework/src/universal_verifier_gadget/):

  * every member circuit's proof is WRAPPED — re-proved by a circuit that
    verifies it with the member's verifier data BAKED in — repeatedly until
    the proof shape equals the STANDARD shape (wrap_circuit.rs:51-118; the
    standard shape is the self-wrap fixed point, found by iterating
    `shape(wrap(shape))` instead of a hardcoded RECURSION_THRESHOLD);
  * all wrapped proofs therefore share ONE CommonData, so a single
    UNIVERSAL VERIFIER gadget (witnessed fixed-cap + recomputed circuit
    digest) verifies any of them (verifier_gadget.rs);
  * the recomputed digest is Merkle-checked against the CIRCUIT SET digest
    (circuit_set.rs:90-136), which every member exposes as its trailing 4
    public inputs; aggregation circuits additionally pin each child's
    trailing PIs to their own, so one host-side equality at the outermost
    proof fixes the set digest for the whole tree — the fixed-VK property.

Layout convention: member public inputs = [user PIs ... , set_digest(4)].

Port of `mp2_tpu/recursion/wrap.py`: the builders take the device that the
compiled circuits' fixed data live on, and the standard-shape cache is keyed
by it too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.prover.config import CircuitConfig
from mp2_tpu_torch.prover.prove import CircuitData, Proof, prove
from mp2_tpu_torch.recursion.framework import CircuitSet
from mp2_tpu_torch.recursion.verifier_gadget import (
    CommonData,
    ProofTargets,
    add_virtual_proof,
    set_proof_witness,
    verify_proof_circuit,
)

HashOut = Tuple[int, int, int, int]


# ---------------------------------------------------------------------------
# wrap circuit
# ---------------------------------------------------------------------------


@dataclass
class WrapCircuit:
    """Verifies one proof of a FIXED inner circuit (cap baked as constants)
    and re-exposes the inner's public inputs as its own."""

    data: CircuitData
    proof_targets: ProofTargets
    inner_shape: Tuple

    def prove_wrap(self, inner_proof: Proof) -> Proof:
        inputs: Dict = {}
        set_proof_witness(inputs, self.proof_targets, inner_proof)
        w = self.data.generate_witness(inputs)
        return prove(self.data, w, list(inner_proof.public_inputs))


def build_wrap_circuit(
    common: CommonData,
    fixed_cap_host: Sequence[HashOut],
    device,
    min_rows: int = 0,
) -> WrapCircuit:
    b = CircuitBuilder(common.config)
    pt = add_virtual_proof(b, common)
    cap = [[b.constant(int(v)) for v in row] for row in fixed_cap_host]
    verify_proof_circuit(b, common, pt, cap)
    b.register_public_inputs(pt.public_inputs)
    data = b.build(device, min_rows=min_rows)
    return WrapCircuit(
        data=data, proof_targets=pt, inner_shape=common.shape_key()
    )


# ---------------------------------------------------------------------------
# in-circuit circuit-set membership
# ---------------------------------------------------------------------------


def check_membership_circuit(
    b: CircuitBuilder,
    digest: Sequence[Target],
    index_bits: Sequence[Target],
    siblings: Sequence[Sequence[Target]],
    set_digest: Sequence[Target],
) -> None:
    """Merkle membership of a circuit digest under the set digest
    (universal_verifier_gadget/circuit_set.rs:90-123)."""
    h = list(digest)
    for bit, sib in zip(index_bits, siblings):
        # booleanity of the witnessed index bit
        b.connect(b.mul(bit, bit), bit)
        left = [b.select(bit, sib[i], h[i]) for i in range(4)]
        right = [b.select(bit, h[i], sib[i]) for i in range(4)]
        h = b.hash_no_pad(left + right)
    for i in range(4):
        b.connect(h[i], set_digest[i])


# ---------------------------------------------------------------------------
# universal verifier (witnessed verifier data + membership)
# ---------------------------------------------------------------------------


@dataclass
class UniversalVerifierTargets:
    proof: ProofTargets
    fixed_cap: List[List[Target]]
    index_bits: List[Target]
    siblings: List[List[List[Target]]]  # (set_height, 4)... rows of 4

    def public_inputs(self) -> List[Target]:
        return self.proof.public_inputs


def add_universal_verifier(
    b: CircuitBuilder,
    standard: CommonData,
    set_height: int,
    set_digest: Sequence[Target],
) -> UniversalVerifierTargets:
    """Verify one STANDARD-shape proof of any member circuit: full FRI
    verification against a witnessed fixed cap, digest recomputation, and
    set membership — the counterpart of verifier_gadget.rs + circuit_set.rs."""
    pt = add_virtual_proof(b, standard)
    fixed_cap = [b.add_inputs(4) for _ in range(1 << standard.cap_height)]
    digest = verify_proof_circuit(b, standard, pt, fixed_cap)
    index_bits = b.add_inputs(set_height)
    siblings = [b.add_inputs(4) for _ in range(set_height)]
    check_membership_circuit(b, digest, index_bits, siblings, set_digest)
    # the child's claimed set digest (trailing 4 PIs) must be THIS set digest
    for i in range(4):
        b.connect(pt.public_inputs[-4 + i], set_digest[i])
    return UniversalVerifierTargets(
        proof=pt, fixed_cap=fixed_cap, index_bits=index_bits, siblings=siblings
    )


def set_universal_witness(
    inputs: Dict,
    uv: UniversalVerifierTargets,
    wrapped_proof: Proof,
    wrap_cap: Sequence[HashOut],
    member_index: int,
    membership_path: Sequence[HashOut],
) -> None:
    set_proof_witness(inputs, uv.proof, wrapped_proof)
    for row_t, row in zip(uv.fixed_cap, wrap_cap):
        for t, v in zip(row_t, row):
            inputs[t] = int(v)
    for k, t in enumerate(uv.index_bits):
        inputs[t] = (member_index >> k) & 1
    for row_t, row in zip(uv.siblings, membership_path):
        for t, v in zip(row_t, row):
            inputs[t] = int(v)


# ---------------------------------------------------------------------------
# standard shape discovery (the wrap fixed point)
# ---------------------------------------------------------------------------

_STANDARD_CACHE: Dict = {}


def discover_standard(
    cfg: CircuitConfig, num_pis: int, device, max_iters: int = 6
) -> Tuple[CommonData, List[WrapCircuit]]:
    """Iterate shape(wrap(shape)) from a minimal seed circuit until the
    wrap shape is a fixed point.  Returns (standard CommonData, the chain of
    wrap circuits used for discovery — reusable for the seed only)."""
    device = torch.device(device)
    key = (cfg, num_pis, device)
    if key in _STANDARD_CACHE:
        return _STANDARD_CACHE[key]
    b = CircuitBuilder(cfg)
    xs = b.add_inputs(num_pis)
    b.register_public_inputs(xs)
    seed = b.build(device)
    cur = seed
    chain: List[WrapCircuit] = []
    prev_key = None
    for _ in range(max_iters):
        wc = build_wrap_circuit(CommonData.of(cur), cur.fixed_cap_host, device)
        chain.append(wc)
        k = CommonData.of(wc.data).shape_key()
        if k == prev_key:
            std = CommonData.of(wc.data)
            _STANDARD_CACHE[key] = (std, chain)
            return std, chain
        prev_key = k
        cur = wc.data
    raise RuntimeError("wrap shape did not reach a fixed point")
