"""RecursionFramework: the fixed-VK runtime over wrap + universal verifier.

Counterpart of the reference's `RecursiveCircuits` (recursion-framework/src/
framework.rs:68-267): a declared set of member circuits — leaves and
aggregations — whose proofs all wrap to one STANDARD shape; aggregation
members verify children IN-CIRCUIT through the universal verifier gadget
(witnessed verifier cap + recomputed digest + Merkle membership in the
circuit set), and every member exposes the circuit-set digest as trailing
public inputs, so the set digest IS the fixed verification key.

Usage:
    fw = RecursionFramework(cfg, num_user_pis=K)
    fw.add_leaf_circuit("leaf", build_fn)         # build_fn(b) -> assign_fn
    fw.add_aggregation_circuit("node", 2, build_fn)  # build_fn(b, children)
    fw.finalize()
    env = fw.prove_leaf("leaf", user_inputs, user_pis)
    agg = fw.prove_aggregation("node", [env1, env2], user_inputs, user_pis)
    assert fw.verify(agg)

Port of `mp2_tpu/recursion/runtime.py`.  The framework takes the device its
circuits are compiled for and proved on (`device="cuda"` unless the caller
asks for the CPU), and every stage of the batched paths (member and each
wrap level) runs through the port's `prover/batch.prove_batch`.  Set-up
(the constructor, the `add_*` methods and `finalize`) runs with Python's
cyclic garbage collector paused (`utils.collector_paused`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.prover.config import CircuitConfig
from mp2_tpu_torch.prover.batch import prove_batch
from mp2_tpu_torch.prover.prove import CircuitData, Proof, prove
from mp2_tpu_torch.prover.serde import proof_from_dict, proof_to_dict
from mp2_tpu_torch.prover.verify import verify as tp2_verify
from mp2_tpu_torch.recursion.framework import CircuitSet
from mp2_tpu_torch.recursion.verifier_gadget import CommonData, set_proof_witness
from mp2_tpu_torch.recursion.wrap import (
    UniversalVerifierTargets,
    WrapCircuit,
    add_universal_verifier,
    build_wrap_circuit,
    discover_standard,
    set_universal_witness,
)
from mp2_tpu_torch.utils import collector_paused
from mp2_tpu_torch.utils.trace import span

HashOut = Tuple[int, int, int, int]


@dataclass
class WrappedEnvelope:
    """A member proof wrapped to the standard shape (stage output;
    role of the reference's ProofWithVK, mp2-common/src/proof.rs:42)."""

    member: str
    proof: Proof  # standard-shape wrapped proof

    @property
    def public_inputs(self) -> List[int]:
        return list(self.proof.public_inputs)

    @property
    def user_inputs(self) -> List[int]:
        return list(self.proof.public_inputs[:-4])

    def to_dict(self) -> Dict:
        return {"member": self.member, "proof": proof_to_dict(self.proof)}

    @staticmethod
    def from_dict(d: Dict) -> "WrappedEnvelope":
        return WrappedEnvelope(
            member=d["member"], proof=proof_from_dict(d["proof"])
        )


@dataclass
class _Member:
    name: str
    data: CircuitData
    assign: Callable  # assign(inputs_dict, *user_args) fills witness inputs
    sd_targets: List[Target]
    uvs: List[UniversalVerifierTargets]
    wrap: Optional[WrapCircuit] = None
    # cross-set verifiers: (foreign framework, targets) per slot
    foreign_uvs: List = field(default_factory=list)

    @property
    def digest(self) -> HashOut:
        return tuple(self.wrap.data.circuit_digest)


class RecursionFramework:
    @collector_paused()
    def __init__(
        self,
        config: CircuitConfig,
        num_user_pis: int,
        set_height: int = 4,
        device="cuda",
    ):
        self.config = config
        self.device = torch.device(device)
        self.num_user_pis = num_user_pis
        self.num_pis = num_user_pis + 4  # + trailing set digest
        self.set_height = set_height
        self.standard, _ = discover_standard(config, self.num_pis, self.device)
        self.members: Dict[str, _Member] = {}
        self.member_order: List[str] = []
        self.circuit_set: Optional[CircuitSet] = None
        self._wrap_cache: Dict = {}

    # ------------------------------------------------------------- declare
    @collector_paused()
    def add_leaf_circuit(self, name: str, build_fn: Callable) -> None:
        """build_fn(b) must register EXACTLY num_user_pis public inputs and
        return assign(inputs_dict, *user_args)."""
        b = CircuitBuilder(self.config)
        assign = build_fn(b)
        self._finish_member(name, b, assign, [])

    @collector_paused()
    def add_aggregation_circuit(
        self,
        name: str,
        n_children: int,
        build_fn: Callable,
        foreign: Sequence["RecursionFramework"] = (),
    ) -> None:
        """build_fn(b, children, foreign_children) — children's claimed
        public inputs are children[i].public_inputs() targets.

        `foreign`: one FINALIZED foreign framework per cross-set verifier
        slot (the reference's RecursiveCircuitsVerifierGagdet,
        framework.rs:188-267): the foreign set digest is baked as constants,
        chaining the layers' VKs like build_circuits_params does."""
        b = CircuitBuilder(self.config)
        sd = b.add_inputs(4)
        uvs = [
            add_universal_verifier(b, self.standard, self.set_height, sd)
            for _ in range(n_children)
        ]
        fuvs = []
        for fw in foreign:
            assert fw.circuit_set is not None, "foreign set must be finalized"
            fsd = [b.constant(int(v)) for v in fw.set_digest]
            fuvs.append(
                add_universal_verifier(b, fw.standard, fw.set_height, fsd)
            )
        if fuvs:
            assign = build_fn(b, uvs, fuvs)
        else:
            assign = build_fn(b, uvs)
        m = self._finish_member(name, b, assign, uvs, sd)
        m.foreign_uvs = list(zip(foreign, fuvs))

    def _finish_member(self, name, b, assign, uvs, sd=None):
        assert name not in self.members, f"duplicate member {name}"
        assert len(b.public_inputs) == self.num_user_pis, (
            f"{name}: registered {len(b.public_inputs)} user PIs, "
            f"need {self.num_user_pis}"
        )
        if sd is None:
            sd = b.add_inputs(4)
        b.register_public_inputs(sd)
        data = b.build(self.device)
        m = _Member(
            name=name, data=data, assign=assign, sd_targets=sd, uvs=uvs
        )
        self.members[name] = m
        self.member_order.append(name)
        return m

    # ------------------------------------------------------------ finalize
    def _wrap_for(self, data: CircuitData) -> WrapCircuit:
        key = (CommonData.of(data).shape_key(), tuple(data.circuit_digest))
        if key not in self._wrap_cache:
            self._wrap_cache[key] = build_wrap_circuit(
                CommonData.of(data), data.fixed_cap_host, self.device,
                min_rows=self.standard.n,
            )
        return self._wrap_cache[key]

    def _wrap_chain_for(self, data: CircuitData):
        """Wrap circuits from `data`'s shape down to the standard shape
        (large members need TWO wraps: the first shrinks, the second lands
        exactly on the standard — wrap_circuit.rs's shrink loop)."""
        chain = []
        guard = 0
        while CommonData.of(data).shape_key() != self.standard.shape_key():
            wc = self._wrap_for(data)
            chain.append(wc)
            data = wc.data
            guard += 1
            assert guard <= 4, "wrap chain failed to converge"
        if not chain:
            chain = [self._wrap_for(data)]
        return chain

    @collector_paused()
    def finalize(self) -> HashOut:
        """Build every member's wrap chain, assemble the circuit set.
        Returns the set digest — the fixed verification key."""
        assert len(self.members) <= (1 << self.set_height)
        for name in self.member_order:
            m = self.members[name]
            chain = self._wrap_chain_for(m.data)
            m.wrap = chain[-1]
            got = CommonData.of(m.wrap.data).shape_key()
            assert got == self.standard.shape_key(), (
                f"{name}: wrap chain did not land on the standard shape"
            )
        digests = [self.members[n].digest for n in self.member_order]
        # pad to the declared set height so membership paths have fixed len
        pad = (1 << self.set_height) - len(digests)
        digests = digests + [digests[-1]] * pad
        self.circuit_set = CircuitSet(digests)
        return self.set_digest

    @property
    def set_digest(self) -> HashOut:
        return tuple(self.circuit_set.digest)

    # -------------------------------------------------------------- prove
    def wrap_to_standard(self, data: CircuitData, proof: Proof) -> Proof:
        """Wrap chain: re-prove until the proof has the standard shape.
        ALWAYS wraps at least once — a member circuit can be shape-identical
        to the standard (e.g. a single-verifier member), but its envelope
        digest is the wrap circuit's, so verification expects the wrap."""
        std = self.standard.shape_key()
        guard = 0
        wrapped = False
        while not wrapped or CommonData.of(data).shape_key() != std:
            wc = self._wrap_for(data)
            proof = wc.prove_wrap(proof)
            data = wc.data
            wrapped = True
            guard += 1
            assert guard <= 4, "wrap chain failed to converge"
        return proof

    def _prove_member(
        self,
        m: _Member,
        inputs: Dict,
        user_pis: Sequence[int],
    ) -> WrappedEnvelope:
        sd = self.set_digest
        for t, v in zip(m.sd_targets, sd):
            inputs[t] = int(v)
        pis = [int(x) for x in user_pis] + [int(v) for v in sd]
        assert len(pis) == self.num_pis
        with span("prove_member", member=m.name):
            with span("witness"):
                w = m.data.generate_witness(inputs)
            with span("prove"):
                proof = prove(m.data, w, pis)
            with span("wrap"):
                wrapped = self.wrap_to_standard(m.data, proof)
        return WrappedEnvelope(member=m.name, proof=wrapped)

    # -------------------------------------------------------------- batched
    def _prove_members_batch(
        self,
        m: _Member,
        inputs_list: List[Dict],
        pis_list: Sequence[Sequence[int]],
    ) -> List[WrappedEnvelope]:
        """B same-member proofs per device dispatch (the map-phase batch):
        the member stage AND every wrap-chain level run through
        prover.batch.prove_batch — one staged dispatch sequence per level
        instead of one per proof.  Bit-identical to the serial path."""
        sd = self.set_digest
        full_pis = []
        wits = []
        with span("witness_batch", member=m.name, B=len(inputs_list)):
            for inputs, user_pis in zip(inputs_list, pis_list):
                for t, v in zip(m.sd_targets, sd):
                    inputs[t] = int(v)
                pis = [int(x) for x in user_pis] + [int(v) for v in sd]
                assert len(pis) == self.num_pis
                full_pis.append(pis)
                wits.append(m.data.generate_witness(inputs))
        with span("prove_batch", member=m.name, B=len(wits)):
            proofs = prove_batch(m.data, np.stack(wits), full_pis)

        # wrap chain, one batched prove per level
        data = m.data
        std = self.standard.shape_key()
        wrapped = False
        guard = 0
        while not wrapped or CommonData.of(data).shape_key() != std:
            wc = self._wrap_for(data)
            with span("wrap_batch", level=guard, B=len(proofs)):
                wrap_wits = []
                with span("witness_batch", member=m.name, level=guard):
                    for p in proofs:
                        winputs: Dict = {}
                        set_proof_witness(winputs, wc.proof_targets, p)
                        wrap_wits.append(wc.data.generate_witness(winputs))
                with span("prove_batch", member=m.name, level=guard):
                    proofs = prove_batch(
                        wc.data, np.stack(wrap_wits),
                        [list(p.public_inputs) for p in proofs],
                    )
            data = wc.data
            wrapped = True
            guard += 1
            assert guard <= 4, "wrap chain failed to converge"
        return [WrappedEnvelope(member=m.name, proof=p) for p in proofs]

    def prove_leaves_batch(
        self, name: str, args_list: Sequence[Sequence],
        pis_list: Sequence[Sequence[int]],
    ) -> List[WrappedEnvelope]:
        """Batch counterpart of prove_leaf: B independent leaf witnesses
        proved per dispatch sequence at every stage."""
        m = self.members[name]
        inputs_list: List[Dict] = []
        for args in args_list:
            inputs: Dict = {}
            m.assign(inputs, *args)
            inputs_list.append(inputs)
        return self._prove_members_batch(m, inputs_list, pis_list)

    def prove_aggregations_batch(
        self,
        name: str,
        children_list: Sequence[Sequence[WrappedEnvelope]],
        args_list: Sequence[Sequence],
        pis_list: Sequence[Sequence[int]],
        foreign_children_list: Optional[Sequence[Sequence[WrappedEnvelope]]] = None,
    ) -> List[WrappedEnvelope]:
        """Batch counterpart of prove_aggregation: B same-member
        aggregations (one reduce-tree level) per dispatch sequence."""
        m = self.members[name]
        if foreign_children_list is None:
            foreign_children_list = [()] * len(children_list)
        inputs_list: List[Dict] = []
        for children, args, foreign in zip(
            children_list, args_list, foreign_children_list
        ):
            assert len(children) == len(m.uvs), "child count mismatch"
            assert len(foreign) == len(m.foreign_uvs), (
                "foreign child count mismatch"
            )
            inputs: Dict = {}
            for uv, env in zip(m.uvs, children):
                self._set_child_witness(inputs, self, uv, env)
            for (fw, uv), env in zip(m.foreign_uvs, foreign):
                self._set_child_witness(inputs, fw, uv, env)
            if m.assign is not None:
                m.assign(inputs, *args)
            inputs_list.append(inputs)
        return self._prove_members_batch(m, inputs_list, pis_list)

    def prove_leaf(
        self, name: str, user_args: Sequence, user_pis: Sequence[int]
    ) -> WrappedEnvelope:
        m = self.members[name]
        inputs: Dict = {}
        m.assign(inputs, *user_args)
        return self._prove_member(m, inputs, user_pis)

    def prove_aggregation(
        self,
        name: str,
        children: Sequence[WrappedEnvelope],
        user_args: Sequence,
        user_pis: Sequence[int],
        foreign_children: Sequence[WrappedEnvelope] = (),
    ) -> WrappedEnvelope:
        m = self.members[name]
        assert len(children) == len(m.uvs), "child count mismatch"
        assert len(foreign_children) == len(m.foreign_uvs), (
            "foreign child count mismatch"
        )
        inputs: Dict = {}
        for uv, env in zip(m.uvs, children):
            self._set_child_witness(inputs, self, uv, env)
        for (fw, uv), env in zip(m.foreign_uvs, foreign_children):
            self._set_child_witness(inputs, fw, uv, env)
        if m.assign is not None:
            m.assign(inputs, *user_args)
        return self._prove_member(m, inputs, user_pis)

    @staticmethod
    def _set_child_witness(inputs, fw, uv, env):
        child = fw.members[env.member]
        idx = fw.member_order.index(env.member)
        path = fw.circuit_set.membership_path(child.digest)
        set_universal_witness(
            inputs, uv, env.proof, child.wrap.data.fixed_cap_host, idx, path
        )

    # -------------------------------------------------------------- verify
    def verify(self, env: WrappedEnvelope) -> bool:
        """Host verification of a wrapped proof: ONE check of one proof —
        everything below it is enforced in-circuit (the fixed-VK claim)."""
        m = self.members.get(env.member)
        if m is None or m.wrap is None:
            return False
        if tuple(env.proof.public_inputs[-4:]) != self.set_digest:
            return False
        if m.digest not in [tuple(d) for d in self.circuit_set.digests]:
            return False
        return tp2_verify(m.wrap.data, env.proof)
