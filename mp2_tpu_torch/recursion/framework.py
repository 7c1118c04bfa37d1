"""Fixed-VK recursive aggregation framework (structure + backends).

A jax-free copy of `mp2_tpu/recursion/framework.py`: only the imports
change.  The port's `TP2Backend` lives in `recursion/tp2_backend.py`.

Role of the reference's recursion-framework (SURVEY.md §2.2): a declared set
of circuits whose proofs can verify each other under ONE constant
verification key.  The protocol pieces reproduced here:

  * CircuitSet: Merkle tree (cap height 0) over member circuit digests; the
    set digest is the fixed VK; membership paths authorize a proof's circuit
    (universal_verifier_gadget/circuit_set.rs:90-136)
  * ProofWithVK envelope: (proof payload, member digest, membership path) —
    every stage input/output serializes, keeping the map phase stateless
    (mp2-common/src/proof.rs:42)
  * RecursiveCircuits runtime API: generate_proof(circuit, child_proofs,
    inputs) (framework.rs:105-121)

Proving backends:
  * DummyBackend — Poseidon attestations over declared public inputs, the
    counterpart of the reference's `TestingRecursiveCircuits`/DummyCircuit
    (framework_testing.rs:29-220): lets every aggregation layer run and be
    tested without the lower layers.  NOT sound; never for production.
  * TP2Backend — real TP2 plonk proofs (mp2_tpu.prover) for circuits built
    with the CircuitBuilder.  In-circuit verification of child proofs (the
    universal verifier gadget + wrap chain to degree 12) is the next
    milestone; until then child proofs are checked host-side at aggregation
    time and child PI hashes are bound into the parent's public inputs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mp2_tpu_torch.hash import poseidon2_host as p2h

HashOut = Tuple[int, int, int, int]


# ---------------------------------------------------------------------------
# circuit set
# ---------------------------------------------------------------------------


class CircuitSet:
    """Merkle tree (cap height 0) over member circuit digests."""

    def __init__(self, digests: Sequence[HashOut]):
        assert digests
        self.digests = [tuple(d) for d in digests]
        n = 1
        while n < len(self.digests):
            n *= 2
        leaves = list(self.digests) + [self.digests[-1]] * (n - len(self.digests))
        levels = [leaves]
        while len(levels[-1]) > 1:
            lvl = levels[-1]
            levels.append(
                [p2h.two_to_one(lvl[i], lvl[i + 1]) for i in range(0, len(lvl), 2)]
            )
        self._levels = levels

    @property
    def digest(self) -> HashOut:
        return self._levels[-1][0]

    def membership_path(self, circuit_digest: HashOut) -> List[HashOut]:
        idx = self.digests.index(tuple(circuit_digest))
        path = []
        i = idx
        for lvl in self._levels[:-1]:
            path.append(lvl[i ^ 1])
            i >>= 1
        return path

    @staticmethod
    def verify_membership(
        set_digest: HashOut, circuit_digest: HashOut, index: int, path: Sequence[HashOut]
    ) -> bool:
        h = tuple(circuit_digest)
        i = index
        for sib in path:
            h = p2h.two_to_one(sib, h) if i & 1 else p2h.two_to_one(h, sib)
            i >>= 1
        return h == tuple(set_digest)

    def index_of(self, circuit_digest: HashOut) -> int:
        return self.digests.index(tuple(circuit_digest))


# ---------------------------------------------------------------------------
# proof envelope
# ---------------------------------------------------------------------------


@dataclass
class ProofWithVK:
    """Serializable proof envelope: stage outputs travel as bytes."""

    circuit_digest: HashOut
    public_inputs: List[int]
    payload: Dict  # backend-specific

    def serialize(self) -> bytes:
        return json.dumps(
            {
                "circuit_digest": list(self.circuit_digest),
                "public_inputs": self.public_inputs,
                "payload": self.payload,
            },
            sort_keys=True,
        ).encode()

    @staticmethod
    def deserialize(data: bytes) -> "ProofWithVK":
        d = json.loads(data.decode())
        return ProofWithVK(
            circuit_digest=tuple(d["circuit_digest"]),
            public_inputs=[int(x) for x in d["public_inputs"]],
            payload=d["payload"],
        )


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class DummyBackend:
    """Attestation-only backend (testing / pipeline plumbing)."""

    name = "dummy"

    def circuit_digest(self, circuit_name: str) -> HashOut:
        return p2h.hash_no_pad([ord(c) for c in f"dummy/{circuit_name}"])

    def prove(
        self,
        circuit_name: str,
        public_inputs: Sequence[int],
        child_proofs: Sequence[ProofWithVK],
    ) -> Dict:
        att = p2h.hash_no_pad(
            list(self.circuit_digest(circuit_name))
            + [int(x) for x in public_inputs]
            + [x for p in child_proofs for x in p.public_inputs]
        )
        return {
            "kind": "dummy",
            "attestation": list(att),
            "children": [list(p.circuit_digest) for p in child_proofs],
        }

    def verify(
        self,
        circuit_name: str,
        proof: ProofWithVK,
        child_proofs: Sequence[ProofWithVK] = (),
    ) -> bool:
        att = p2h.hash_no_pad(
            list(self.circuit_digest(circuit_name))
            + [int(x) for x in proof.public_inputs]
            + [x for p in child_proofs for x in p.public_inputs]
        )
        return list(att) == proof.payload.get("attestation")


class RecursiveCircuits:
    """Runtime over a declared circuit set with a pluggable backend."""

    def __init__(self, circuit_names: Sequence[str], backend=None):
        self.backend = backend or DummyBackend()
        self.circuit_names = list(circuit_names)
        self.digests = {
            n: self.backend.circuit_digest(n) for n in self.circuit_names
        }
        self.circuit_set = CircuitSet([self.digests[n] for n in self.circuit_names])

    @property
    def set_digest(self) -> HashOut:
        return self.circuit_set.digest

    def generate_proof(
        self,
        circuit_name: str,
        child_proofs: Sequence[ProofWithVK],
        public_inputs: Sequence[int],
    ) -> ProofWithVK:
        assert circuit_name in self.digests, f"circuit {circuit_name} not in set"
        for p in child_proofs:
            assert tuple(p.circuit_digest) in [
                tuple(d) for d in self.circuit_set.digests
            ], "child proof's circuit is not a set member"
        payload = self.backend.prove(circuit_name, public_inputs, child_proofs)
        return ProofWithVK(
            circuit_digest=self.digests[circuit_name],
            public_inputs=[int(x) for x in public_inputs],
            payload=payload,
        )

    def verify_proof(
        self, proof: ProofWithVK, child_proofs: Sequence[ProofWithVK] = ()
    ) -> bool:
        # membership of the claimed circuit in the set
        try:
            idx = self.circuit_set.index_of(proof.circuit_digest)
        except ValueError:
            return False
        path = self.circuit_set.membership_path(proof.circuit_digest)
        if not CircuitSet.verify_membership(
            self.set_digest, proof.circuit_digest, idx, path
        ):
            return False
        name = next(
            n for n, d in self.digests.items() if tuple(d) == tuple(proof.circuit_digest)
        )
        return self.backend.verify(name, proof, child_proofs)
