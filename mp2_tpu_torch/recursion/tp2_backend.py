"""TP2Backend: real plonk proofs for the verifiable-DB tree circuits.

Port of `mp2_tpu/recursion/tp2_backend.py`: the circuit builders that the
map phase proves and the `TP2Backend` class, which takes the device it
compiles and proves on (`device="cuda"` unless the caller asks for the
CPU).  Parent/child linkage (parent's child-hash PIs == children's hash
PIs) is enforced by `verify`, host-side.  Each circuit proves the Poseidon2
node hash of one tree node in-circuit, with the node's fields exposed as
public inputs:
  cells_node:  PIs = h(4) || id || value(8) || lh(4) || rh(4)
               h == H(lh || rh || id || value)
  tree_node:   PIs = h(4) || id || value(8) || min(8) || max(8)
                     || lh(4) || rh(4) || inner(4)
               h == H(lh || rh || min || max || id || value || inner)
               (shared by rows-tree and block-tree nodes)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mp2_tpu_torch.circuit.builder import CircuitBuilder
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.prover.config import CircuitConfig, test_config
from mp2_tpu_torch.prover.prove import prove
from mp2_tpu_torch.prover.serde import proof_from_dict, proof_to_dict
from mp2_tpu_torch.prover.verify import verify as tp2_verify

HashOut = Tuple[int, int, int, int]

# pipeline circuit name -> registered circuit shape
SHAPE_OF = {
    "cells_leaf": "cells_node",
    "cells_full": "cells_node",
    "cells_partial": "cells_node",
    "rows_leaf": "tree_node",
    "rows_full": "tree_node",
    "rows_partial": "tree_node",
    "block_leaf": "tree_node",
    "block_parent": "tree_node",
    "block_membership": "tree_node",
}

# PI layout offsets for linkage checks: (lh_offset, rh_offset)
_CHILD_OFFSETS = {"cells_node": (13, 17), "tree_node": (29, 33)}


def _build_cells_node(cfg: CircuitConfig, device):
    b = CircuitBuilder(cfg)
    lh = b.add_inputs(4)
    rh = b.add_inputs(4)
    ident = b.add_input()
    value = b.add_inputs(8)
    h = b.hash_no_pad(lh + rh + [ident] + value)
    b.register_public_inputs(h + [ident] + value + lh + rh)
    inputs = lh + rh + [ident] + value
    return b.build(device), inputs


def _build_tree_node(cfg: CircuitConfig, device):
    b = CircuitBuilder(cfg)
    lh = b.add_inputs(4)
    rh = b.add_inputs(4)
    mn = b.add_inputs(8)
    mx = b.add_inputs(8)
    ident = b.add_input()
    value = b.add_inputs(8)
    inner = b.add_inputs(4)
    h = b.hash_no_pad(lh + rh + mn + mx + [ident] + value + inner)
    b.register_public_inputs(h + [ident] + value + mn + mx + lh + rh + inner)
    inputs = lh + rh + mn + mx + [ident] + value + inner
    return b.build(device), inputs


_BUILDERS = {"cells_node": _build_cells_node, "tree_node": _build_tree_node}


class TP2Backend:
    """Real-proof backend for the recursion framework."""

    name = "tp2"

    def __init__(self, config: Optional[CircuitConfig] = None, device="cuda"):
        self.config = config or test_config()
        self.device = torch.device(device)
        self._circuits: Dict[str, tuple] = {}

    def _circuit(self, shape: str):
        if shape not in self._circuits:
            data, inputs = _BUILDERS[shape](self.config, self.device)
            self._circuits[shape] = (data, inputs)
        return self._circuits[shape]

    def _shape(self, circuit_name: str) -> str:
        return SHAPE_OF.get(circuit_name, circuit_name)

    def circuit_digest(self, circuit_name: str) -> HashOut:
        shape = self._shape(circuit_name)
        if shape not in _BUILDERS:
            # circuits not yet expressed in TP2 fall back to attestations
            return p2h.hash_no_pad([ord(c) for c in f"dummy/{circuit_name}"])
        data, _ = self._circuit(shape)
        # bind the circuit name so e.g. rows/block leaves get distinct ids
        return p2h.hash_no_pad(
            list(data.circuit_digest) + [ord(c) for c in circuit_name]
        )

    def prove(
        self,
        circuit_name: str,
        public_inputs: Sequence[int],
        child_proofs: Sequence,
    ) -> Dict:
        shape = self._shape(circuit_name)
        if shape not in _BUILDERS:
            att = p2h.hash_no_pad(
                list(self.circuit_digest(circuit_name))
                + [int(x) for x in public_inputs]
                + [x for p in child_proofs for x in p.public_inputs]
            )
            return {"kind": "dummy", "attestation": list(att),
                    "children": [list(p.circuit_digest) for p in child_proofs]}
        data, input_targets = self._circuit(shape)
        # PI layout: hash(4) || witness fields...; the witness is the tail
        field_values = [int(x) for x in public_inputs[4:]]
        # input order differs from PI order; map back:
        w = data.generate_witness(
            dict(zip(input_targets, _pi_tail_to_inputs(shape, field_values)))
        )
        proof = prove(data, w, [int(x) for x in public_inputs])
        return {"kind": "tp2", "proof": proof_to_dict(proof)}

    def verify(
        self,
        circuit_name: str,
        proof,
        child_proofs: Sequence = (),
    ) -> bool:
        shape = self._shape(circuit_name)
        if shape not in _BUILDERS:
            att = p2h.hash_no_pad(
                list(self.circuit_digest(circuit_name))
                + [int(x) for x in proof.public_inputs]
                + [x for p in child_proofs for x in p.public_inputs]
            )
            return list(att) == proof.payload.get("attestation")
        data, _ = self._circuit(shape)
        p = proof_from_dict(proof.payload["proof"])
        if p.public_inputs != proof.public_inputs:
            return False
        if not tp2_verify(data, p):
            return False
        # host-side child linkage (stand-in for the universal verifier):
        # EVERY declared non-empty child must be backed by a child proof, in
        # (left, right) positional order — a prover can neither omit a child
        # nor swap positions
        lh_off, rh_off = _CHILD_OFFSETS[shape]
        declared = [
            tuple(proof.public_inputs[lh_off : lh_off + 4]),
            tuple(proof.public_inputs[rh_off : rh_off + 4]),
        ]
        empty = tuple(p2h.empty_poseidon_hash())
        expected = [d for d in declared if d != empty]
        child_hashes = [tuple(c.public_inputs[0:4]) for c in child_proofs]
        return child_hashes == expected


def _pi_tail_to_inputs(shape: str, tail: List[int]) -> List[int]:
    """Reorder PI tail (id||value||...||lh||rh[||inner]) into the builder's
    input order (lh||rh||[min||max||]id||value[||inner])."""
    if shape == "cells_node":
        ident, value, lh, rh = tail[0], tail[1:9], tail[9:13], tail[13:17]
        return list(lh) + list(rh) + [ident] + list(value)
    ident = tail[0]
    value = tail[1:9]
    mn = tail[9:17]
    mx = tail[17:25]
    lh = tail[25:29]
    rh = tail[29:33]
    inner = tail[33:37]
    return list(lh) + list(rh) + list(mn) + list(mx) + [ident] + list(value) + list(inner)


def tree_node_batch(data, input_targets, batch: int,
                    seed: int = 0) -> Tuple[np.ndarray, List[List[int]]]:
    """`batch` random tree-node witnesses and their public inputs, made
    exactly as the reference's bench makes them (numpy default_rng(seed),
    37 node fields below 2^31 per proof).  Returns ((B, n, W) uint64,
    B public-input lists)."""
    rng = np.random.default_rng(seed)
    wits, pis_list = [], []
    for _ in range(batch):
        vals = [int(v) for v in rng.integers(0, 2**31, 37)]
        h = p2h.hash_no_pad(vals)
        lh, rh = vals[0:4], vals[4:8]
        mn, mx = vals[8:16], vals[16:24]
        ident, value, inner = vals[24], vals[25:33], vals[33:37]
        pis_list.append(list(h) + [ident] + value + mn + mx + lh + rh + inner)
        wits.append(data.generate_witness(dict(zip(input_targets, vals))))
    return np.stack(wits), pis_list
