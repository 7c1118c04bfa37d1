"""Circuit parameter persistence.

Reference parity: all circuit parameters serialize deterministically to disk
and reload without rebuilding (mp2-common serialization/, deterministic-
params test at mp2-v1/src/api.rs:618-636).  Two artifacts:

  * VerifierData — everything needed to verify proofs of a circuit
    (config, gate registry, sigma ids, fixed Merkle cap, circuit digest);
    compact, json-serializable.
  * save/load of the full CircuitData fixed columns (numpy npz) so provers
    skip the fixed-polynomial rebuild; witness generators are host closures
    and are reconstructed by re-running the circuit-definition code, whose
    determinism is what the round-trip test pins down.

A jax-free copy of `mp2_tpu/prover/params.py`: only the imports change.
Both packages write the same bytes for the same circuit, and either reads
what the other wrote.  The fixed data a prover needs (coefficients, LDE,
Merkle levels) is cached apart from these files, by `CircuitData` under
MP2_FIXED_CACHE (prover/prove.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from mp2_tpu_torch.circuit import gates as G
from mp2_tpu_torch.prover.config import CircuitConfig
from mp2_tpu_torch.prover.fri import FriConfig

_GATE_REGISTRY = {
    "NoopGate": lambda kw: G.NoopGate(),
    "ArithmeticGate": lambda kw: G.ArithmeticGate(kw["num_ops"]),
    "ConstantGate": lambda kw: G.ConstantGate(kw["num_ops"]),
    "PublicInputGate": lambda kw: G.PublicInputGate(),
    "Poseidon2FullRoundGate": lambda kw: G.Poseidon2FullRoundGate(kw["first"]),
    "Poseidon2PartialRoundGate": lambda kw: G.Poseidon2PartialRoundGate(),
    "Poseidon2Gate": lambda kw: G.Poseidon2Gate(),
    "BitDecomposeGate": lambda kw: G.BitDecomposeGate(kw["num_ops"], kw["bits"]),
    "IsZeroGate": lambda kw: G.IsZeroGate(kw["num_ops"]),
}


def _gate_spec(gate) -> Tuple[str, Dict]:
    cls = type(gate).__name__
    kw = {}
    if hasattr(gate, "num_ops"):
        kw["num_ops"] = gate.num_ops
    if hasattr(gate, "first"):
        kw["first"] = gate.first
    if hasattr(gate, "bits"):
        kw["bits"] = gate.bits
    return cls, kw


@dataclass
class VerifierData:
    """Duck-type compatible with prover.verify's uses of CircuitData."""

    config: CircuitConfig
    n: int
    log_n: int
    gate_types: List  # [(name, gate_instance)]
    k_coeffs: List[int]
    circuit_digest: Tuple[int, int, int, int]
    fixed_cap_host: List[Tuple[int, int, int, int]]

    @property
    def num_gate_types(self):
        return len(self.gate_types)


def verifier_data(data) -> VerifierData:
    return VerifierData(
        config=data.config,
        n=data.n,
        log_n=data.log_n,
        gate_types=list(data.gate_types),
        k_coeffs=list(data.k_coeffs),
        circuit_digest=tuple(data.circuit_digest),
        fixed_cap_host=list(data.fixed_cap_host),
    )


def _config_to_dict(cfg: CircuitConfig) -> Dict:
    return {
        "num_wires": cfg.num_wires,
        "num_constants": cfg.num_constants,
        "num_challenges": cfg.num_challenges,
        "quotient_degree_factor": cfg.quotient_degree_factor,
        "permutation_chunk_size": cfg.permutation_chunk_size,
        "fri": {
            "rate_bits": cfg.fri.rate_bits,
            "cap_height": cfg.fri.cap_height,
            "proof_of_work_bits": cfg.fri.proof_of_work_bits,
            "num_query_rounds": cfg.fri.num_query_rounds,
        },
        "fri_final_poly_bits": cfg.fri_final_poly_bits,
    }


def _config_from_dict(d: Dict) -> CircuitConfig:
    return CircuitConfig(
        num_wires=d["num_wires"],
        num_constants=d["num_constants"],
        num_challenges=d["num_challenges"],
        quotient_degree_factor=d["quotient_degree_factor"],
        permutation_chunk_size=d["permutation_chunk_size"],
        fri=FriConfig(**d["fri"]),
        fri_final_poly_bits=d["fri_final_poly_bits"],
    )


def verifier_data_to_bytes(vd: VerifierData) -> bytes:
    return json.dumps(
        {
            "config": _config_to_dict(vd.config),
            "n": vd.n,
            "gate_types": [
                {"name": name, "cls": _gate_spec(g)[0], "kw": _gate_spec(g)[1]}
                for name, g in vd.gate_types
            ],
            "k_coeffs": vd.k_coeffs,
            "circuit_digest": list(vd.circuit_digest),
            "fixed_cap": [list(c) for c in vd.fixed_cap_host],
        },
        sort_keys=True,
    ).encode()


def verifier_data_from_bytes(data: bytes) -> VerifierData:
    d = json.loads(data.decode())
    cfg = _config_from_dict(d["config"])
    gate_types = [
        (g["name"], _GATE_REGISTRY[g["cls"]](g["kw"])) for g in d["gate_types"]
    ]
    n = d["n"]
    return VerifierData(
        config=cfg,
        n=n,
        log_n=n.bit_length() - 1,
        gate_types=gate_types,
        k_coeffs=[int(k) for k in d["k_coeffs"]],
        circuit_digest=tuple(d["circuit_digest"]),
        fixed_cap_host=[tuple(int(x) for x in c) for c in d["fixed_cap"]],
    )


def save_fixed_columns(data, path: str):
    """Persist the fixed polynomial column values (npz) + verifier data."""
    np.savez_compressed(
        path,
        selectors=data.selector_values,
        constants=data.constants_values,
        sigmas=data.sigma_values,
        verifier=np.frombuffer(
            verifier_data_to_bytes(verifier_data(data)), dtype=np.uint8
        ),
    )


def load_verifier_data(path: str) -> VerifierData:
    with np.load(path) as z:
        return verifier_data_from_bytes(z["verifier"].tobytes())
