"""Proof (de)serialization: every stage input/output travels as bytes,
keeping the map phase stateless (reference: mp2-common/src/proof.rs +
serialization/, SURVEY.md §2.9).

A copy of `mp2_tpu/prover/serde.py`: `proof_to_dict` of a port proof and
of a reference proof are equal exactly when the proofs are."""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List

import numpy as np

from mp2_tpu_torch.prover import fri as fri_mod
from mp2_tpu_torch.prover.prove import Openings, Proof


def _arr(a) -> List[List[int]]:
    return [[int(x) for x in row] for row in np.asarray(a)]


def _unarr(d) -> np.ndarray:
    return np.array(d, dtype=np.uint64)


def proof_to_dict(p: Proof) -> Dict:
    return {
        "wires_cap": _arr(p.wires_cap),
        "zs_cap": _arr(p.zs_cap),
        "quotient_cap": _arr(p.quotient_cap),
        "openings": {
            "fixed": p.openings.fixed,
            "wires": p.openings.wires,
            "zs_partials": p.openings.zs_partials,
            "quotient": p.openings.quotient,
            "zs_next": p.openings.zs_next,
        },
        "fri": {
            "commit_caps": [_arr(c) for c in p.fri.commit_caps],
            "final_poly": [list(c) for c in p.fri.final_poly],
            "pow_witness": p.fri.pow_witness,
            "query_rounds": [
                {
                    "initial_leaves": [
                        [int(x) for x in l] for l in qr.initial_leaves
                    ],
                    "initial_siblings": [_arr(s) for s in qr.initial_siblings],
                    "steps": [
                        {
                            "pair": [list(s.pair[0]), list(s.pair[1])],
                            "siblings": _arr(s.siblings),
                        }
                        for s in qr.steps
                    ],
                }
                for qr in p.fri.query_rounds
            ],
        },
        "public_inputs": [int(x) for x in p.public_inputs],
    }


def proof_from_dict(d: Dict) -> Proof:
    def _pairs(v):
        return [tuple(int(x) for x in p) for p in v]

    openings = Openings(
        fixed=_pairs(d["openings"]["fixed"]),
        wires=_pairs(d["openings"]["wires"]),
        zs_partials=_pairs(d["openings"]["zs_partials"]),
        quotient=_pairs(d["openings"]["quotient"]),
        zs_next=_pairs(d["openings"]["zs_next"]),
    )
    fri = fri_mod.FriProof(
        commit_caps=[_unarr(c) for c in d["fri"]["commit_caps"]],
        final_poly=[tuple(int(x) for x in c) for c in d["fri"]["final_poly"]],
        pow_witness=int(d["fri"]["pow_witness"]),
        query_rounds=[
            fri_mod.FriQueryRound(
                initial_leaves=[_unarr1(l) for l in qr["initial_leaves"]],
                initial_siblings=[_unarr(s) for s in qr["initial_siblings"]],
                steps=[
                    fri_mod.FriQueryStep(
                        pair=(
                            tuple(int(x) for x in s["pair"][0]),
                            tuple(int(x) for x in s["pair"][1]),
                        ),
                        siblings=_unarr(s["siblings"]),
                    )
                    for s in qr["steps"]
                ],
            )
            for qr in d["fri"]["query_rounds"]
        ],
    )
    return Proof(
        wires_cap=_unarr(d["wires_cap"]),
        zs_cap=_unarr(d["zs_cap"]),
        quotient_cap=_unarr(d["quotient_cap"]),
        openings=openings,
        fri=fri,
        public_inputs=[int(x) for x in d["public_inputs"]],
    )


def _unarr1(v) -> np.ndarray:
    return np.array([int(x) for x in v], dtype=np.uint64)


def proof_sha256(d: Dict) -> str:
    """sha256 of a `proof_to_dict` result as canonical JSON (sorted keys, no
    spaces): equal digests mean equal proofs, whichever package made them."""
    blob = json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()
