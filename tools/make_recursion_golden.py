"""Write mp2_tpu_torch/testdata/recursion_golden.json from the JAX package.

The PyTorch port's recursion path is held against `mp2_tpu`.  Whole
recursive proofs from the JAX package take minutes on a CPU, so the tests
and `chip_smoke.py` compare the port with digests that this script records
once, on the CPU:

  fast_tier   the 8-row inner proof of the fast-tier recursion shape
              (test_config with 2 query rounds, tests/test_recursion.py:
              114-149) as `proof_to_dict`, its sha256, and the circuit
              digest and n of the verifier-gadget outer circuit built
              against it and the sha256 of its proof;
  light       RecursionFramework(test_config(), num_user_pis=4,
              set_height=2) with the `leaf`/`node` members of
              tests/test_recursion.py:341-360: the set digest (the fixed
              verification key), the standard n, each member's digest and
              wrap chain, the inputs of 2 leaves (`prove_leaves_batch`) and
              1 aggregation (`prove_aggregations_batch`), and the sha256 of
              each envelope's proof;
  production  the same framework at CircuitConfig(): set digest, standard
              n, member digests and wrap chains (no proving).

Usage (from the repo root; the light and production parts take tens of
minutes on a CPU):

    JAX_PLATFORMS=cpu python tools/make_recursion_golden.py [PART ...]

With no PART all three are computed; a named part replaces only its own
entry in the existing file.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "recursion_golden.json")
LEAF_VALUES = (11, 22)


def fast_tier_config():
    from mp2_tpu.prover.config import test_config
    from mp2_tpu.prover.fri import FriConfig

    return test_config(fri=FriConfig(rate_bits=3, cap_height=1,
                                     proof_of_work_bits=2, num_query_rounds=2))


def leaf_build(b):
    """The framework's leaf member: PIs = H(x)."""
    x = b.add_input()
    b.register_public_inputs(b.hash_no_pad([x]))

    def assign(inputs, xv):
        inputs[x] = xv

    return assign


def agg_build(b, children):
    """The framework's 2-child aggregation member: PIs = H(h_left || h_right)."""
    left = children[0].public_inputs()[:4]
    right = children[1].public_inputs()[:4]
    b.register_public_inputs(b.hash_no_pad(left + right))
    return None


def _framework(cfg):
    from mp2_tpu.recursion.runtime import RecursionFramework

    fw = RecursionFramework(cfg, num_user_pis=4, set_height=2)
    fw.add_leaf_circuit("leaf", leaf_build)
    fw.add_aggregation_circuit("node", 2, agg_build)
    fw.finalize()
    return fw


def _framework_record(fw):
    return {
        "set_digest": [int(v) for v in fw.set_digest],
        "standard_n": fw.standard.n,
        "member_digests": {name: [int(v) for v in fw.members[name].digest]
                           for name in fw.member_order},
        "wrap_chain_n": {name: [fw.members[name].data.n]
                         + [wc.data.n for wc in fw._wrap_chain_for(fw.members[name].data)]
                         for name in fw.member_order},
    }


def fast_tier():
    from mp2_tpu.circuit.builder import CircuitBuilder
    from mp2_tpu.hash import poseidon2_host as p2h
    from mp2_tpu.prover.prove import prove
    from mp2_tpu.prover.serde import proof_to_dict
    from mp2_tpu.prover.verify import verify
    from mp2_tpu.recursion.verifier_gadget import (
        CommonData,
        add_virtual_proof,
        set_proof_witness,
        verify_proof_circuit,
    )
    from mp2_tpu_torch.prover.serde import proof_sha256

    cfg = fast_tier_config()
    b = CircuitBuilder(cfg)
    xs = b.add_inputs(2)
    b.register_public_inputs(b.hash_no_pad(xs) + xs)
    data = b.build()
    vals = [5, 7]
    pis = list(p2h.hash_no_pad(vals)) + vals
    proof = prove(data, data.generate_witness(dict(zip(xs, vals))), pis)
    assert verify(data, proof)
    b2 = CircuitBuilder(cfg)
    pt = add_virtual_proof(b2, CommonData.of(data))
    cap = [[b2.constant(int(v)) for v in row] for row in data.fixed_cap_host]
    verify_proof_circuit(b2, CommonData.of(data), pt, cap)
    b2.register_public_inputs(pt.public_inputs)
    outer = b2.build()
    inputs = {}
    set_proof_witness(inputs, pt, proof)
    outer_proof = prove(outer, outer.generate_witness(inputs), pis)
    assert verify(outer, outer_proof)
    d = proof_to_dict(proof)
    return {
        "inputs": vals,
        "public_inputs": pis,
        "inner_n": data.n,
        "inner_circuit_digest": [int(v) for v in data.circuit_digest],
        "inner_proof": d,
        "inner_proof_sha256": proof_sha256(d),
        "outer_n": outer.n,
        "outer_circuit_digest": [int(v) for v in outer.circuit_digest],
        "outer_proof_sha256": proof_sha256(proof_to_dict(outer_proof)),
    }


def light():
    from mp2_tpu.hash import poseidon2_host as p2h
    from mp2_tpu.prover.config import test_config
    from mp2_tpu.prover.serde import proof_to_dict
    from mp2_tpu_torch.prover.serde import proof_sha256

    fw = _framework(test_config())
    rec = _framework_record(fw)
    hs = [list(p2h.hash_no_pad([v])) for v in LEAF_VALUES]
    leaves = fw.prove_leaves_batch("leaf", [(v,) for v in LEAF_VALUES], hs)
    agg_pis = list(p2h.hash_no_pad(hs[0] + hs[1]))
    (agg,) = fw.prove_aggregations_batch("node", [leaves], [()], [agg_pis])
    assert all(fw.verify(e) for e in leaves + [agg])
    rec.update({
        "leaf_values": list(LEAF_VALUES),
        "leaf_public_inputs": hs,
        "aggregation_public_inputs": agg_pis,
        "leaf_proof_sha256": [proof_sha256(proof_to_dict(e.proof)) for e in leaves],
        "aggregation_proof_sha256": proof_sha256(proof_to_dict(agg.proof)),
    })
    return rec


def production():
    from mp2_tpu.prover.config import CircuitConfig

    return _framework_record(_framework(CircuitConfig()))


PARTS = {"fast_tier": fast_tier, "light": light, "production": production}


def main(names):
    for name in names or list(PARTS):
        t0 = time.perf_counter()
        part = PARTS[name]()
        print(f"{name}: {time.perf_counter() - t0:.1f} s on the CPU", flush=True)
        rec = {}
        if os.path.exists(GOLDEN):  # re-read: other parts may run beside this one
            with open(GOLDEN) as f:
                rec = json.load(f)
        rec[name] = part
        with open(GOLDEN, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
