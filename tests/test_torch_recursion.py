"""The port's recursion path against mp2_tpu on the CPU.

Whole recursive proofs from the JAX package take minutes on a CPU, so the
proofs are held against `mp2_tpu_torch/testdata/recursion_golden.json`
(written by tools/make_recursion_golden.py from the JAX package), and the
packages are compared directly where that is cheap: the verifier-gadget
outer circuit of the fast-tier shape (tests/test_recursion.py:114-149),
its witness, the in-circuit checks, circuit-set membership and the
backends' digests.  Everything is compared exactly.  The wrap chain and the
batched framework run on the card (chip_smoke.py).
"""

import copy
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest

from mp2_tpu.circuit.builder import CircuitBuilder as JCircuitBuilder
from mp2_tpu.field import goldilocks as jgl
from mp2_tpu.prover.config import test_config as jtest_config
from mp2_tpu.prover.fri import FriConfig as JFriConfig
from mp2_tpu.prover.serde import proof_from_dict as jproof_from_dict
from mp2_tpu.recursion import framework as jframework
from mp2_tpu.recursion import verifier_gadget as jvg
from mp2_tpu.recursion.tp2_backend import TP2Backend as JTP2Backend
from mp2_tpu.recursion.wrap import check_membership_circuit as jcheck_membership_circuit
from mp2_tpu_torch import convert
from mp2_tpu_torch.circuit.builder import CircuitBuilder
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.prover.config import test_config
from mp2_tpu_torch.prover.fri import FriConfig
from mp2_tpu_torch.prover.prove import prove
from mp2_tpu_torch.prover.serde import proof_from_dict, proof_sha256, proof_to_dict
from mp2_tpu_torch.prover.verify import verify
from mp2_tpu_torch.recursion import framework
from mp2_tpu_torch.recursion import verifier_gadget as vg
from mp2_tpu_torch.recursion.runtime import RecursionFramework
from mp2_tpu_torch.recursion.tp2_backend import TP2Backend
from mp2_tpu_torch.recursion.wrap import check_membership_circuit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "recursion_golden.json")


def _fast_tier_config(make_config, fri_config):
    return make_config(fri=fri_config(rate_bits=3, cap_height=1,
                                      proof_of_work_bits=2, num_query_rounds=2))


def _inner(builder_cls, cfg, build):
    """The fast-tier inner circuit: PIs = H(x0, x1) || x0 || x1."""
    b = builder_cls(cfg)
    xs = b.add_inputs(2)
    b.register_public_inputs(b.hash_no_pad(xs) + xs)
    return build(b), xs


def _outer(builder_cls, gadget, inner_data, build):
    """The verifier-gadget outer circuit for proofs of `inner_data`."""
    common = gadget.CommonData.of(inner_data)
    b = builder_cls(inner_data.config)
    pt = gadget.add_virtual_proof(b, common)
    cap = [[b.constant(int(v)) for v in row] for row in inner_data.fixed_cap_host]
    gadget.verify_proof_circuit(b, common, pt, cap)
    b.register_public_inputs(pt.public_inputs)
    return build(b), pt


def _plain_key(key):
    """A shape key with its dataclasses as dicts, comparable across packages."""
    return tuple(dataclasses.asdict(k) if dataclasses.is_dataclass(k) else k for k in key)


def _witness(outer_data, pt, gadget, proof, public_inputs=None):
    inputs = {}
    gadget.set_proof_witness(inputs, pt, proof)
    for t, v in zip(pt.public_inputs, public_inputs or []):
        inputs[t] = v
    return outer_data.generate_witness(inputs)


@pytest.fixture(scope="module")
def fast():
    """Both packages' fast-tier inner and outer circuits; the inner proof is
    the JAX package's, from the golden file."""
    with open(GOLDEN) as f:
        golden = json.load(f)["fast_tier"]
    cfg = _fast_tier_config(test_config, FriConfig)
    jcfg = _fast_tier_config(jtest_config, JFriConfig)
    inner, xs = _inner(CircuitBuilder, cfg, lambda b: b.build("cpu"))
    jinner, _ = _inner(JCircuitBuilder, jcfg, lambda b: b.build())
    outer, pt = _outer(CircuitBuilder, vg, inner, lambda b: b.build("cpu"))
    jouter, jpt = _outer(JCircuitBuilder, jvg, jinner, lambda b: b.build())
    return {
        "golden": golden, "inner": inner, "xs": xs, "jinner": jinner,
        "outer": outer, "pt": pt, "jouter": jouter, "jpt": jpt,
        "proof": proof_from_dict(golden["inner_proof"]),
        "jproof": jproof_from_dict(golden["inner_proof"]),
    }


def test_serial_prove_matches_golden_inner_proof(fast):
    """prove() of the 8-row inner circuit == the JAX package's serial proof."""
    g, inner = fast["golden"], fast["inner"]
    assert inner.n == g["inner_n"]
    assert list(inner.circuit_digest) == g["inner_circuit_digest"]
    w = inner.generate_witness(dict(zip(fast["xs"], g["inputs"])))
    proof = prove(inner, w, g["public_inputs"])
    assert json.loads(json.dumps(proof_to_dict(proof))) == g["inner_proof"]
    assert proof_sha256(proof_to_dict(proof)) == g["inner_proof_sha256"]
    assert verify(inner, proof)


def test_outer_circuit_matches_reference(fast):
    outer, jouter = fast["outer"], fast["jouter"]
    assert outer.n == jouter.n == fast["golden"]["outer_n"] == 2048
    assert outer.circuit_digest == jouter.circuit_digest
    assert list(outer.circuit_digest) == fast["golden"]["outer_circuit_digest"]
    assert [n for n, _ in outer.gate_types] == [n for n, _ in jouter.gate_types]
    for a, b in ((fast["inner"], fast["jinner"]), (outer, jouter)):
        assert _plain_key(vg.CommonData.of(a).shape_key()) == \
            _plain_key(jvg.CommonData.of(b).shape_key())


def test_outer_witness_matches_reference(fast):
    w = _witness(fast["outer"], fast["pt"], vg, fast["proof"])
    jw = _witness(fast["jouter"], fast["jpt"], jvg, fast["jproof"])
    np.testing.assert_array_equal(w, jw)


def test_check_witness_accepts_valid_proof(fast):
    w = _witness(fast["outer"], fast["pt"], vg, fast["proof"])
    fast["outer"].check_witness(w, fast["golden"]["public_inputs"])


def test_check_witness_rejects_tampered_opening(fast):
    bad = copy.deepcopy(fast["proof"])
    a, b_ = bad.openings.wires[0]
    bad.openings.wires[0] = ((a + 1) % P, b_)
    with pytest.raises((ValueError, AssertionError)):
        w = _witness(fast["outer"], fast["pt"], vg, bad)
        fast["outer"].check_witness(w, fast["golden"]["public_inputs"])


def test_check_witness_rejects_wrong_public_inputs(fast):
    bad_pis = list(fast["golden"]["public_inputs"])
    bad_pis[4] = 99  # claim a different preimage
    with pytest.raises((ValueError, AssertionError)):
        w = _witness(fast["outer"], fast["pt"], vg, fast["proof"], bad_pis)
        fast["outer"].check_witness(w, bad_pis)


def test_check_witness_rejects_shortened_fri(fast):
    bad = copy.deepcopy(fast["proof"])
    for qr in bad.fri.query_rounds:
        qr.steps = []
    with pytest.raises((AssertionError, IndexError, ValueError)):
        w = _witness(fast["outer"], fast["pt"], vg, bad)
        fast["outer"].check_witness(w, fast["golden"]["public_inputs"])


def _numpy_circuit(jdata):
    """The reference CircuitData in the numpy form convert.py takes."""
    return dict(
        config=jdata.config, n=jdata.n, gate_types=jdata.gate_types,
        selector_values=jdata.selector_values,
        constants_values=jdata.constants_values,
        sigma_values=jdata.sigma_values, k_coeffs=jdata.k_coeffs,
        fixed_coeffs=jgl.to_u64(jdata.fixed_coeffs),
        fixed_lde=jgl.to_u64(jdata.fixed_lde),
        fixed_levels=[jgl.to_u64(l) for l in jdata.fixed_tree.digest_levels],
        rows_meta=jdata.rows_meta, dsu_parent=jdata.dsu_parent,
        generators=jdata.generators, public_inputs=jdata.public_inputs,
    )


def test_converted_outer_circuit_proves_like_the_reference(fast):
    """convert.py carries the reference's compiled verifier circuit (the
    shape of a wrap circuit: other gate types than a leaf, 2048 rows), and
    the port proves from it the proof the JAX package made."""
    conv = convert.circuit_data_from_numpy(**_numpy_circuit(fast["jouter"]), device="cpu")
    assert conv.circuit_digest == fast["jouter"].circuit_digest
    w = _witness(conv, fast["jpt"], jvg, fast["jproof"])
    proof = prove(conv, w, fast["golden"]["public_inputs"])
    assert proof_sha256(proof_to_dict(proof)) == fast["golden"]["outer_proof_sha256"]
    assert verify(fast["outer"], proof)


DIGESTS = [tuple(int(v) for v in row) for row in
           np.random.default_rng(5).integers(0, P, size=(4, 4), dtype=np.uint64)]


def test_circuit_set_matches_reference():
    ours, ref = framework.CircuitSet(DIGESTS), jframework.CircuitSet(DIGESTS)
    assert ours.digest == ref.digest
    for i, d in enumerate(DIGESTS):
        path = ours.membership_path(d)
        assert path == ref.membership_path(d)
        assert framework.CircuitSet.verify_membership(ours.digest, d, i, path)
        assert not framework.CircuitSet.verify_membership(ours.digest, d, i ^ 1, path)
    three = framework.CircuitSet(DIGESTS[:3])  # padded with its last digest
    assert three.digest == jframework.CircuitSet(DIGESTS[:3]).digest


def _membership(builder_cls, check, cfg, build):
    b = builder_cls(cfg)
    digest = b.add_inputs(4)
    bits = b.add_inputs(2)
    sibs = [b.add_inputs(4) for _ in range(2)]
    set_digest = b.add_inputs(4)
    check(b, digest, bits, sibs, set_digest)
    b.register_public_inputs(set_digest)
    return build(b), (digest, bits, sibs, set_digest)


@pytest.fixture(scope="module")
def membership():
    ours = _membership(CircuitBuilder, check_membership_circuit, test_config(),
                       lambda b: b.build("cpu"))
    ref = _membership(JCircuitBuilder, jcheck_membership_circuit, jtest_config(),
                      lambda b: b.build())
    return ours, ref


def _membership_inputs(targets, index, path, set_digest, member):
    digest, bits, sibs, sd = targets
    vals = list(member) + [(index >> k) & 1 for k in range(2)]
    vals += [v for row in path for v in row] + list(set_digest)
    return dict(zip(digest + bits + [t for row in sibs for t in row] + sd, vals))


@pytest.mark.parametrize("index", range(4))
def test_membership_circuit_matches_reference(membership, index):
    (data, targets), (jdata, jtargets) = membership
    assert data.circuit_digest == jdata.circuit_digest
    cs = framework.CircuitSet(DIGESTS)
    path = cs.membership_path(DIGESTS[index])
    args = (index, path, cs.digest, DIGESTS[index])
    w = data.generate_witness(_membership_inputs(targets, *args))
    np.testing.assert_array_equal(w, jdata.generate_witness(_membership_inputs(jtargets, *args)))
    data.check_witness(w, list(cs.digest))
    wrong = ((index ^ 1), path, cs.digest, DIGESTS[index])  # the sibling's slot
    with pytest.raises((ValueError, AssertionError)):
        bad = data.generate_witness(_membership_inputs(targets, *wrong))
        data.check_witness(bad, list(cs.digest))


@pytest.mark.parametrize("name", ["leaf", "node", "rows_leaf"])
def test_dummy_backend_matches_reference(name):
    ours, ref = framework.DummyBackend(), jframework.DummyBackend()
    assert ours.circuit_digest(name) == ref.circuit_digest(name)
    child = framework.ProofWithVK(ours.circuit_digest("leaf"), [1, 2], {})
    payload = ours.prove(name, [3, 4], [child])
    jchild = jframework.ProofWithVK(ref.circuit_digest("leaf"), [1, 2], {})
    assert payload == ref.prove(name, [3, 4], [jchild])
    rc = framework.RecursiveCircuits(["leaf", "node", "rows_leaf"])
    env = rc.generate_proof(name, [child], [3, 4])
    assert rc.verify_proof(env, [child])
    assert framework.ProofWithVK.deserialize(env.serialize()) == env
    assert rc.set_digest == jframework.RecursiveCircuits(["leaf", "node", "rows_leaf"]).set_digest


@pytest.mark.parametrize("name", ["rows_leaf", "cells_leaf", "revelation"])
def test_tp2_backend_digests_match_reference(name):
    """TP2Backend binds the circuit name into each shape's circuit digest;
    names without a TP2 circuit fall back to attestation digests."""
    ours = TP2Backend(test_config(), device="cpu")
    assert ours.circuit_digest(name) == JTP2Backend(jtest_config()).circuit_digest(name)


def test_entry_points_run_on_the_card_by_default():
    for fn in (RecursionFramework.__init__, TP2Backend.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
