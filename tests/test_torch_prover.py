"""The port's prover against mp2_tpu on the CPU: NTT/LDE, Merkle caps,
circuit digests (the port's own compile and convert.py), and whole batched
tree-node proofs, which must be bit-identical to the reference's, accepted
by both verifiers and equal to the committed golden digests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mp2_tpu.field import goldilocks as jgl
from mp2_tpu.prover import fri as jfri
from mp2_tpu.prover import ntt as jntt
from mp2_tpu.prover.batch import BatchedMerkleTree as JBatchedMerkleTree
from mp2_tpu.prover.batch import permutation_count as jpermutation_count
from mp2_tpu.prover.batch import prove_batch as jprove_batch
from mp2_tpu.prover.config import test_config as jtest_config
from mp2_tpu.prover.merkle import MerkleTree as JMerkleTree
from mp2_tpu.prover.serde import proof_to_dict as jproof_to_dict
from mp2_tpu.prover.verify import verify as jverify
from mp2_tpu.recursion.tp2_backend import _build_cells_node as jbuild_cells_node
from mp2_tpu.recursion.tp2_backend import _build_tree_node as jbuild_tree_node
from mp2_tpu_torch import convert
from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.prover import algebra, batch, fri, ntt
from mp2_tpu_torch.prover.batch import permutation_count, prove_batch
from mp2_tpu_torch.prover.config import test_config
from mp2_tpu_torch.prover.merkle import BatchedMerkleTree, MerkleTree, verify_merkle_proof
from mp2_tpu_torch.prover.prove import SHIFT
from mp2_tpu_torch.prover.serde import proof_from_dict, proof_sha256, proof_to_dict
from mp2_tpu_torch.prover.verify import verify
from mp2_tpu_torch.recursion.tp2_backend import (
    _build_cells_node,
    _build_tree_node,
    tree_node_batch,
)

P = gl.P
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "tree_node_golden.json")


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("log_n", range(1, 11))
def test_ntt_matches_reference(log_n):
    x = _rand(log_n, (3, 1 << log_n))
    x[0, :4] = [0, P - 1, 1 << 32, (1 << 32) - 1][: 1 << log_n]
    t = gl.from_u64(x, "cpu")
    for ours, ref in ((ntt.ntt, jntt.ntt), (ntt.intt, jntt.intt),
                      (ntt.coset_ntt, jntt.coset_ntt), (ntt.coset_intt, jntt.coset_intt)):
        np.testing.assert_array_equal(
            gl.to_u64(ours(t)), jgl.to_u64(ref(jgl.from_u64(x))))
    np.testing.assert_array_equal(
        gl.to_u64(ntt.lde(t, 3)), jgl.to_u64(jntt.lde(jgl.from_u64(x), 3)))
    if log_n >= 2:  # the four-step path (from 2^15 in ntt()) at small sizes
        for inverse in (False, True):
            np.testing.assert_array_equal(
                gl.to_u64(ntt._ntt_four_step(t, inverse)),
                gl.to_u64(ntt._ntt_small(t, inverse)))


@pytest.mark.parametrize("log_n", [1, 2, 5, 9, 13])
def test_fold_inverses_match_reference(log_n):
    """FRI's fold table inv(2 x_i), made from one table of powers, against
    the reference's inversion per point, at the LDE shift and the shifts
    of the next two folds."""
    shift = SHIFT
    for _ in range(3):
        np.testing.assert_array_equal(fri._fold_inv_2x(log_n, shift),
                                      jfri._fold_inv_2x(log_n, shift))
        shift = shift * shift % P


def test_merkle_caps_match_reference():
    leaves = _rand(11, (32, 9))
    for cap_h in (0, 2):
        ours = MerkleTree(gl.from_u64(leaves, "cpu"), cap_height=cap_h)
        ref = JMerkleTree(jgl.from_u64(leaves), cap_height=cap_h)
        for a, b in zip(ours.digest_levels, ref.digest_levels, strict=True):
            np.testing.assert_array_equal(gl.to_u64(a), jgl.to_u64(b))
        cap = [tuple(int(v) for v in r) for r in gl.to_u64(ours.cap)]
        idx = 13
        sibs = [gl.to_u64(lvl)[(idx >> k) ^ 1] for k, lvl in enumerate(ours.digest_levels[:-1])]
        assert verify_merkle_proof(leaves[idx], idx, sibs, cap, depth=5 - cap_h)
        assert not verify_merkle_proof(leaves[idx], idx ^ 2, sibs, cap, depth=5 - cap_h)
    batched = _rand(12, (3, 16, 4))  # <= 4 wide: no-op leaves
    ours = BatchedMerkleTree(gl.from_u64(batched, "cpu"), cap_height=1)
    ref = JBatchedMerkleTree(jgl.from_u64(batched), cap_height=1)
    np.testing.assert_array_equal(gl.to_u64(ours.cap), jgl.to_u64(ref.cap))


def _numpy_circuit(jdata):
    """The reference CircuitData in the numpy form convert.py takes."""
    return dict(
        config=jdata.config,
        n=jdata.n,
        gate_types=jdata.gate_types,
        selector_values=jdata.selector_values,
        constants_values=jdata.constants_values,
        sigma_values=jdata.sigma_values,
        k_coeffs=jdata.k_coeffs,
        fixed_coeffs=jgl.to_u64(jdata.fixed_coeffs),
        fixed_lde=jgl.to_u64(jdata.fixed_lde),
        fixed_levels=[jgl.to_u64(l) for l in jdata.fixed_tree.digest_levels],
        rows_meta=jdata.rows_meta,
        dsu_parent=jdata.dsu_parent,
        generators=jdata.generators,
        public_inputs=jdata.public_inputs,
    )


@pytest.fixture(scope="module")
def tree_node():
    """Both packages' tree-node circuit at test_config, the golden batch,
    and both packages' proofs of it (the reference prove is the slow part
    of this file: ~45 s cold)."""
    jdata, jinputs = jbuild_tree_node(jtest_config())
    data, inputs = _build_tree_node(test_config(), "cpu")
    with open(GOLDEN) as f:
        golden = json.load(f)
    wits, pis = tree_node_batch(data, inputs, golden["batch"], golden["seed"])
    return {
        "jdata": jdata, "jinputs": jinputs, "data": data, "golden": golden,
        "wits": wits, "pis": pis,
        "jproofs": jprove_batch(jdata, wits, pis),
        "proofs": prove_batch(data, wits, pis),
    }


def test_circuit_digest_own_compile_and_convert(tree_node):
    jdata, data = tree_node["jdata"], tree_node["data"]
    assert data.circuit_digest == jdata.circuit_digest
    assert list(data.circuit_digest) == tree_node["golden"]["circuit_digest"]
    np.testing.assert_array_equal(data.sigma_values, jdata.sigma_values)
    np.testing.assert_array_equal(gl.to_u64(data.fixed_lde), jgl.to_u64(jdata.fixed_lde))
    conv = convert.circuit_data_from_numpy(**_numpy_circuit(jdata), device="cpu")
    assert conv.circuit_digest == jdata.circuit_digest
    assert [n for n, _ in conv.gate_types] == [n for n, _ in jdata.gate_types]
    assert permutation_count(data) == jpermutation_count(jdata)


def test_cells_node_digest_own_compile_and_convert():
    jdata, _ = jbuild_cells_node(jtest_config())
    data, _ = _build_cells_node(test_config(), "cpu")
    assert data.circuit_digest == jdata.circuit_digest
    conv = convert.circuit_data_from_numpy(**_numpy_circuit(jdata), device="cpu")
    assert conv.circuit_digest == jdata.circuit_digest


def test_witnesses_match_reference(tree_node):
    rng = np.random.default_rng(tree_node["golden"]["seed"])
    vals = [int(v) for v in rng.integers(0, 2**31, 37)]
    ref = tree_node["jdata"].generate_witness(dict(zip(tree_node["jinputs"], vals)))
    np.testing.assert_array_equal(tree_node["wits"][0], ref)


def test_prove_batch_bit_identical_to_reference(tree_node):
    dicts = [proof_to_dict(p) for p in tree_node["proofs"]]
    jdicts = [jproof_to_dict(p) for p in tree_node["jproofs"]]
    assert dicts == jdicts
    golden = tree_node["golden"]["proof_sha256"]
    assert [proof_sha256(d) for d in jdicts] == golden  # the golden file has not drifted
    assert [proof_sha256(d) for d in dicts] == golden


def test_port_proofs_verify_in_both_packages(tree_node):
    for p in tree_node["proofs"]:
        assert jverify(tree_node["jdata"], p)
        assert verify(tree_node["data"], p)
        assert verify(tree_node["data"], proof_from_dict(json.loads(json.dumps(proof_to_dict(p)))))
    bad = proof_from_dict(proof_to_dict(tree_node["proofs"][0]))
    bad.openings.wires[0] = ((bad.openings.wires[0][0] + 1) % P, bad.openings.wires[0][1])
    assert not verify(tree_node["data"], bad)


def test_convert_proves_identically(tree_node):
    conv = convert.circuit_data_from_numpy(
        **_numpy_circuit(tree_node["jdata"]), device="cpu")
    proofs = prove_batch(conv, tree_node["wits"][:1], tree_node["pis"][:1])
    assert proof_sha256(proof_to_dict(proofs[0])) == tree_node["golden"]["proof_sha256"][0]


def test_prove_batch_in_small_chunks_is_bit_identical(tree_node, monkeypatch):
    """prove_batch's memory bounds move no bit: with the quotient in chunks
    of 32 coset points, its terms weighted a group at a time, the weighted
    sums and permutation products in slices of 256 elements and every
    constant-matrix product one row at a time, the proofs equal the golden
    ones (the sizes the card runs fit one chunk here)."""
    monkeypatch.setattr(batch, "_QUOTIENT_ELEMS", 64)
    monkeypatch.setattr(batch, "_SUM_ELEMS", 256)
    monkeypatch.setattr(algebra, "_PRODUCT_ELEMS", 256)
    proofs = prove_batch(tree_node["data"], tree_node["wits"], tree_node["pis"])
    assert [proof_sha256(proof_to_dict(p)) for p in proofs] == \
        tree_node["golden"]["proof_sha256"]


def test_prove_batch_rejects_public_inputs_of_another_length(tree_node):
    """One circuit fixes the number of public inputs: a list of any other
    length is refused before anything is proved."""
    wits, pis = tree_node["wits"], tree_node["pis"]
    with pytest.raises(ValueError, match="public inputs"):
        prove_batch(tree_node["data"], wits, [pis[0], pis[1][:-1]])
    with pytest.raises(ValueError, match="public inputs"):
        prove_batch(tree_node["data"], wits, [p + [0] for p in pis])


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) leaves jax out
    of sys.modules; the walk reaches the recursion, vdb, extraction and query
    slices' modules, the work queue and the API."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mp2_tpu_torch\n"
        "for m in pkgutil.walk_packages(mp2_tpu_torch.__path__, 'mp2_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'mp2_tpu.')))\n"
        "assert not bad, bad\n"
        "want = ['ops.ntt_cuda', 'ops._nvcc', 'circuit.gadgets.ext2',\n"
        "        'circuit.gadgets.transcript', 'recursion.verifier_gadget',\n"
        "        'recursion.framework', 'recursion.wrap', 'recursion.runtime',\n"
        "        'utils.trace', 'ops.ntt_t_cuda', 'utils.u256', 'field.gfp5',\n"
        "        'field.sswu', 'field.ecgfp5', 'circuit.gadgets.gfp5',\n"
        "        'circuit.gadgets.curve', 'circuit.gadgets.u256',\n"
        "        'ryhope.updatetree', 'ryhope.scapegoat', 'ryhope.sbbst',\n"
        "        'ryhope.kvdb', 'vdb.digests', 'vdb.trees', 'vdb.circuits',\n"
        "        'parallel.scheduler', 'prover.params', 'utils.keccak',\n"
        "        'utils.rlp', 'utils.trie', 'circuit.gadgets.keccak',\n"
        "        'circuit.gadgets.bytes', 'extraction.storage_key',\n"
        "        'extraction.columns', 'extraction.values',\n"
        "        'extraction.column_gadget', 'extraction.mpt_circuits',\n"
        "        'extraction.api', 'extraction.circuits', 'extraction.final_circuits',\n"
        "        'extraction.metadata', 'parsil.errors', 'parsil.ast', 'parsil.symbols',\n"
        "        'parsil.expand', 'parsil.assembler', 'parsil.validate', 'parsil.isolator',\n"
        "        'vdb.query.ops', 'vdb.query.api', 'vdb.query.universal',\n"
        "        'vdb.query.merkle_path', 'vdb.query.chunks', 'vdb.query.planner',\n"
        "        'circuit.public_inputs', 'models.pipeline', 'models.circuit_pipeline',\n"
        "        'parallel.workqueue', 'api']\n"
        "missing = [m for m in want if 'mp2_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_refuses_without_cuda():
    """No card here: chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available; the refusal needs none")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""
