"""The port's block-tree and IVC circuits against mp2_tpu on the CPU.

Each member circuit of the block and IVC sets (`block_leaf`,
`block_parent`, `ivc_first`, `ivc_subsequent`) is built in both packages
with stub children, as tests/test_vdb_circuits.py:129-150 builds them: the
child proofs' public inputs arrive as plain witness inputs.  The inputs are
a three-block append (block numbers 1, 2, 3, each over its own rows tree,
values from a numpy seed): the block tree's shapes are a leaf (block 1), a
parent with a left child only (block 2 over 1, `has_r` = 0) and one with
both (block 2 over 1 and 3, `has_r` = 1); the IVC steps follow the root
after blocks 1 and 2.  The port's witness for each node must equal the
reference's and pass `check_witness` against the host model's public
inputs; the tolerance is 0.

The block circuits have 2^15 rows: as for the rows circuits
(tests/test_torch_vdb_circuits.py), both packages compile them without the
fixed commitment and the inputs of the commitment are compared.  The IVC
circuits are small and compiled in full; their circuit digests are
compared.  The card holds the committed members of both sets, verifiers
included, against the JAX package's digests (chip_smoke.py,
testdata/vdb_golden.json).
"""

import functools
import json
import os

import numpy as np
import pytest

from mp2_tpu.circuit.builder import CircuitBuilder as JCircuitBuilder
from mp2_tpu.hash import poseidon2_host as jp2h
from mp2_tpu.prover import prove as jprove
from mp2_tpu.prover.config import test_config as jtest_config
from mp2_tpu.vdb import circuits as JC
from mp2_tpu.vdb import digests as JD
from mp2_tpu.vdb import trees as JT
from mp2_tpu_torch.circuit.builder import CircuitBuilder
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.prover import prove
from mp2_tpu_torch.prover.config import test_config
from mp2_tpu_torch.utils import collector_paused
from mp2_tpu_torch.vdb import circuits as C
from mp2_tpu_torch.vdb import digests as D
from mp2_tpu_torch.vdb import trees as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "vdb_golden.json")
PKGS = {
    "port": (CircuitBuilder, test_config, C, T, D, p2h, lambda b: b.build("cpu")),
    "ref": (JCircuitBuilder, jtest_config, JC, JT, JD, jp2h, lambda b: b.build()),
}
INDEX_ID = 77
MULTIPLIER = (9, 350)  # one multiplier cell in every row
METADATA_INPUTS = (1, 2, 3)


class _StubChild:
    """Stands in for a UniversalVerifierTargets: PI values arrive as plain
    witness inputs instead of a verified child proof."""

    def __init__(self, b, width):
        self.targets = b.add_inputs(width)

    def public_inputs(self):
        return list(self.targets)

    def assign(self, inputs, values):
        for t, v in zip(self.targets, values):
            inputs[t] = int(v)


def _rows_root(t, block):
    """The root payload of a two-row table for `block`: secondary values
    and cell values from numpy, seeded by the block number."""
    rng = np.random.default_rng(block)
    db = t.new_row_tree()

    def tx(x):
        for _ in range(2):
            sec, val = (int(v) for v in rng.integers(1, 1 << 62, size=2))
            cells = t.build_cells_tree([t.Cell(3, val), t.Cell(*MULTIPLIER, True)])
            x.store((sec, 0), t.RowPayload(
                secondary=t.Cell(5, sec),
                row_unique_data=tuple(int(v) for v in rng.integers(0, P, size=4,
                                                                   dtype=np.uint64)),
                cells=cells))

    db.in_transaction(tx)
    return db.payload(db.root())


def _block_payload(t, d, rows, block):
    return t.BlockPayload(
        index_id=INDEX_ID, block_number=block, rows_hash=rows.hash,
        rows_digest=d.compute_final_digest(False, rows.individual_vd,
                                           rows.multiplier_vd, rows.multiplier_cnt))


@functools.lru_cache(maxsize=None)
def _append(pkg):
    """The three-block append in one package's host model: for each step,
    the stored block's rows PIs and the block tree's node PIs after it."""
    _, _, c, t, d, h, _ = PKGS[pkg]
    db = t.new_block_tree()
    md = h.hash_no_pad(list(METADATA_INPUTS))
    steps = []
    for block in (1, 2, 3):
        rows = _rows_root(t, block)
        db.in_transaction(lambda x: x.store(block, _block_payload(t, d, rows, block)))
        steps.append({
            "rows_pis": c.rows_pi_values(rows),
            "nodes": {k: c.block_pi_values(db.payload(k)) for k in db.payloads},
            "root": db.root(),
            "ivc": c.ivc_pi_values(db.payload(db.root()).hash, md, block),
            "children": {k: db.tree.children(k) for k in db.payloads},
        })
    return md, steps


def _case(kind, pkg):
    """(member, assign args, child PI lists + the foreign PIs, node PIs)."""
    md, steps = _append(pkg)
    if kind == "block_leaf":
        s = steps[0]
        return "block_leaf", (INDEX_ID, 1, False), [s["rows_pis"]], s["nodes"][1]
    if kind.startswith("block_parent"):
        has_r = kind.endswith("has_r1")
        s = steps[2 if has_r else 1]
        l, r = s["children"][2]
        assert l == 1 and (r == 3) == has_r
        kids = [s["nodes"][l], s["nodes"][r if has_r else l]]
        return ("block_parent", (INDEX_ID, 2, has_r, False),
                kids + [steps[1]["rows_pis"]], s["nodes"][2])
    if kind == "ivc_first":
        s = steps[0]
        return "ivc_first", (md, 1), [s["nodes"][s["root"]]], s["ivc"]
    assert kind == "ivc_subsequent"
    s = steps[1]
    return "ivc_subsequent", (2,), [steps[0]["ivc"], s["nodes"][s["root"]]], s["ivc"]


@functools.lru_cache(maxsize=None)
def _circuit(member, pkg):
    """`member` built with stub children in one package: (data, assign,
    stubs).  Cached: the block circuits are built without the fixed
    commitment (the fixture below), the IVC circuits in full."""
    builder_cls, cfg, c, _, _, _, build = PKGS[pkg]
    b = builder_cls(cfg())
    n_children = {"block_leaf": 0, "block_parent": 2, "ivc_first": 0,
                  "ivc_subsequent": 1}[member]
    with collector_paused():
        stubs = [_StubChild(b, c.NUM_USER_PIS) for _ in range(n_children + 1)]
        assign = getattr(c, f"_build_{member}")(b, stubs[:-1], stubs[-1:])
        return build(b), assign, stubs


@functools.lru_cache(maxsize=None)
def _witness(kind, pkg):
    member, args, child_pis, pis = _case(kind, pkg)
    data, assign, stubs = _circuit(member, pkg)
    inputs = {}
    assign(inputs, *args)
    for stub, vals in zip(stubs, child_pis):
        stub.assign(inputs, vals)
    with collector_paused():
        return data, data.generate_witness(inputs), pis


@pytest.fixture
def without_fixed_commitment(monkeypatch):
    """Compile without the fixed columns' LDE and Merkle commitment."""
    monkeypatch.setattr(prove.CircuitData, "_build_fixed", lambda self: None)
    monkeypatch.setattr(jprove.CircuitData, "_build_fixed", lambda self: None)


def test_append_host_models_agree():
    """Both host models give the same PIs at every step of the append, and
    the block tree has the sbbst shapes the cases below need."""
    assert _append("port") == _append("ref")
    _, steps = _append("port")
    assert [s["root"] for s in steps] == [1, 2, 2]
    assert steps[1]["children"][2] == (1, None)
    assert steps[2]["children"][2] == (1, 3)


@pytest.mark.parametrize("kind", ["block_leaf", "block_parent_has_r0",
                                  "block_parent_has_r1"])
def test_block_circuit_matches_reference(kind, without_fixed_commitment):
    data, w, pis = _witness(kind, "port")
    jdata, jw, jpis = _witness(kind, "ref")
    assert pis == jpis
    assert data.n == jdata.n == 1 << 15
    assert [n for n, _ in data.gate_types] == [n for n, _ in jdata.gate_types]
    for col in ("selector_values", "constants_values", "sigma_values"):
        np.testing.assert_array_equal(getattr(data, col), getattr(jdata, col))
    assert data.public_inputs == jdata.public_inputs
    np.testing.assert_array_equal(w, jw)
    data.check_witness(w, pis)


@pytest.mark.parametrize("kind", ["ivc_first", "ivc_subsequent"])
def test_ivc_circuit_matches_reference(kind):
    data, w, pis = _witness(kind, "port")
    jdata, jw, jpis = _witness(kind, "ref")
    assert pis == jpis
    assert data.n == jdata.n
    assert data.circuit_digest == jdata.circuit_digest
    np.testing.assert_array_equal(w, jw)
    data.check_witness(w, pis)


def test_block_leaf_rejects_another_rows_digest(without_fixed_commitment):
    """A block leaf cannot claim a digest built on another rows digest than
    the one its rows proof carries (here: block 2's rows under block 1)."""
    data, w, _ = _witness("block_leaf", "port")
    rows = _rows_root(T, 2)
    db = T.new_block_tree()
    db.in_transaction(lambda x: x.store(1, T.BlockPayload(
        index_id=INDEX_ID, block_number=1, rows_hash=_rows_root(T, 1).hash,
        rows_digest=D.compute_final_digest(False, rows.individual_vd,
                                           rows.multiplier_vd, rows.multiplier_cnt))))
    bad = C.block_pi_values(db.payload(1))
    with pytest.raises((AssertionError, ValueError)):
        data.check_witness(w, bad)


def test_ivc_subsequent_rejects_another_metadata_hash():
    """The metadata hash carries over from the previous IVC proof: a step
    that claims another one is rejected."""
    data, w, pis = _witness("ivc_subsequent", "port")
    bad = list(pis)
    bad[4:8] = p2h.hash_no_pad([4, 5, 6])
    with pytest.raises((AssertionError, ValueError)):
        data.check_witness(w, bad)


def test_extraction_bound_members_are_not_left_out_silently(monkeypatch):
    """VerifiableDbCircuits(config, extraction=fx) declares both bound
    members, each after its unbound twin (member order decides the set
    digest) and each verifying the rows set and fx's set; without
    extraction the block set has the two unbound members only (the
    declarations are recorded; no circuit is built)."""
    declared = []

    class Recording:
        def __init__(self, *args, **kw):
            self.members = []
            declared.append(self.members)

        def add_leaf_circuit(self, name, fn, foreign=()):
            self.members.append((name, fn, 0, list(foreign)))

        def add_aggregation_circuit(self, name, n, fn, foreign=()):
            self.members.append((name, fn, n, list(foreign)))

        def finalize(self):
            pass

    monkeypatch.setattr(C, "RecursionFramework", Recording)
    fx = type("Fx", (), {"fw": object()})()
    sets = C.VerifiableDbCircuits(test_config(), extraction=fx, device="cpu")
    block = declared[2]
    assert [(name, fn, n) for name, fn, n, _ in block] == [
        ("block_leaf", C._build_block_leaf, 0),
        ("block_leaf_bound", C._build_block_leaf_bound, 0),
        ("block_parent", C._build_block_parent, 2),
        ("block_parent_bound", C._build_block_parent_bound, 2)]
    for _, _, _, foreign in block[1::2]:
        assert foreign[0] is sets.rows and foreign[1] is fx.fw
    C.VerifiableDbCircuits(test_config(), device="cpu")
    assert [name for name, *_ in declared[-2]] == ["block_leaf", "block_parent"]


def test_golden_record_has_the_block_and_ivc_sets():
    """vdb_golden.json (tools/make_vdb_golden.py) holds the block and IVC
    sets at both configurations, as chip_smoke.py's vdb phases read them."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    for part in ("light", "production"):
        for set_name, members in (("block", ("block_leaf", "block_parent")),
                                  ("ivc", ("ivc_first", "ivc_subsequent"))):
            rec = golden[part][set_name]
            assert len(rec["set_digest"]) == 4 and rec["standard_n"] >= 8192
            assert sorted(rec["member_digests"]) == sorted(members)
            assert sorted(rec["wrap_chain_n"]) == sorted(members)
    chain = golden["chain"]
    assert chain["block_ivc_members"] == ["block_leaf", "ivc_first"]
    assert len(chain["block_ivc_proof_sha256"]) == 2


def test_golden_chain_block_and_ivc_public_inputs_are_the_host_models():
    """The port's host model gives block_leaf and ivc_first the public
    inputs the JAX package proved over the golden rows leaf."""
    with open(GOLDEN) as f:
        chain = json.load(f)["chain"]
    cells = T.build_cells_tree([T.Cell(i, v) for i, v in chain["cells"]])
    rows_db = T.new_row_tree()
    key = tuple(chain["row_key"])
    rows_db.in_transaction(lambda x: x.store(key, T.RowPayload(
        secondary=T.Cell(*chain["secondary"]),
        row_unique_data=tuple(chain["row_unique_data"]), cells=cells)))
    rows = rows_db.payload(key)
    number = chain["block_number"]
    block_db = T.new_block_tree()
    block_db.in_transaction(lambda x: x.store(number, T.BlockPayload(
        index_id=chain["block_index_id"], block_number=number, rows_hash=rows.hash,
        rows_digest=D.compute_final_digest(False, rows.individual_vd,
                                           rows.multiplier_vd, rows.multiplier_cnt))))
    block = block_db.payload(number)
    assert C.block_pi_values(block) == chain["block_leaf_public_inputs"]
    md = p2h.hash_no_pad(chain["ivc_metadata_inputs"])
    assert C.ivc_pi_values(block.hash, md, number) == chain["ivc_first_public_inputs"]
