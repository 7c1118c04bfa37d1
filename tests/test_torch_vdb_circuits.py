"""The port's verifiable-DB circuits and scheduler against mp2_tpu on the CPU.

Each member circuit of the cells and rows sets (`cells_leaf`, `cells_full`,
`cells_partial`, `rows_leaf`, `rows_full`, `rows_partial`) is built in both
packages with stub children, as tests/test_vdb_circuits.py:31-49 builds
them: the child proofs' public inputs arrive as plain witness inputs.  The
port's witness for the host model's node must equal the reference's and
pass `check_witness` against the host model's public inputs.

The cells circuits (128 and 256 rows) are compiled in full in both
packages and their `circuit_digest` values compared.  The rows circuits
have 2^13 rows: their fixed commitment (a 2^16-point LDE of ~170 columns,
then a Merkle tree) takes minutes with the port's plain torch NTT and
Poseidon2 on a CPU, so here both packages compile them without it and the
inputs of the commitment are compared instead: n, the gate types in order,
the selector, constant and sigma columns and the public-input targets.
The circuit digest is a hash of the commitment of exactly these columns;
the commitment itself is compared on the cells circuits here and, for the
real members of both sets (verifiers included), by their digests against
the JAX package's on the card (chip_smoke.py, testdata/vdb_golden.json).

The port's MapReduceScheduler drains a rows-tree update plan on a stub
batch prover exactly as the reference's does.
"""

import functools
import inspect
import json
import os

import numpy as np
import pytest

from mp2_tpu.circuit.builder import CircuitBuilder as JCircuitBuilder
from mp2_tpu.parallel import scheduler as jscheduler
from mp2_tpu.prover import prove as jprove
from mp2_tpu.prover.config import test_config as jtest_config
from mp2_tpu.vdb import circuits as JC
from mp2_tpu.vdb import trees as JT
from mp2_tpu_torch.circuit.builder import CircuitBuilder
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.parallel import scheduler
from mp2_tpu_torch.prover import prove
from mp2_tpu_torch.prover.config import test_config
from mp2_tpu_torch.vdb import circuits as C
from mp2_tpu_torch.vdb import trees as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "vdb_golden.json")
PKGS = {
    "port": (CircuitBuilder, test_config, C, T, lambda b: b.build("cpu")),
    "ref": (JCircuitBuilder, jtest_config, JC, JT, lambda b: b.build()),
}


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


def _cells_pis(pkg_c, node):
    return pkg_c.cells_pi_values(node.hash, node.split, node.individual_cnt,
                                 node.multiplier_cnt)


def _cells_case(kind, c, t):
    """(assign args, child PI lists, node PIs) of a cells node of `kind`."""
    cells = {"cells_leaf": [t.Cell(42, 123456789)],
             "cells_partial": [t.Cell(1, 100), t.Cell(2, 200, True)],
             "cells_full": [t.Cell(1, 100), t.Cell(2, 200, True), t.Cell(3, 1 << 200)]}[kind]
    res = t.build_cells_tree(cells)
    root = res.tree.root_inner()
    kids = [k for k in res.tree.children_inner(root) if k is not None]
    node = res.nodes[root]
    return (node.cell,), [_cells_pis(c, res.nodes[k]) for k in kids], _cells_pis(c, node)


def _row_table(t):
    """Four rows (secondary values 50, 20, 80, 10) with two cells each,
    inserted in one transaction: the scapegoat tree then has a full node
    (50), a partial one (20) and leaves (10, 80)."""
    db = t.new_row_tree()

    def tx(x):
        for v in (50, 20, 80, 10):
            cells = t.build_cells_tree([t.Cell(3, v * 7), t.Cell(4, v * 11)])
            x.store((v, 0), t.RowPayload(secondary=t.Cell(5, v),
                                         row_unique_data=(v, 8, 7, 6), cells=cells))

    db.in_transaction(tx)
    return db


def _rows_case(kind, c, t):
    """(assign args, child PI lists + the foreign cells PIs, node PIs) of
    a rows node of `kind` in the table above."""
    db = _row_table(t)
    want = {"rows_leaf": 0, "rows_partial": 1, "rows_full": 2}[kind]
    key = next(k for k in sorted(db.payloads)
               if sum(ch is not None for ch in db.tree.children(k)) == want)
    l, r = db.tree.children(key)
    payload = db.payload(key)
    args = (payload.secondary, payload.row_unique_data)
    if kind == "rows_partial":
        args += (l is not None,)
    kids = [db.payload(k) for k in (l, r) if k is not None]
    cells = payload.cells
    foreign = c.cells_pi_values(cells.root_hash, cells.split, cells.individual_cnt,
                                cells.multiplier_cnt)
    return args, [c.rows_pi_values(p) for p in kids] + [foreign], c.rows_pi_values(payload)


@functools.lru_cache(maxsize=None)
def _build(name, pkg):
    """Build `name` with stub children in one package; (data, witness, PIs).
    Cached: the rows circuits are only built without the fixed commitment."""
    builder_cls, cfg, c, t, build = PKGS[pkg]
    b = builder_cls(cfg())
    fn = getattr(c, f"_build_{name}")
    if name.startswith("cells"):
        args, child_pis, pis = _cells_case(name, c, t)
        stubs = [_StubChild(b, c.NUM_USER_PIS) for _ in child_pis]
        assign = fn(b, stubs) if stubs else fn(b)
    else:
        args, child_pis, pis = _rows_case(name, c, t)
        stubs = [_StubChild(b, c.NUM_USER_PIS) for _ in child_pis]
        assign = fn(b, stubs[:-1], stubs[-1:])
    inputs = {}
    assign(inputs, *args)
    for stub, vals in zip(stubs, child_pis):
        stub.assign(inputs, vals)
    data = build(b)
    return data, data.generate_witness(inputs), pis


@pytest.mark.parametrize("name", ["cells_leaf", "cells_partial", "cells_full"])
def test_cells_circuit_matches_reference(name):
    data, w, pis = _build(name, "port")
    jdata, jw, jpis = _build(name, "ref")
    assert pis == jpis
    assert data.n == jdata.n
    assert data.circuit_digest == jdata.circuit_digest
    np.testing.assert_array_equal(w, jw)
    data.check_witness(w, pis)


@pytest.fixture
def without_fixed_commitment(monkeypatch):
    """Compile without the fixed columns' LDE and Merkle commitment."""
    monkeypatch.setattr(prove.CircuitData, "_build_fixed", lambda self: None)
    monkeypatch.setattr(jprove.CircuitData, "_build_fixed", lambda self: None)


@pytest.mark.parametrize("name", ["rows_leaf", "rows_partial", "rows_full"])
def test_rows_circuit_matches_reference(name, without_fixed_commitment):
    data, w, pis = _build(name, "port")
    jdata, jw, jpis = _build(name, "ref")
    assert pis == jpis
    assert data.n == jdata.n == 8192
    assert [n for n, _ in data.gate_types] == [n for n, _ in jdata.gate_types]
    for col in ("selector_values", "constants_values", "sigma_values"):
        np.testing.assert_array_equal(getattr(data, col), getattr(jdata, col))
    assert data.public_inputs == jdata.public_inputs
    np.testing.assert_array_equal(w, jw)
    data.check_witness(w, pis)


def test_rows_circuit_rejects_another_digest(without_fixed_commitment):
    """A rows_full node cannot claim another individual digest than the one
    it accumulates in-circuit from its own cells and its children."""
    data, w, pis = _build("rows_full", "port")
    bad = list(pis)
    bad[4] = (bad[4] + 1) % P
    with pytest.raises((AssertionError, ValueError)):
        data.check_witness(w, bad)


def _stub_prover(log):
    def prove_batch(name, items):
        log.append((name, [key for key, _ in items]))
        return [(name, key, inputs) for key, inputs in items]

    return prove_batch


@pytest.mark.parametrize("count", [1, 5, 8])
def test_scheduler_matches_reference(count):
    """The rows tree's update plan after `count` inserts, drained by both
    schedulers with a stub batch prover: the same batches in the same
    order, the same proofs and the same stats."""
    db, jdb = _row_table(T), _row_table(JT)
    extra = [(v, 0) for v in range(100, 100 + count)]
    plans = []
    for t, d in ((T, db), (JT, jdb)):
        payload = d.payload((50, 0))
        plans.append(d.in_transaction(lambda x: [x.store(k, payload) for k in extra]))

    def classify(db_):
        def kind(key):
            kids = sum(c is not None for c in db_.tree.children(key))
            return ("rows_leaf", "rows_partial", "rows_full")[kids], key

        return kind

    log, jlog = [], []
    proofs, stats = scheduler.MapReduceScheduler(_stub_prover(log)).run(
        plans[0].into_workplan(), classify(db))
    jproofs, jstats = jscheduler.MapReduceScheduler(_stub_prover(jlog)).run(
        plans[1].into_workplan(), classify(jdb))
    assert log == jlog
    assert proofs == jproofs
    assert vars(stats) == vars(jstats)
    assert stats.items == len(plans[0])


def test_golden_record_has_what_the_card_reads():
    """vdb_golden.json (tools/make_vdb_golden.py) holds every key that
    chip_smoke.py's vdb phase reads, for both configurations and the chain."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    for part in ("light", "production"):
        for set_name, members in (("cells", ("cells_leaf", "cells_full", "cells_partial")),
                                  ("rows", ("rows_leaf", "rows_full", "rows_partial"))):
            rec = golden[part][set_name]
            assert len(rec["set_digest"]) == 4 and rec["standard_n"] >= 8192
            assert sorted(rec["member_digests"]) == sorted(members)
            assert sorted(rec["wrap_chain_n"]) == sorted(members)
    chain = golden["chain"]
    assert chain["members"] == ["cells_leaf", "cells_partial", "rows_leaf"]
    assert len(chain["proof_sha256"]) == 3
    assert len(chain["rows_leaf_public_inputs"]) == C.NUM_USER_PIS
    for key in ("cells", "secondary", "row_unique_data", "row_key"):
        assert key in chain


def test_golden_chain_inputs_give_the_recorded_public_inputs():
    """The port's host model gives the rows leaf the public inputs the JAX
    package proved (so the card's chain proves the same statement)."""
    with open(GOLDEN) as f:
        chain = json.load(f)["chain"]
    cells = T.build_cells_tree([T.Cell(i, v) for i, v in chain["cells"]])
    db = T.new_row_tree()
    key = tuple(chain["row_key"])
    db.in_transaction(lambda x: x.store(key, T.RowPayload(
        secondary=T.Cell(*chain["secondary"]),
        row_unique_data=tuple(chain["row_unique_data"]), cells=cells)))
    assert C.rows_pi_values(db.payload(key)) == chain["rows_leaf_public_inputs"]


def test_entry_points_run_on_the_card_by_default():
    assert inspect.signature(C.VerifiableDbCircuits.__init__).parameters["device"].default \
        == "cuda"
