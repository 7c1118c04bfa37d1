"""The port's query side against mp2_tpu on the CPU.

`parsil/`, `vdb/query/{ops,api,universal,merkle_path,chunks,planner}.py`
and the query half of `models/circuit_pipeline.CircuitTableIndexer` are
held against the reference:

  * parsil: `parse_and_assemble` over the SQL of tests/test_parsil_query.py
    and `parse_and_validate` and `isolate` over the corpus of
    tests/test_parsil_validate.py, in both packages: the CircuitPis equal
    field by field, the rejected queries refused with the same error class;
  * the host engine over numpy-seeded tables and trees: `execute_query`,
    `placeholder_hash`, `computational_hash`, the Merkle path witnesses
    (`host_path_from_tree`, `host_neighbor_path_from_tree`, their PI
    encodings, `make_row_binding` at an earlier epoch) and
    `find_node_for_non_existence`;
  * the seven query member bodies (`row`, `row_dummy`, `row_chunk`,
    `chunk_merge`, `non_existence`, `revelation`, `revelation_tabular`)
    built once per package without the fixed commitment, over stand-in
    child PIs (the recursion verifiers are the runtime's, held elsewhere):
    equal circuits, equal witnesses on the inputs the indexer hands them,
    and `check_witness` against the PIs it asks for;
    `UniversalQueryCircuit.expected_public_inputs` on seeded rows;
  * the slice: both packages' `CircuitTableIndexer.run_query` for the three
    queries of tests/test_circuit_pipeline.py, after block 101 alone and
    after blocks 100 -> 101, over the recording stand-ins of
    tests/test_torch_pipeline.py: the sequences of (set, member, inputs,
    user PIs), the results and the revealed values equal, and block 101's
    against testdata/pipeline_golden.json (tools/make_pipeline_golden.py).

The tolerance is 0 everywhere: every compared value is a canonical field
element, an integer or a string.  No test here proves a circuit outside
MP2_SLOW.
"""

import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest

import mp2_tpu.circuit.builder as jbuilder
import mp2_tpu.parsil.assembler as jassembler
import mp2_tpu.parsil.errors as jerrors
import mp2_tpu.parsil.isolator as jisolator
import mp2_tpu.parsil.symbols as jsymbols
import mp2_tpu.parsil.validate as jvalidate
import mp2_tpu.prover.config as jconfig
import mp2_tpu.prover.prove as jprove
import mp2_tpu.vdb.query.api as jqapi
import mp2_tpu.vdb.query.chunks as jchunks
import mp2_tpu.vdb.query.merkle_path as jmerkle_path
import mp2_tpu.vdb.query.ops as jops
import mp2_tpu.vdb.query.planner as jplanner
import mp2_tpu.vdb.query.universal as juniversal
import mp2_tpu.vdb.digests as jdigests
import mp2_tpu.vdb.trees as jtrees
import mp2_tpu_torch.circuit.builder as builder
import mp2_tpu_torch.models.circuit_pipeline as circuit_pipeline
import mp2_tpu_torch.parsil.assembler as assembler
import mp2_tpu_torch.parsil.errors as errors
import mp2_tpu_torch.parsil.isolator as isolator
import mp2_tpu_torch.parsil.symbols as symbols
import mp2_tpu_torch.parsil.validate as validate
import mp2_tpu_torch.prover.config as config
import mp2_tpu_torch.prover.prove as prove
import mp2_tpu_torch.vdb.query.api as qapi
import mp2_tpu_torch.vdb.query.chunks as chunks
import mp2_tpu_torch.vdb.query.merkle_path as merkle_path
import mp2_tpu_torch.vdb.query.ops as ops
import mp2_tpu_torch.vdb.query.planner as planner
import mp2_tpu_torch.vdb.query.universal as universal
import mp2_tpu_torch.vdb.digests as digests
import mp2_tpu_torch.vdb.trees as trees
import test_parsil_validate as jcorpus
import test_torch_pipeline as tp
from mp2_tpu_torch.utils import collector_paused

PKGS = {
    "port": SimpleNamespace(
        B=builder.CircuitBuilder, cfg=config.test_config, asm=assembler, E=errors,
        iso=isolator, sym=symbols, val=validate, api=qapi, qc=chunks, mp=merkle_path,
        ops=ops, plan=planner, uni=universal, trees=trees, D=digests,
        build=lambda b: b.build("cpu")),
    "ref": SimpleNamespace(
        B=jbuilder.CircuitBuilder, cfg=jconfig.test_config, asm=jassembler, E=jerrors,
        iso=jisolator, sym=jsymbols, val=jvalidate, api=jqapi, qc=jchunks, mp=jmerkle_path,
        ops=jops, plan=jplanner, uni=juniversal, trees=jtrees, D=jdigests,
        build=lambda b: b.build()),
}
_norm = tp._norm


def _both(fn):
    """fn(m) in each package, normalised for comparison."""
    return [_norm(fn(PKGS[pkg])) for pkg in ("port", "ref")]


def _outcome(m, fn):
    """fn()'s value, or the class name of the parsil error it raised."""
    try:
        return fn()
    except m.E.ValidationError as e:
        return ("raised", type(e).__name__)


# ---------------------------------------------------------------------------
# parsil
# ---------------------------------------------------------------------------


def _query_table(m):
    """tests/test_parsil_query.py's table."""
    return m.sym.ZkTable("t", [m.sym.ZkColumn("block", 1001, "primary_index"),
                               m.sym.ZkColumn("addr", 1002, "secondary_index"),
                               m.sym.ZkColumn("value", 1003), m.sym.ZkColumn("gas", 1004)])


RANGE = "block >= $MIN_BLOCK AND block <= $MAX_BLOCK"
ASSEMBLE = [  # the SQL of tests/test_parsil_query.py
    f"SELECT SUM(value), COUNT(*) FROM t WHERE {RANGE} AND value > 15;",
    "SELECT SUM(value), gas FROM t WHERE block = 5",
    f"SELECT SUM(value) FROM t WHERE {RANGE}",
    f"SELECT SUM(value), AVG(value), MIN(gas), MAX(value), COUNT(*) FROM t "
    f"WHERE {RANGE} AND addr = $1",
    f"SELECT DISTINCT addr FROM t WHERE {RANGE} LIMIT 2",
    f"SELECT COUNT(*) FROM t WHERE {RANGE} AND (value + gas > 40 OR addr = 1)",
    f"SELECT SUM(value * 2 + gas) FROM t WHERE {RANGE}",
    f"SELECT COUNT(*) FROM t WHERE {RANGE}",
    f"SELECT SUM(gas) FROM t WHERE {RANGE}",
    f"SELECT value FROM t WHERE {RANGE} ORDER BY value DESC LIMIT 3",
    f"SELECT value FROM t WHERE {RANGE} ORDER BY value",
]


@pytest.mark.parametrize("sql", ASSEMBLE, ids=range(len(ASSEMBLE)))
def test_parse_and_assemble_matches_reference(sql):
    port, ref = _both(lambda m: _outcome(
        m, lambda: m.asm.parse_and_assemble(sql, _query_table(m))))
    assert port == ref


def _settings(m, **kw):
    """tests/test_parsil_validate.py's settings, in package m."""
    Z, C = m.sym.ZkTable, m.sym.ZkColumn
    tables = {
        "table2": Z("table2", [C("block", 100, "primary_index"),
                               C("foo", 101, "secondary_index"), C("bar", 102)]),
        "t": Z("t", [C("block", 1, "primary_index"), C("x", 2, "secondary_index"),
                     C("a", 3), C("b", 4), C("c", 5)]),
    }
    bounds = dict(max_num_columns=10, max_num_predicate_ops=20, max_num_result_ops=20,
                  max_num_items_per_output=10, max_num_outputs=5)
    bounds.update(kw.pop("bounds", {}))
    return m.sym.ParsilSettings(context=m.sym.ContextProvider(tables, **bounds),
                                placeholders=m.sym.PlaceholderSettings(num_freestanding=3),
                                **kw)


VALIDATE = (list(jcorpus.MUST_ACCEPT) + [sql for sql, _ in jcorpus.MUST_REJECT]
            + list(jcorpus.ACCEPT_BOUNDS) + list(jcorpus.REJECT_BOUNDS))


@pytest.mark.parametrize("sql", VALIDATE, ids=range(len(VALIDATE)))
def test_parse_and_validate_matches_reference(sql):
    port, ref = _both(lambda m: _outcome(
        m, lambda: m.val.parse_and_validate(sql, _settings(m))))
    assert port == ref
    want = dict(jcorpus.MUST_REJECT).get(sql)
    if want is not None:
        assert port == _norm(("raised", want.__name__))


def test_parse_and_validate_with_limit_matches_reference():
    sql = f"SELECT foo FROM table2 WHERE {jcorpus.BOUNDED}"
    port, ref = _both(lambda m: m.val.parse_and_validate(sql, _settings(m, limit=3, offset=1)))
    assert port == ref


ISO_BASE = "SELECT * FROM table2 WHERE block BETWEEN $MIN_BLOCK AND $MAX_BLOCK"
ISOLATE = [(ISO_BASE, None, None), (ISO_BASE + " AND (3 = 4 OR bar = 5)", None, None),
           (ISO_BASE + " AND foo < 5", None, None), (ISO_BASE + " AND foo < 5", 45, None),
           (ISO_BASE + " AND foo < 5", None, 4), (ISO_BASE + " AND foo = 50", 45, 56),
           (ISO_BASE + " AND block = 50", None, None),
           (ISO_BASE + " AND (foo = 4 OR foo = 15) AND bar = 12", None, None)]


@pytest.mark.parametrize("sql,lo,hi", ISOLATE, ids=range(len(ISOLATE)))
def test_isolate_matches_reference(sql, lo, hi):
    port, ref = _both(lambda m: m.iso.isolate(
        sql, _settings(m, bounds={"max_num_outputs": 5}), lo, hi))
    assert port == ref


def test_context_provider_params_match_reference():
    port, ref = _both(lambda m: m.sym.ContextProvider(
        {}, max_num_columns=7, max_num_predicate_ops=9, max_num_result_ops=11,
        max_num_items_per_output=4, max_num_placeholders=6).universal_query_params())
    assert port == ref


# ---------------------------------------------------------------------------
# the host engine over numpy-seeded data
# ---------------------------------------------------------------------------


def _seeded_rows(seed):
    """(block, [block, addr, value, gas]) rows over blocks 100..104."""
    rng = np.random.default_rng(seed)
    out = []
    for block in range(100, 105):
        for _ in range(int(rng.integers(0, 5))):
            out.append((block, [block, int(rng.integers(1, 6)), int(rng.integers(0, 100)),
                                int(rng.integers(0, 20))]))
    return out


def _table_data(m, seed):
    td = m.api.TableData(_query_table(m))
    for block, row in _seeded_rows(seed):
        td.add_row(block, row)
    return td


EXECUTABLE = [s for s in ASSEMBLE if "gas FROM" not in s]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sql", EXECUTABLE, ids=range(len(EXECUTABLE)))
def test_execute_query_matches_reference(sql, seed):
    rng = np.random.default_rng(100 + seed)
    lo = int(rng.integers(98, 103))
    values = {"$MIN_BLOCK": lo, "$MAX_BLOCK": lo + int(rng.integers(0, 4)),
              "$1": int(rng.integers(1, 6))}
    port, ref = _both(lambda m: m.api.execute_query(
        m.asm.parse_and_assemble(sql, _query_table(m)), _table_data(m, seed),
        m.ops.Placeholders(dict(values))))
    assert port == ref


@pytest.mark.parametrize("seed", [0, 1])
def test_query_hashes_match_reference(seed):
    """placeholder_hash with and without the circuit's slot padding, and
    computational_hash at the schema's width and the circuit's."""
    rng = np.random.default_rng(seed)
    names = ["$1", "$2"][: int(rng.integers(0, 3))]
    values = {n: int(rng.integers(0, 1 << 62)) << int(rng.integers(0, 190)) for n in names}
    values.update({"$MIN_BLOCK": int(rng.integers(0, 1000)),
                   "$MAX_BLOCK": int(rng.integers(1000, 2000))})
    sql = ASSEMBLE[3]

    def hashes(m):
        pis = m.asm.parse_and_assemble(sql, _query_table(m))
        ph = m.ops.Placeholders(values)
        bounds = pis.bounds.resolve(ph)
        ids = _query_table(m).column_ids()
        return [m.api.placeholder_hash(names, ph, bounds),
                m.api.placeholder_hash(names, ph, bounds, 4),
                m.ops.computational_hash(pis.predicate_ops, pis.result, ids),
                m.ops.computational_hash(pis.predicate_ops, pis.result, ids, 4, 4, 5)]

    port, ref = _both(hashes)
    assert port == ref


def _trees(m, seed):
    """A rows tree over two epochs (seeded keys and values; the second
    epoch updates some rows and removes one) and a block tree over
    consecutive blocks: (rows_db, its first epoch, block_db)."""
    rng = np.random.default_rng(seed)
    keys = sorted({int(k) for k in rng.integers(1, 1 << 40, size=9)})
    ident, vid = 1234567, 7654321

    def payload(k, v):
        return m.trees.RowPayload(
            secondary=m.trees.Cell(ident, k, False), row_unique_data=[k % 97, 0, 1, 2],
            cells=m.trees.build_cells_tree([m.trees.Cell(vid, v, False)]))

    vals = [int(v) for v in rng.integers(0, 1 << 30, size=len(keys))]
    rows_db = m.trees.new_row_tree()
    rows_db.in_transaction(lambda t: [t.store((k, 0), payload(k, v))
                                      for k, v in zip(keys, vals)])
    first = rows_db.epoch
    rows_db.in_transaction(lambda t: [t.store((k, 0), payload(k, v + 1))
                                      for k, v in zip(keys[::2], vals[::2])]
                           + [t.remove((keys[1], 0))])
    root = rows_db.payload(rows_db.root())
    digest = m.D.compute_final_digest(False, root.individual_vd, root.multiplier_vd,
                                      root.multiplier_cnt)
    block_db = m.trees.new_block_tree()
    n_blocks = int(rng.integers(3, 8))
    for bn in range(100, 100 + n_blocks):
        block_db.in_transaction(lambda t, bn=bn: t.store(bn, m.trees.BlockPayload(
            index_id=42, block_number=bn, rows_hash=[bn, 1, 2, 3],
            rows_digest=digest)))
    return rows_db, first, block_db


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merkle_path_witnesses_match_reference(seed):
    def paths(m):
        rows_db, first, block_db = _trees(m, seed)
        out = []
        for db in (rows_db.current_view(), rows_db.view_at(first), block_db.current_view()):
            for key in sorted(db.keys()):
                w = m.mp.host_neighbor_path_from_tree(db, key)
                out.append([m.mp.host_path_from_tree(db, key), w, m.mp.node_info_fields(w),
                            m.qc.non_existence_boundary_fields(w)])
        view = rows_db.view_at(first)
        for key in sorted(view.keys()):
            bi = m.qc.make_row_binding(view, key, block_db, 100)
            out.append([bi, bi.boundary_fields()])
        return out

    port, ref = _both(paths)
    assert port == ref


@pytest.mark.parametrize("seed", [0, 1])
def test_find_node_for_non_existence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ranges = [(int(lo), int(lo) + int(w)) for lo, w in
              zip(rng.integers(90, 115, size=12), rng.integers(0, 4, size=12))]

    def found(m):
        _, _, block_db = _trees(m, seed)
        return [m.plan.find_node_for_non_existence(block_db, lo, hi) for lo, hi in ranges]

    port, ref = _both(found)
    assert port == ref
    assert any(x is None for x in port) and any(x is not None for x in port)


def test_sql_bracketer_refuses():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        planner.find_node_for_non_existence_sql(None, None, 0, 1)


# ---------------------------------------------------------------------------
# the slice: run_query over the recording stand-ins
# ---------------------------------------------------------------------------

QUERIES = [
    ("aggregate", f"SELECT SUM(value), COUNT(*) FROM t WHERE {RANGE}",
     {"$MIN_BLOCK": 100, "$MAX_BLOCK": 101}),
    ("empty_range", f"SELECT SUM(value), COUNT(*) FROM t WHERE {RANGE}",
     {"$MIN_BLOCK": 200, "$MAX_BLOCK": 210}),
    ("tabular", f"SELECT DISTINCT value FROM t WHERE {RANGE} AND value >= 150 LIMIT 2",
     {"$MIN_BLOCK": 100, "$MAX_BLOCK": 101}),
]


@functools.lru_cache(maxsize=None)
def _queried(pkg, first):
    """pkg's indexer over the script's chain from block `first`, then the
    three queries: per query its result, its calls (normalised, with the
    raw stand-in envelopes) and the revealed values."""
    ix, log, _ = tp._indexer(pkg, tp.SCRIPT_ADDR, first, queries=True)
    ph = PKGS[pkg].ops.Placeholders
    out = {}
    for name, sql, values in QUERIES:
        start = len(log.calls)
        res, env, reveal = ix.run_query(sql, ph(dict(values)))
        out[name] = SimpleNamespace(result=_norm(res), calls=log.calls[start:],
                                    envs=log.envs[start:], member=env.member,
                                    reveal=[int(v) for v in reveal])
    return log, out


@pytest.mark.parametrize("first", [101, 100], ids=["block 101", "blocks 100-101"])
@pytest.mark.parametrize("query", [q for q, _, _ in QUERIES])
def test_run_query_sequence_matches_reference(query, first):
    _, port = _queried("port", first)
    _, ref = _queried("ref", first)
    p, r = port[query], ref[query]
    assert p.calls == r.calls
    assert (p.result, p.member, p.reveal) == (r.result, r.member, r.reveal)
    assert p.reveal == p.calls[-1]["pis"]
    want = {"aggregate": (["row_chunk"] * (2 if first == 100 else 1)
                          + ["chunk_merge"] * (first == 100) + ["revelation"]),
            "empty_range": ["non_existence", "revelation"],
            "tabular": ["row", "row", "revelation_tabular"]}[query]
    assert [c["member"] for c in p.calls] == want


def test_run_query_results_are_the_flagship_tests():
    """tests/test_circuit_pipeline.py's answers: SUM 400 / COUNT 3 over
    block 101 (SUM 700 / COUNT 5 over blocks 100 and 101), COUNT 0 on the
    empty range, [150, 200] for the tabular query; the revealed block root
    is the IVC step's."""
    for first, agg in ((101, [400, 3]), (100, [700, 5])):
        log, out = _queried("port", first)
        ivc_root = [c for c in log.calls if c["set"] == "ivc"][-1]["pis"][0:4]
        rows = {q: out[q].result[1] for q in out}  # QueryResult.rows
        assert rows == {"aggregate": [agg], "empty_range": [[0, 0]],
                        "tabular": [[150], [200]]}
        for q in out.values():
            assert q.reveal[8:12] == ivc_root
        assert out["aggregate"].reveal[12:28] == [0] * 7 + [agg[0]] + [0] * 7 + [agg[1]]
        assert out["tabular"].reveal[12:16] == [2, 2, 0, 1]


@pytest.mark.parametrize("query", [q for q, _, _ in QUERIES])
def test_run_query_equals_golden(query):
    g = tp._golden()["query"]["block_101_first"][query]
    _, out = _queried("port", 101)
    q = out[query]
    assert q.member == g["member"] and q.reveal == g["reveal"]
    assert [(c["set"], c["member"], c["pis"]) for c in q.calls] == [
        (c["set"], c["member"], c["user_pis"]) for c in g["calls"]]
    want = g["result"]
    assert q.result == _norm(qapi.QueryResult(
        rows=want["rows"], num_matching_rows=want["num_matching_rows"],
        overflow=want["overflow"], computational_hash=tuple(want["computational_hash"]),
        placeholder_hash=tuple(want["placeholder_hash"]),
        chunks=[[tuple(k) for k in c] for c in want["chunks"]]))


# ---------------------------------------------------------------------------
# the seven member bodies
# ---------------------------------------------------------------------------


@pytest.fixture
def without_fixed_commitment(monkeypatch):
    """Compile without the fixed columns' LDE and Merkle commitment."""
    monkeypatch.setattr(prove.CircuitData, "_build_fixed", lambda self: None)
    monkeypatch.setattr(jprove.CircuitData, "_build_fixed", lambda self: None)


DEPTH = 4  # the indexer's row and index tree depths
IVC_PIS = 43  # vdb/circuits.NUM_USER_PIS


def _params(m):
    """The indexer's default query parameters."""
    return m.uni.UniversalQueryParams(num_columns=3, num_placeholders=4,
                                      num_predicate_ops=4, num_result_ops=2, num_outputs=2)


def _stubs(b, widths):
    """Stand-in verifiers: input targets exposed as `public_inputs()`."""
    ts = [b.add_inputs(w) for w in widths]
    return ts, [SimpleNamespace(public_inputs=lambda t=t: list(t)) for t in ts]


@functools.lru_cache(maxsize=None)
def _body(member, pkg):
    """`member`'s body alone (no recursion verifier) in package pkg:
    (circuit data, assign, the stubs' targets)."""
    m = PKGS[pkg]
    p = _params(m)
    W = m.qc._pi_width(p, True)
    with collector_paused():
        b = m.B(m.cfg())
        stubs = []
        if member == "row":
            assign = m.qc.build_tree_bound_row(b, p, DEPTH, DEPTH, pad_to=W)
        elif member == "row_dummy":
            assign = m.qc.build_row_dummy(b, p, W)
        elif member == "row_chunk":
            assign = m.qc.build_row_chunk(b, p, W, 3, DEPTH, DEPTH)
        elif member == "chunk_merge":
            stubs, uvs = _stubs(b, [W, W])
            assign = m.qc.build_chunk_merge(b, p, W, True, uvs)
        elif member == "non_existence":
            assign = m.qc.build_non_existence(b, p, W, DEPTH)
        elif member == "revelation":
            stubs, uvs = _stubs(b, [W, IVC_PIS])
            assign = m.qc.build_revelation(b, p, W, True, uvs[0], uvs[1])
        else:
            assert member == "revelation_tabular"
            stubs, uvs = _stubs(b, [W, W, IVC_PIS])
            assign = m.qc.build_revelation_tabular(b, p, W, uvs[:2], uvs[2])
        return m.build(b), assign, stubs


def _case(member):
    """The inputs the port's indexer hands `member` (block 101, or blocks
    100 -> 101 for chunk_merge) over the stand-ins: (assign args, the stub
    children's PIs, the member's user PIs)."""
    first = 100 if member == "chunk_merge" else 101
    _, out = _queried("port", first)
    if member == "row_dummy":  # the tabular revelation's padding
        row = out["tabular"].envs[0]
        comp, ph = row.pis[0:4], row.pis[4:8]
        pis = comp + ph
        return (comp, ph), [], pis + [0] * (len(row.pis) - len(pis))
    for q in out.values():
        for env in q.envs:
            if env.member == member:
                kids = [c.pis for c in list(env.children) + list(env.foreign)]
                return env.inputs, kids, env.pis
    raise AssertionError(member)


def _witness(data, assign, stubs, args, stub_pis):
    inputs = {}
    assign(inputs, *args)
    for ts, vs in zip(stubs, stub_pis, strict=True):
        inputs.update((t, int(v)) for t, v in zip(ts, vs))
    with collector_paused():
        return data.generate_witness(inputs)


MEMBERS = ["row", "row_dummy", "row_chunk", "chunk_merge", "non_existence", "revelation",
           "revelation_tabular"]


@pytest.mark.parametrize("member", MEMBERS)
def test_member_body_matches_reference(member, without_fixed_commitment):
    args, stub_pis, pis = _case(member)
    if member == "chunk_merge":  # both children real: n_real = 2
        assert list(args) == [2]
    data, assign, stubs = _body(member, "port")
    jdata, jassign, jstubs = _body(member, "ref")
    assert data.n == jdata.n
    assert [n for n, _ in data.gate_types] == [n for n, _ in jdata.gate_types]
    for col in ("selector_values", "constants_values", "sigma_values"):
        np.testing.assert_array_equal(getattr(data, col), getattr(jdata, col))
    assert list(data.public_inputs) == list(jdata.public_inputs)
    assert data.circuit_digest == jdata.circuit_digest
    w = _witness(data, assign, stubs, args, stub_pis)
    np.testing.assert_array_equal(w, _witness(jdata, jassign, jstubs, args, stub_pis))
    data.check_witness(w, pis)


def test_revelation_refuses_another_block_root(without_fixed_commitment):
    """The revelation pins the chunk's index root to the IVC proof's block
    root, in both packages."""
    args, (chunk_pis, ivc_pis), pis = _case("revelation")
    forged = list(ivc_pis)
    forged[0] = (forged[0] + 1) % ((1 << 64) - (1 << 32) + 1)
    for pkg in PKGS:
        data, assign, stubs = _body("revelation", pkg)
        with pytest.raises((ValueError, AssertionError)):
            data.check_witness(_witness(data, assign, stubs, args, [chunk_pis, forged]),
                               pis[:8] + forged[:4] + pis[12:])


@pytest.mark.parametrize("seed", [0, 1])
def test_expected_public_inputs_match_reference(seed):
    rows = [r for _, r in _seeded_rows(seed)]

    def expected(m):
        p = m.uni.UniversalQueryParams(num_columns=4, num_placeholders=4,
                                       num_predicate_ops=6, num_result_ops=6, num_outputs=5)
        uc = m.uni.UniversalQueryCircuit(params=p, data=None, assign=None)
        out = []
        for sql in EXECUTABLE:
            pis = m.asm.parse_and_assemble(sql, _query_table(m))
            ph = m.ops.Placeholders({"$MIN_BLOCK": 100, "$MAX_BLOCK": 103, "$1": 2})
            bounds = pis.bounds.resolve(ph)
            out += [uc.expected_public_inputs(pis, _query_table(m).column_ids(), r, ph, bounds)
                    for r in rows]
        return out

    port, ref = _both(expected)
    assert port == ref


# ---------------------------------------------------------------------------
# proofs (MP2_SLOW)
# ---------------------------------------------------------------------------

slow = pytest.mark.skipif(not os.environ.get("MP2_SLOW"),
                          reason="set MP2_SLOW=1 for prove-heavy tests")


@slow
def test_queries_end_to_end_in_port():
    """The query half of tests/test_circuit_pipeline.py's
    test_circuit_pipeline_end_to_end in the port: block 101 applied, then
    the three queries proved on the CPU, each revelation verified and its
    revealed values equal to the JAX package's (pipeline_golden.json)."""
    cfg, chain = tp._chain("port", tp.SCRIPT_ADDR)
    ix = circuit_pipeline.CircuitTableIndexer(cfg, tabular_rows=2, device="cpu")
    ix.apply_block(chain[1])
    golden = tp._golden()["query"]
    for name in ("row", "chunk", "revelation"):
        assert [int(v) for v in getattr(ix.qc, name).set_digest] == golden[name]["set_digest"]
    for name, sql, values in QUERIES:
        res, env, reveal = ix.run_query(sql, ops.Placeholders(dict(values)))
        g = golden["block_101_first"][name]
        assert ix.verify(env) and env.member == g["member"]
        assert [int(v) for v in reveal] == g["reveal"] == list(env.user_inputs)
        assert [[int(v) for v in r] for r in res.rows] == g["result"]["rows"]
