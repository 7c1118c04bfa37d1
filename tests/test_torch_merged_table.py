"""The port's merged table against mp2_tpu on the CPU.

A merged table joins a mapping table (ERC-20 balances, one row per holder)
with a single-slot table (the total supply) whose value repeats on every
row as the multiplier side of the split digest.  `extraction/final_circuits`'s
`build_merge_body`, `final_merge_pi_values` and `final_merge` member,
`models/pipeline.MergedTableConfig` and `models/circuit_pipeline.MergedTableIndexer`
are held against the reference:

  * `build_merge_body` built once per package without the fixed commitment,
    over block 100's host PIs given as plain witness inputs: equal circuits
    and witnesses, `check_witness` against the JAX package's
    `final_merge_pi_values` for either table as the multiplier, and a wrong
    multiplier flag and a table-b walk over another trie refused (after
    tests/test_final_extraction.py:657-704);
  * `final_merge_pi_values` on numpy-seeded PIs, both flags;
  * `MergedTableConfig`'s column ids, columns and four-column schema;
  * the merge digest algebra (tests/test_merged_table.py:33-119 on the
    port's copies, its values against the reference's) and the rows that
    disagree on the multiplier refused;
  * both packages' `MergedTableIndexer.apply_block` over blocks 100 -> 101
    of tests/test_merged_table.py's chain (on chip_smoke.py's contract) and
    then its query (SUM(value), MAX(supply) over [100, 101]) through
    `run_query`, with recording stand-ins for every set (the extraction's
    answer with the host models' PIs; no circuit is built): the logs of
    calls equal, and every member's PIs, the host models' PIs of both
    blocks and the query's result and revealed values against
    testdata/merged_golden.json (tools/make_merged_golden.py).

The recording stand-ins here also serve the golden tool's `host` part.
The tolerance is 0 everywhere: every compared value is a canonical field
element, an integer or a byte string; curve points are compared by their
field encodings.  No test here proves a circuit.
"""

import functools
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import mp2_tpu.extraction.values as jvalues
import mp2_tpu.hash.poseidon2_host as jp2h
import mp2_tpu.prover.prove as jprove
import mp2_tpu.vdb.query.ops as jops
import mp2_tpu.vdb.trees as jtrees
import mp2_tpu_torch.extraction.values as values
import mp2_tpu_torch.hash.poseidon2_host as p2h
import mp2_tpu_torch.prover.prove as prove
import mp2_tpu_torch.vdb.query.ops as ops
import mp2_tpu_torch.vdb.trees as trees
from mp2_tpu_torch.utils import collector_paused

import test_torch_pipeline as tp

PKGS = {
    "port": SimpleNamespace(**vars(tp.PKGS["port"]), V=values, p2h=p2h, trees=trees,
                            Placeholders=ops.Placeholders),
    "ref": SimpleNamespace(**vars(tp.PKGS["ref"]), V=jvalues, p2h=jp2h, trees=jtrees,
                           Placeholders=jops.Placeholders),
}
ADDR = bytes(range(20))  # chip_smoke.py's table and the golden files'
CHAIN_ID, SLOT, SINGLE_SLOT = 1, 4, 9
BLOCKS = ({b"\x11": 100, b"\x22": 250}, {b"\x11": 120, b"\x22": 250})
SUPPLY = (350, 370)
QUERY = ("SELECT SUM(value), MAX(supply) FROM t WHERE block >= $MIN_BLOCK AND "
         "block <= $MAX_BLOCK", {"$MIN_BLOCK": 100, "$MAX_BLOCK": 101})
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "mp2_tpu_torch", "testdata", "merged_golden.json")


@functools.lru_cache(maxsize=None)
def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _chain(pkg, addr=ADDR):
    m = PKGS[pkg]
    cfg = m.pipe.MergedTableConfig(addr, CHAIN_ID, SLOT, single_slot=SINGLE_SLOT)
    return cfg, m.pipe.make_chain(cfg, BLOCKS, single_values=SUPPLY)


def _ints(xs):
    return [int(v) for v in xs]


def _walks(m, cfg, blk):
    """The host model's root outputs of the mapping walk and the single-slot
    walk of `blk`'s storage trie."""
    a = m.api.extract_storage_slots(blk.storage, [cfg.column], [
        m.api.SlotEntry(cfg.slot, m.sk.mapping_location(cfg.slot, k), mapping_key=k,
                        key_id=cfg.key_id) for k in sorted(blk.entries)])
    b = m.api.extract_storage_slots(blk.storage, [cfg.single_column], [
        m.api.SlotEntry(cfg.single_slot, m.sk.simple_slot_location(cfg.single_slot))])
    return a, b


def _root_pis(m, out):
    """A walk's root PIs as a values proof exposes them: H, DV, DM, N, the
    key (zero at the root here) and S = 0."""
    return _ints(m.mpt.mpt_pi_values(out.node_hash, out.values_digest, out.metadata_digest,
                                     out.n_leaves, [0] * m.mpt.MAX_KEY_NIBBLES, 0))


def host_models(pkg, blk):
    """The host models' PIs of one block of the merged table: both walks'
    roots, the account leaf's, the header's, final_merge's (table a, the
    mapping, individual; table b, the supply, multiplier) and the metadata
    hash."""
    m = PKGS[pkg]
    cfg, _ = _chain(pkg)
    a, b = _walks(m, cfg, blk)
    contract = m.api.extract_contract(blk.state, cfg.contract_address)
    contract_pis = m.fin.contract_pi_values(contract.node_hash, contract.storage_root,
                                            contract.metadata_digest,
                                            m.fin.host_key_nibbles(cfg.contract_address), 0)
    out = m.api.extract_block(blk.header_rlp)
    block_pis = (m.u256.pack_bytes_be(out.block_hash) + m.u256.pack_bytes_be(out.parent_hash)
                 + m.u256.pack_bytes_be(out.state_root) + [out.block_number])
    final = m.fin.final_merge_pi_values(block_pis, _root_pis(m, a), _root_pis(m, b),
                                        contract.metadata_digest, False)
    md = m.D.block_metadata_hash(m.Point.from_fields(final[m.fin.F_DM]), cfg.block_id)
    return {"number": blk.number, "values_a_root": _root_pis(m, a),
            "values_b_root": _root_pis(m, b), "contract": _ints(contract_pis),
            "block": _ints(block_pis), "final_merge": _ints(final),
            "metadata_hash": _ints(md)}


# ---------------------------------------------------------------------------
# the merge body, built once per package
# ---------------------------------------------------------------------------


@pytest.fixture
def without_fixed_commitment(monkeypatch):
    """Compile without the fixed columns' LDE and Merkle commitment."""
    monkeypatch.setattr(prove.CircuitData, "_build_fixed", lambda self: None)
    monkeypatch.setattr(jprove.CircuitData, "_build_fixed", lambda self: None)


@functools.lru_cache(maxsize=None)
def _merge_body(pkg):
    """build_merge_body over (block, contract, table a, table b) PIs given
    as plain witness inputs: (circuit, assign, the stubs' targets)."""
    m = PKGS[pkg]
    with collector_paused():
        b = m.B(m.cfg())
        stubs = [b.add_inputs(w) for w in (m.fin.NUM_BLOCK_PIS, m.fin.NUM_CONTRACT_PIS,
                                           m.mpt.NUM_MPT_PIS, m.mpt.NUM_MPT_PIS)]
        assign = m.fin.build_merge_body(b, *stubs)
        return m.build(b), assign, stubs


def _stub_pis(pkg, forge_b=False):
    """Block 100's (block, contract, table a, table b) PIs; with `forge_b`
    the table-b walk claims block 101's trie."""
    h = host_models(pkg, _chain(pkg)[1][0])
    b = host_models(pkg, _chain(pkg)[1][1])["values_b_root"] if forge_b else h["values_b_root"]
    return [h["block"], h["contract"], h["values_a_root"], b]


def _merge_witness(pkg, a_mult, forge_b=False):
    data, assign, stubs = _merge_body(pkg)
    inputs = {}
    assign(inputs, a_mult)
    for ts, vs in zip(stubs, _stub_pis(pkg, forge_b)):
        inputs.update((t, int(v)) for t, v in zip(ts, vs))
    with collector_paused():
        return data.generate_witness(inputs)


def _want(a_mult, forge_b=False):
    """The JAX package's final_merge_pi_values over the same PIs."""
    block, contract, a, b = _stub_pis("ref", forge_b)
    return PKGS["ref"].fin.final_merge_pi_values(
        block, a, b, PKGS["ref"].Point.from_fields(contract[16:27]), a_mult)


def test_merge_body_matches_reference(without_fixed_commitment):
    data, _, _ = _merge_body("port")
    jdata, _, _ = _merge_body("ref")
    assert data.n == jdata.n
    assert [n for n, _ in data.gate_types] == [n for n, _ in jdata.gate_types]
    for col in ("selector_values", "constants_values", "sigma_values"):
        np.testing.assert_array_equal(getattr(data, col), getattr(jdata, col))
    assert list(data.public_inputs) == list(jdata.public_inputs)
    assert data.circuit_digest == jdata.circuit_digest
    assert _stub_pis("port") == _stub_pis("ref")
    w = _merge_witness("port", False)
    np.testing.assert_array_equal(w, _merge_witness("ref", False))
    want = _want(False)
    assert want[-1] == 1 and want[-2] == len(BLOCKS[0]) + 1
    assert want == host_models("ref", _chain("ref")[1][0])["final_merge"]
    data.check_witness(w, want)
    w_a = _merge_witness("port", True)
    data.check_witness(w_a, _want(True))
    assert _want(True)[17:28] != want[17:28]
    # the flag the proof claims decides the digest: either flag's witness
    # fails against the other flag's PIs
    for wit, pis in ((w, _want(True)), (w_a, want)):
        with pytest.raises((ValueError, AssertionError)):
            data.check_witness(wit, pis)
    # a table-b walk over another block's trie: its root is not the
    # account's storage root
    with pytest.raises((ValueError, AssertionError)):
        data.check_witness(_merge_witness("port", False, forge_b=True),
                           _want(False, forge_b=True))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_final_merge_pi_values_match_reference(seed):
    rng = np.random.default_rng(seed)

    def pis(pkg):
        m = PKGS[pkg]
        pts = [m.p2h.map_to_curve_point([int(v) for v in rng.integers(0, 1 << 62, size=3)])
               for _ in range(5)]
        block = [int(v) for v in rng.integers(0, 1 << 32, size=m.fin.NUM_BLOCK_PIS)]
        a = [0] * 8 + pts[0].to_fields() + pts[1].to_fields() + [int(rng.integers(1, 50))]
        b = [0] * 8 + pts[2].to_fields() + pts[3].to_fields() + [1]
        return [m.fin.final_merge_pi_values(block, a, b, pts[4], flag)
                for flag in (False, True)]

    state = rng.bit_generator.state
    got = pis("port")
    rng.bit_generator.state = state
    assert got == pis("ref")
    assert got[0][-1] == got[1][-1] == 1 and got[0][17:28] != got[1][17:28]


# ---------------------------------------------------------------------------
# the table and the digest algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("addr,slot,single", [(ADDR, SLOT, SINGLE_SLOT),
                                              (bytes(range(40, 60)), 4, 9),
                                              (bytes(range(20)), 3, 0)])
def test_merged_table_config_matches_reference(addr, slot, single):
    cfgs = [PKGS[pkg].pipe.MergedTableConfig(addr, CHAIN_ID, slot, single_slot=single)
            for pkg in PKGS]
    for name in ("key_id", "value_id", "block_id", "supply_id"):
        assert getattr(cfgs[0], name) == getattr(cfgs[1], name)
    for col in ("column", "single_column"):
        assert vars(getattr(cfgs[0], col)) == vars(getattr(cfgs[1], col))
    schemas = [[(c.name, c.identifier, c.kind) for c in cfg.schema().columns] for cfg in cfgs]
    assert schemas[0] == schemas[1]
    assert [c[0] for c in schemas[0]] == ["block", "key", "value", "supply"]
    assert schemas[0][3][1] == cfgs[0].supply_id != cfgs[0].value_id
    for pkg in PKGS:
        with pytest.raises(AssertionError):
            PKGS[pkg].pipe.MergedTableConfig(addr, CHAIN_ID, slot, single_slot=slot)


def _pad_int(m, v):
    return m.u256.left_pad32(v.to_bytes((max(v.bit_length(), 1) + 7) // 8, "big"))


def _row_tree(m, cfg, rows):
    db = m.trees.new_row_tree()

    def tx(t):
        for k, v, s in rows:
            t.store((int.from_bytes(k, "big"), 0), m.trees.RowPayload(
                secondary=m.trees.Cell(cfg.key_id, int.from_bytes(k, "big"), False),
                row_unique_data=m.V.row_unique_data_for_mapping_leaf(k),
                cells=m.trees.build_cells_tree([m.trees.Cell(cfg.value_id, v, False),
                                                m.trees.Cell(cfg.supply_id, s, True)])))

    db.in_transaction(tx)
    return db


def _merge_digests(pkg):
    """tests/test_merged_table.py:33-87: the extraction side's merge digest
    and the rows tree's merged and unmerged final digests."""
    m = PKGS[pkg]
    cfg, _ = _chain(pkg)
    entries, supply = BLOCKS[0], SUPPLY[0]
    dv_a = None
    for k, v in entries.items():
        d = m.V.compute_leaf_mapping_values_digest([cfg.column], [cfg.value_id],
                                                   _pad_int(m, v), k, 0, cfg.key_id)
        dv_a = d if dv_a is None else dv_a + d
    dv_b = m.V.compute_leaf_single_values_digest([cfg.single_column], [cfg.supply_id],
                                                 _pad_int(m, supply))
    merged = dv_a.scalar_mul(m.p2h.hash_to_int(m.p2h.hash_no_pad(dv_b.to_fields())))
    db = _row_tree(m, cfg, [(k, v, supply) for k, v in entries.items()])
    pl = db.payload(db.root())
    assert pl.multiplier_cnt == 1
    return [merged.to_fields()] + [
        m.D.compute_final_digest(flag, pl.individual_vd, pl.multiplier_vd,
                                 pl.multiplier_cnt).to_fields() for flag in (True, False)]


def test_merge_digest_algebra_matches_reference():
    got = _merge_digests("port")
    assert got == _merge_digests("ref")
    merged, rows_merged, rows_plain = got
    assert rows_merged == merged != rows_plain


def test_rows_disagreeing_on_multiplier_rejected():
    """row_tree/full_node.rs:46-52: rows must agree on the multiplier."""
    for pkg in PKGS:
        m = PKGS[pkg]
        cfg, _ = _chain(pkg)
        with pytest.raises(AssertionError):
            _row_tree(m, cfg, [(b"\x11", 100, 350), (b"\x22", 101, 999)])


# ---------------------------------------------------------------------------
# the indexer's sequence, with recording stand-ins
# ---------------------------------------------------------------------------


class _MergedExtraction(tp._Extraction):
    """Stands for vx (the mapping walk, `table` "a") or vx_b (the single
    slot, "b"), and for cx, bx and fx with final_merge: logs each call and
    answers with the host models' PIs."""

    def __init__(self, m, cfg, chain, log, table):
        super().__init__(m, cfg, chain, log)
        self.table = table

    def prove_trie(self, paths, keys):
        m = self.m
        blk = self.by_root[m.keccak.keccak256(next(iter(paths.values()))[0])]
        a, b = _walks(m, self.cfg, blk)
        out = a if self.table == "a" else b
        name = "vx" if self.table == "a" else "vx_b"
        env = self.log.record(name, "prove_trie", [], (paths, keys), _root_pis(m, out), [])
        return env, env.pis

    def prove_merge(self, block_env, contract_env, table_a_env, table_b_env,
                    is_table_a_multiplier=False):
        m = self.m
        pis = m.fin._pad_vals(m.fin.final_merge_pi_values(
            block_env.pis, table_a_env.pis, table_b_env.pis,
            m.Point.from_fields(contract_env.pis[16:27]), is_table_a_multiplier))
        env = self.log.record("fx", "final_merge", [], (is_table_a_multiplier,), pis,
                              [block_env, contract_env, table_a_env, table_b_env])
        return env, env.pis


def indexer(pkg):
    """Both packages' MergedTableIndexer over the merged chain with the
    stand-ins installed (the query sets' too): the indexer and its log."""
    m = PKGS[pkg]
    cfg, chain = _chain(pkg)
    ix = m.cp.MergedTableIndexer(cfg, **m.device)
    log = tp._Log()
    ix.vx = _MergedExtraction(m, cfg, chain, log, "a")
    ix.vx_b = _MergedExtraction(m, cfg, chain, log, "b")
    ix.cx = ix.bx = ix.fx = ix.vx
    ix.vdb = object.__new__(m.vdb.VerifiableDbCircuits)  # its prove_cells_tree, no circuit
    for name in tp.VDB_SETS:
        setattr(ix.vdb, name, tp._Framework(name, log))
    ix.qc = tp._query_stand_in(m, ix, log)
    ix._built = True
    return ix, log


def indexed_blocks(pkg):
    """Blocks 100 then 101 through apply_block: the indexer, its log and
    per block its calls (set, member, user PIs), the rows root's PIs, the
    rows tree's merged digest and the metadata hash."""
    m = PKGS[pkg]
    ix, log = indexer(pkg)
    blocks = []
    for blk in _chain(pkg)[1]:
        start = len(log.calls)
        final_env = ix.apply_block(blk)
        root = ix.rows_db.payload(ix.rows_db.root())
        rows_digest = m.D.compute_final_digest(True, root.individual_vd, root.multiplier_vd,
                                               root.multiplier_cnt)
        assert ix.proofs[("final_extraction", blk.number)] is final_env
        assert ix.proofs[("ivc", blk.number)] is ix.ivc_env
        blocks.append({"number": blk.number,
                       "calls": [{"set": c["set"], "member": c["member"], "pis": c["pis"]}
                                 for c in log.calls[start:]],
                       "final": final_env.pis, "rows_digest": _ints(rows_digest.to_fields()),
                       "rows_root_pis": _ints(m.vdb.rows_pi_values(root)),
                       "metadata_hash": _ints(ix.metadata_hash)})
    return ix, log, blocks


def run_merged_query(pkg, ix, log):
    """tests/test_merged_table.py's query through run_query: its result,
    calls (set, member, user PIs), revelation member and revealed values."""
    sql, values = QUERY
    start = len(log.calls)
    res, env, reveal = ix.run_query(sql, PKGS[pkg].Placeholders(dict(values)))
    return {"sql": sql, "placeholders": values,
            "result": {"rows": [_ints(r) for r in res.rows],
                       "num_matching_rows": int(res.num_matching_rows),
                       "overflow": bool(res.overflow),
                       "computational_hash": _ints(res.computational_hash),
                       "placeholder_hash": _ints(res.placeholder_hash),
                       "chunks": [[list(k) for k in c] for c in res.chunks]},
            "calls": [{"set": c["set"], "member": c["member"], "user_pis": c["pis"]}
                      for c in log.calls[start:]],
            "member": env.member, "reveal": _ints(reveal)}


@functools.lru_cache(maxsize=None)
def _run(pkg):
    ix, log, blocks = indexed_blocks(pkg)
    query = run_merged_query(pkg, ix, log)
    return log.calls, blocks, query


def test_merged_indexer_sequence_matches_reference():
    calls, blocks, query = _run("port")
    jcalls, jblocks, jquery = _run("ref")
    assert calls == jcalls
    assert blocks == jblocks and query == jquery
    for b, entries in zip(blocks, BLOCKS, strict=True):
        members = [(c["set"], c["member"]) for c in b["calls"]]
        assert members[:5] == [("vx", "prove_trie"), ("vx_b", "prove_trie"),
                               ("cx", "prove_state_path"), ("bx", "prove_header"),
                               ("fx", "final_merge")]
        assert b["rows_digest"] == b["final"][17:28]
        rows = [x for s, x in members if s == "rows"]
        assert rows == ["rows_leaf"] + ["rows_partial"] * (len(entries) - 1)
        # each row's cells tree: the value cell's leaf under the supply cell
        assert [x for s, x in members if s == "cells"] == ["cells_leaf", "cells_partial"] * len(
            entries)
    merge_calls = [c for c in calls if c["member"] == "final_merge"]
    assert [c["inputs"] for c in merge_calls] == [[0], [0]]  # table a is not the multiplier
    block_calls = [c for c in calls if c["set"] == "block"]
    assert [c["member"] for c in block_calls] == ["block_leaf_bound", "block_parent_bound"]
    assert block_calls[0]["inputs"][2] == 1 and block_calls[1]["inputs"][3] == 1  # is_merge
    assert [c["member"] for c in calls if c["set"] == "ivc"] == ["ivc_first", "ivc_subsequent"]
    assert [c["member"] for c in query["calls"]] == ["row_chunk", "row_chunk", "chunk_merge",
                                                     "revelation"]
    assert query["result"]["rows"] == [[720, 370]]


def test_merged_indexer_equals_golden():
    _, blocks, query = _run("port")
    g = _golden()["host"]
    cfg, chain = _chain("port")
    assert [cfg.key_id, cfg.value_id, cfg.supply_id, cfg.block_id] == [
        g["table"][k] for k in ("key_id", "value_id", "supply_id", "block_id")]
    assert [host_models("port", blk) for blk in chain] == g["host_models"]
    assert blocks == g["blocks_100_101"]
    assert query == g["query"]
    for b, h in zip(blocks, g["host_models"], strict=True):
        assert b["final"][:len(h["final_merge"])] == h["final_merge"]
        assert b["metadata_hash"] == h["metadata_hash"]
    sums = [query["reveal"][12 + 8 * i: 20 + 8 * i] for i in range(2)]
    got = [functools.reduce(lambda acc, limb: (acc << 32) | limb, s, 0) for s in sums]
    assert got == [720, 370]
