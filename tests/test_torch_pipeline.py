"""The port's indexing pipeline and extraction-bound block members against
mp2_tpu on the CPU.

`models/{pipeline,proof_store,circuit_pipeline}.py` and the block set's
`block_leaf_bound` and `block_parent_bound` (`vdb/circuits.py`) are held
against the reference:

  * the host layer: `make_chain`'s headers and trie roots and
    `MappingTableConfig`'s column ids on the pipeline test's chain
    (tests/test_circuit_pipeline.py: ADDR bytes(range(10, 30))) and on
    chip_smoke.py's (bytes(range(20))); `proof_store`'s key encoding and
    its three stores' round trips;
  * the indexer's sequence: both packages' `CircuitTableIndexer.apply_block`
    over blocks 100 -> 101 and over block 101 alone, with recording
    stand-ins for the extraction sets and the four vdb sets (each call is
    logged and answered with the host models' public inputs; no circuit is
    built): the ordered logs of calls (set, member, children, witness
    inputs, PIs, foreign children) must be equal, the rows digest must
    equal the final extraction's DV at each block, and block 101 as a
    parent must ask for `block_parent_bound` with no right child;
  * the two bound bodies built in both packages over stand-in child and
    foreign PIs (plain witness inputs), compiled once per package without
    the fixed commitment and shared: equal circuits and witnesses,
    `check_witness` on block 101's host values, and the forged inputs of
    tests/test_final_extraction.py:325 refused by both packages (another
    block's DV, another block number, a non-zero high limb of the number,
    a merge flag the block does not claim);
  * block 101's host values against testdata/pipeline_golden.json, which
    the JAX package wrote (tools/make_pipeline_golden.py).

The recording stand-ins here also serve tests/test_torch_query.py and the
golden tool's `query` part, which add the query sets' stand-ins
(`_indexer(..., queries=True)`).

The tolerance is 0 everywhere: the outputs are canonical field values,
digests and byte strings; curve points are compared by their field
encodings.  No test here proves a circuit outside MP2_SLOW.
"""

import dataclasses
import functools
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import mp2_tpu.circuit.builder as jbuilder
import mp2_tpu.extraction.api as japi
import mp2_tpu.extraction.final_circuits as jfinal
import mp2_tpu.extraction.mpt_circuits as jmpt
import mp2_tpu.extraction.storage_key as jsk
import mp2_tpu.field.ecgfp5 as jecgfp5
import mp2_tpu.models.circuit_pipeline as jcircuit_pipeline
import mp2_tpu.models.pipeline as jpipeline
import mp2_tpu.models.proof_store as jproof_store
import mp2_tpu.prover.config as jconfig
import mp2_tpu.prover.prove as jprove
import mp2_tpu.utils.keccak as jkeccak
import mp2_tpu.utils.u256 as ju256
import mp2_tpu.vdb.circuits as jvdb
import mp2_tpu.vdb.digests as jdigests
import mp2_tpu.vdb.query.chunks as jchunks
import mp2_tpu_torch.circuit.builder as builder
import mp2_tpu_torch.extraction.api as api
import mp2_tpu_torch.extraction.final_circuits as final
import mp2_tpu_torch.extraction.mpt_circuits as mpt
import mp2_tpu_torch.extraction.storage_key as sk
import mp2_tpu_torch.field.ecgfp5 as ecgfp5
import mp2_tpu_torch.models.circuit_pipeline as circuit_pipeline
import mp2_tpu_torch.models.pipeline as pipeline
import mp2_tpu_torch.models.proof_store as proof_store
import mp2_tpu_torch.prover.config as config
import mp2_tpu_torch.prover.prove as prove
import mp2_tpu_torch.utils.keccak as keccak
import mp2_tpu_torch.utils.u256 as u256
import mp2_tpu_torch.vdb.circuits as vdb
import mp2_tpu_torch.vdb.digests as digests
import mp2_tpu_torch.vdb.query.chunks as chunks
import mp2_tpu_torch.vdb.trees as trees
from mp2_tpu_torch.extraction import values as V
from mp2_tpu_torch.utils import collector_paused

PKGS = {
    "port": SimpleNamespace(
        B=builder.CircuitBuilder, cfg=config.test_config, api=api, fin=final, mpt=mpt,
        sk=sk, Point=ecgfp5.Point, cp=circuit_pipeline, pipe=pipeline,
        store=proof_store, keccak=keccak, u256=u256, vdb=vdb, D=digests, qc=chunks,
        build=lambda b: b.build("cpu"), device={"device": "cpu"}),
    "ref": SimpleNamespace(
        B=jbuilder.CircuitBuilder, cfg=jconfig.test_config, api=japi, fin=jfinal, mpt=jmpt,
        sk=jsk, Point=jecgfp5.Point, cp=jcircuit_pipeline, pipe=jpipeline,
        store=jproof_store, keccak=jkeccak, u256=ju256, vdb=jvdb, D=jdigests, qc=jchunks,
        build=lambda b: b.build(), device={}),
}
SCRIPT_ADDR = bytes(range(20))  # chip_smoke.py's table and the golden files'
PIPELINE_ADDR = bytes(range(10, 30))  # tests/test_circuit_pipeline.py:19
CHAIN_ID = 1
SLOT = 4
BLOCKS = ({b"\x11": 100, b"\x22": 200}, {b"\x11": 150, b"\x22": 200, b"\x33": 50})
VDB_SETS = ("cells", "rows", "block", "ivc")
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "mp2_tpu_torch", "testdata", "pipeline_golden.json")


@functools.lru_cache(maxsize=None)
def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _chain(pkg, addr):
    m = PKGS[pkg]
    cfg = m.pipe.MappingTableConfig(addr, CHAIN_ID, SLOT)
    return cfg, m.pipe.make_chain(cfg, BLOCKS)


# ---------------------------------------------------------------------------
# the host layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("addr", [PIPELINE_ADDR, SCRIPT_ADDR], ids=["pipeline", "script"])
def test_make_chain_matches_reference(addr):
    cfg, chain = _chain("port", addr)
    jcfg, jchain = _chain("ref", addr)
    assert [cfg.key_id, cfg.value_id, cfg.block_id] == [jcfg.key_id, jcfg.value_id,
                                                       jcfg.block_id]
    assert dataclasses.asdict(cfg.column) == dataclasses.asdict(jcfg.column)
    for blk, jblk in zip(chain, jchain, strict=True):
        assert blk.number == jblk.number and blk.entries == jblk.entries
        assert blk.header_rlp == jblk.header_rlp
        assert blk.storage.root_hash() == jblk.storage.root_hash()
        assert blk.state.root_hash() == jblk.state.root_hash()
    assert [b.number for b in chain] == [100, 101]


KEYS = [("cell", ("t", 100, 7, 3)), ("row", ("t", 101, (17, 0))), ("index", ("t", 101)),
        ("final_extraction", ("t", 101)), ("contract_extraction", (SCRIPT_ADDR, 101)),
        ("block_extraction", (101,)), ("value_extraction", ("t", 100)), ("ivc", (101,)),
        ("query_universal", ("q", [1, 2], 101, (17, 0))),
        ("query_aggregate", ("q", [1, 2], b"\x01\x02"))]


@pytest.mark.parametrize("kind,args", KEYS, ids=[k for k, _ in KEYS])
def test_proof_key_encoding_matches_reference(kind, args):
    key = getattr(proof_store.ProofKey, kind)(*args)
    jkey = getattr(jproof_store.ProofKey, kind)(*args)
    assert key.encode() == jkey.encode()
    assert proof_store.ProofKey("rows_root", (101,)).encode() == \
        jproof_store.ProofKey("rows_root", (101,)).encode()


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_proof_stores_round_trip_as_reference(backend, tmp_path):
    """The same operations on both packages' stores leave the same keys and
    values: store, overwrite, move, the ProofDict facades and their
    lengths."""
    def run(m, path):
        store = (m.store.MemoryProofStore() if backend == "memory"
                 else m.store.SqliteProofKV(str(path)))
        proofs, rows = m.store.ProofDict(store), m.store.ProofDict(store, "row_tree")
        proofs[("final_extraction", 101)] = {"env": 1}
        proofs[("ivc", 101)] = [1, 2, 3]
        rows[(17, 0)] = "row 17"
        rows[34] = "row 34"
        rows[34] = "row 34 again"
        store.move_proof(m.store.ProofKey("row_tree", (34,)),
                         m.store.ProofKey("row_tree", (51,)))
        out = {"keys": sorted(store.keys()), "len": len(store), "rows": len(rows),
               "all": len(proofs), "got": [proofs[("ivc", 101)], rows[(17, 0)], rows[51]],
               "missing": [34 in rows, rows.get(34, "none"), ("ivc", 100) in proofs]}
        with pytest.raises(KeyError):
            rows[34]
        return out

    assert run(PKGS["port"], tmp_path / "port.sqlite") == run(PKGS["ref"],
                                                              tmp_path / "ref.sqlite")


# ---------------------------------------------------------------------------
# the indexer's sequence, with recording stand-ins
# ---------------------------------------------------------------------------


class _Env:
    """A stand-in envelope: the index of the call that made it, its member
    and its PIs."""

    def __init__(self, index, member, pis):
        self.index, self.member, self.pis = index, member, [int(v) for v in pis]
        self.user_inputs = self.pis


def _norm(x):
    """A call's arguments in a form both packages share."""
    if isinstance(x, _Env):
        return ("env", x.index)
    if isinstance(x, bytes):
        return x.hex()
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(_norm(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return sorted((_norm(k), _norm(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (bool, int, np.integer)):
        return int(x)
    return x


class _Log:
    def __init__(self):
        self.calls, self.envs = [], []

    def record(self, set_name, member, children, inputs, pis, foreign):
        env = _Env(len(self.calls), member, pis)
        env.children, env.inputs, env.foreign = children, inputs, foreign or []
        self.envs.append(env)
        self.calls.append({"set": set_name, "member": member, "children": _norm(children),
                           "inputs": _norm(inputs), "pis": env.pis,
                           "foreign": _norm(foreign or [])})
        return env


class _Framework:
    """Stands for one of the four vdb sets: logs each proof it is asked for
    and returns an envelope carrying the PIs it was given."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def prove_leaf(self, member, inputs, pis):
        return self.log.record(self.name, member, [], inputs, pis, [])

    def prove_aggregation(self, member, children, inputs, pis, foreign_children=None):
        return self.log.record(self.name, member, children, inputs, pis, foreign_children)


class _Extraction:
    """Stands for vx, cx, bx and fx at once: logs each call and answers with
    the host models' PIs (extract_storage_slots, extract_contract,
    extract_block, final_pi_values)."""

    def __init__(self, m, cfg, chain, log):
        self.m, self.cfg, self.log = m, cfg, log
        self.by_root = {}
        for blk in chain:
            self.by_root[blk.storage.root_hash()] = blk
            self.by_root[blk.state.root_hash()] = blk

    def prove_trie(self, paths, keys):
        m, cfg = self.m, self.cfg
        blk = self.by_root[m.keccak.keccak256(next(iter(paths.values()))[0])]
        out = m.api.extract_storage_slots(blk.storage, [cfg.column], [
            m.api.SlotEntry(cfg.slot, m.sk.mapping_location(cfg.slot, k), mapping_key=k,
                            key_id=cfg.key_id) for k in sorted(blk.entries)])
        pis = m.mpt.mpt_pi_values(out.node_hash, out.values_digest, out.metadata_digest,
                                  out.n_leaves, [0] * m.mpt.MAX_KEY_NIBBLES, 0)
        env = self.log.record("vx", "prove_trie", [], (paths, keys), pis, [])
        return env, env.pis

    def prove_state_path(self, path):
        m, cfg = self.m, self.cfg
        blk = self.by_root[m.keccak.keccak256(path[0])]
        out = m.api.extract_contract(blk.state, cfg.contract_address)
        pis = m.fin.contract_pi_values(out.node_hash, out.storage_root, out.metadata_digest,
                                       m.fin.host_key_nibbles(cfg.contract_address), 0)
        env = self.log.record("cx", "prove_state_path", [], path, pis, [])
        return env, env.pis

    def prove_header(self, header):
        m = self.m
        out = m.api.extract_block(header)
        pis = (m.u256.pack_bytes_be(out.block_hash) + m.u256.pack_bytes_be(out.parent_hash)
               + m.u256.pack_bytes_be(out.state_root) + [out.block_number])
        env = self.log.record("bx", "prove_header", [], header, pis, [])
        return env, env.pis

    def prove(self, block_env, contract_env, values_env):
        m = self.m
        pis = m.fin._pad_vals(m.fin.final_pi_values(
            block_env.pis, values_env.pis, m.Point.from_fields(contract_env.pis[16:27])))
        env = self.log.record("fx", "final_simple", [], (), pis,
                              [block_env, contract_env, values_env])
        return env, env.pis


TABULAR_ROWS = 2  # tests/test_circuit_pipeline.py's indexer


def _query_stand_in(m, ix, log):
    """The indexer's QueryCircuits with its row, chunk and revelation sets
    replaced by recording stand-ins: the constructor's fields, no circuit."""
    qc = object.__new__(m.qc.QueryCircuits)
    qc.config, qc.params, qc.ivc_framework = ix.config, ix.query_params, None
    qc.bind, qc.row_tree_depth = ix.row_tree_depth > 0, ix.row_tree_depth
    qc.index_tree_depth, qc.tabular_rows = ix.index_tree_depth, ix.tabular_rows
    qc.num_rows_per_chunk, qc.chunk_fanin = 3, 2
    qc.W = m.qc._pi_width(ix.query_params, qc.bind)
    for name in ("row", "chunk", "revelation"):
        setattr(qc, name, _Framework(name, log))
    return qc


def _indexer(pkg, addr, first, queries=False):
    """Both packages' CircuitTableIndexer over the chain from block `first`
    on, with the stand-ins installed (and the query sets' with `queries`):
    the indexer, its log, and per block the log of its calls, the rows
    digest of its rows root and the indexer's metadata hash."""
    m = PKGS[pkg]
    cfg, chain = _chain(pkg, addr)
    ix = m.cp.CircuitTableIndexer(cfg, tabular_rows=TABULAR_ROWS, **m.device)
    log = _Log()
    ix.vx = ix.cx = ix.bx = ix.fx = _Extraction(m, cfg, chain, log)
    ix.vdb = object.__new__(m.vdb.VerifiableDbCircuits)  # its prove_cells_tree, no circuit
    for name in VDB_SETS:
        setattr(ix.vdb, name, _Framework(name, log))
    if queries:
        ix.qc = _query_stand_in(m, ix, log)
    ix._built = True
    blocks = []
    for blk in chain:
        if blk.number < first:
            continue
        start = len(log.calls)
        final_env = ix.apply_block(blk)
        root = ix.rows_db.payload(ix.rows_db.root())
        rows_digest = m.D.compute_final_digest(False, root.individual_vd,
                                               root.multiplier_vd, root.multiplier_cnt)
        assert ix.proofs[("final_extraction", blk.number)] is final_env
        assert ix.proofs[("ivc", blk.number)] is ix.ivc_env
        blocks.append({"number": blk.number, "calls": log.calls[start:],
                       "final": final_env.pis, "rows_digest": rows_digest.to_fields(),
                       "rows_root_pis": m.vdb.rows_pi_values(root),
                       "metadata_hash": [int(v) for v in ix.metadata_hash]})
    return ix, log, blocks


@functools.lru_cache(maxsize=None)
def _indexed(pkg, addr, first):
    _, log, blocks = _indexer(pkg, addr, first)
    return log.calls, blocks


RUNS = [(PIPELINE_ADDR, 100), (SCRIPT_ADDR, 100), (SCRIPT_ADDR, 101)]


@pytest.mark.parametrize("addr,first", RUNS, ids=["pipeline 100-101", "script 100-101",
                                                   "script 101"])
def test_indexer_sequence_matches_reference(addr, first):
    calls, blocks = _indexed("port", addr, first)
    jcalls, jblocks = _indexed("ref", addr, first)
    assert calls == jcalls
    assert blocks == jblocks
    for b in blocks:
        assert b["rows_digest"] == b["final"][final.F_DV]
        members = [(c["set"], c["member"]) for c in b["calls"]]
        want_rows = ["rows_leaf"] + ["rows_partial"] * (len(BLOCKS[b["number"] - 100]) - 1)
        assert [x for s, x in members if s == "rows"] == want_rows
        assert members[:4] == [("vx", "prove_trie"), ("cx", "prove_state_path"),
                               ("bx", "prove_header"), ("fx", "final_simple")]
    if first == 100:
        block_101 = [c for c in blocks[1]["calls"] if c["set"] == "block"]
        assert [c["member"] for c in block_101] == ["block_parent_bound"]
        (call,) = block_101
        has_right = call["inputs"][2]
        assert has_right == 0 and call["children"][0] == call["children"][1]


def _by_set(block, name):
    return [c for c in block["calls"] if c["set"] == name]


@pytest.mark.parametrize("run", ["block_101_first", "blocks_100_101"])
def test_indexer_plans_equal_golden(run):
    """The port's log against the plans the JAX package's host models give
    (tools/make_pipeline_golden.py, computed without the indexer)."""
    _, blocks = _indexed("port", SCRIPT_ADDR, 101 if run == "block_101_first" else 100)
    golden = _golden()["host"][run]
    golden = [golden] if run == "block_101_first" else golden
    for b, g in zip(blocks, golden, strict=True):
        assert b["number"] == g["block_number"]
        assert [(c["member"], c["pis"]) for c in _by_set(b, "rows")] == [
            (r["member"], r["public_inputs"]) for r in g["rows_plan"]]
        assert [(c["member"], c["pis"]) for c in _by_set(b, "block")] == [
            (r["member"], r["public_inputs"]) for r in g["block_plan"]]
        assert [x["inputs"][2] for x in _by_set(b, "block")
                if x["member"].startswith("block_parent")] == [
            int(r["has_right"]) for r in g["block_plan"] if r["member"].startswith("block_p")]
        (ivc,) = _by_set(b, "ivc")
        assert (ivc["member"], ivc["pis"]) == (g["ivc_member"], g["ivc_public_inputs"])
        assert b["rows_root_pis"] == g["rows_root_public_inputs"]
        assert b["rows_digest"] == g["rows_digest"] == g["final_values_digest"]
        assert b["metadata_hash"] == g["metadata_hash"]


def test_block_101_host_values_equal_golden():
    """Block 101 applied first: the rows root payload's PIs, the rows
    digest, the block payload's PIs, the metadata hash and the IVC PIs of
    the port's host models against the JAX package's golden record."""
    g = _golden()["host"]["block_101_first"]
    cfg, chain = _chain("port", SCRIPT_ADDR)
    blk = chain[1]
    rows_db, block_db = trees.new_row_tree(), trees.new_block_tree()
    rows_db.in_transaction(lambda t: [t.store((int.from_bytes(k, "big"), 0), trees.RowPayload(
        secondary=trees.Cell(cfg.key_id, int.from_bytes(k, "big"), False),
        row_unique_data=V.row_unique_data_for_mapping_leaf(k),
        cells=trees.build_cells_tree([trees.Cell(cfg.value_id, v, False)])))
        for k, v in blk.entries.items()])
    root = rows_db.payload(rows_db.root())
    rows_digest = digests.compute_final_digest(False, root.individual_vd, root.multiplier_vd,
                                               root.multiplier_cnt)
    block_db.in_transaction(lambda t: t.store(101, trees.BlockPayload(
        index_id=cfg.block_id, block_number=101, rows_hash=root.hash,
        rows_digest=rows_digest)))
    values = api.extract_storage_slots(blk.storage, [cfg.column], [
        api.SlotEntry(SLOT, sk.mapping_location(SLOT, k), mapping_key=k, key_id=cfg.key_id)
        for k in sorted(blk.entries)])
    fin = api.final_extraction(api.extract_block(blk.header_rlp),
                               api.extract_contract(blk.state, SCRIPT_ADDR), values,
                               blk.storage.root_hash(), blk.state.root_hash())
    md = digests.block_metadata_hash(fin.metadata_digest, cfg.block_id)
    assert vdb.rows_pi_values(root) == g["rows_root_public_inputs"]
    assert rows_digest.to_fields() == g["rows_digest"] == fin.values_digest.to_fields()
    assert [vdb.block_pi_values(block_db.payload(101))] == [
        r["public_inputs"] for r in g["block_plan"]]
    assert [int(v) for v in md] == g["metadata_hash"]
    assert vdb.ivc_pi_values(block_db.payload(101).hash, md, 101) == g["ivc_public_inputs"]
    assert [cfg.key_id, cfg.value_id, cfg.block_id] == [
        _golden()["host"]["table"][k] for k in ("key_id", "value_id", "block_id")]


# ---------------------------------------------------------------------------
# the two bound bodies
# ---------------------------------------------------------------------------


@pytest.fixture
def without_fixed_commitment(monkeypatch):
    """Compile without the fixed columns' LDE and Merkle commitment."""
    monkeypatch.setattr(prove.CircuitData, "_build_fixed", lambda self: None)
    monkeypatch.setattr(jprove.CircuitData, "_build_fixed", lambda self: None)


@functools.lru_cache(maxsize=None)
def _bound(member, pkg):
    """`member` over stand-in PIs (plain witness inputs): the block
    children's, the rows root's and the final extraction's."""
    m = PKGS[pkg]
    with collector_paused():
        b = m.B(m.cfg())
        widths = [m.vdb.NUM_USER_PIS] * (2 if member == "block_parent_bound" else 0)
        widths += [m.vdb.NUM_USER_PIS, m.mpt.NUM_MPT_PIS]
        stubs = [b.add_inputs(w) for w in widths]
        children = [SimpleNamespace(public_inputs=lambda t=t: list(t)) for t in stubs]
        assign = getattr(m.vdb, f"_build_{member}")(b, children[:-2], children[-2:])
        return m.build(b), assign, stubs


def _pis_of(calls, index):
    return calls[index]["pis"]


def _bound_case(member):
    """The host values the indexer gives the member: block 101 as the first
    block (a leaf), or block 101 over block 100 (a parent with no right
    child): (assign args, the stubs' PIs, the node's PIs)."""
    calls, _ = _indexed("port", SCRIPT_ADDR, 101 if member == "block_leaf_bound" else 100)
    (call,) = [c for c in calls if c["member"] == member]
    kids = [_pis_of(calls, i) for _, i in call["children"]]
    foreign = [_pis_of(calls, i) for _, i in call["foreign"]]
    return call["inputs"], kids + foreign, call["pis"]


def _witness(data, assign, stubs, args, stub_pis):
    inputs = {}
    assign(inputs, *args)
    for ts, vs in zip(stubs, stub_pis, strict=True):
        inputs.update((t, int(v)) for t, v in zip(ts, vs))
    with collector_paused():
        return data.generate_witness(inputs)


@pytest.mark.parametrize("member", ["block_leaf_bound", "block_parent_bound"])
def test_bound_body_matches_reference(member, without_fixed_commitment):
    args, stub_pis, pis = _bound_case(member)
    data, assign, stubs = _bound(member, "port")
    jdata, jassign, jstubs = _bound(member, "ref")
    assert data.n == jdata.n == 1 << 15
    assert [n for n, _ in data.gate_types] == [n for n, _ in jdata.gate_types]
    for col in ("selector_values", "constants_values", "sigma_values"):
        np.testing.assert_array_equal(getattr(data, col), getattr(jdata, col))
    assert list(data.public_inputs) == list(jdata.public_inputs)
    assert data.circuit_digest == jdata.circuit_digest
    w = _witness(data, assign, stubs, args, stub_pis)
    np.testing.assert_array_equal(w, _witness(jdata, jassign, jstubs, args, stub_pis))
    data.check_witness(w, pis)


def _forged(case):
    """Block 101's leaf inputs with one forged value: (assign args, stub
    PIs)."""
    args, (rows, fin), _ = _bound_case("block_leaf_bound")
    args, fin = list(args), list(fin)
    if case == "dv":  # block 100's values digest over block 101's rows root
        calls, _ = _indexed("port", SCRIPT_ADDR, 100)
        fin[final.F_DV] = next(c["pis"] for c in calls
                               if c["member"] == "final_simple")[final.F_DV]
    elif case == "bn":
        fin[final.F_BN] = 102
    elif case == "high_limb":
        args[1] += 1 << 32
    else:
        assert case == "merge"
        fin[final.F_MERGE] = 1
    return args, [rows, fin]


@pytest.mark.parametrize("case", ["dv", "bn", "high_limb", "merge"])
def test_bound_leaf_refuses_forged_inputs(case, without_fixed_commitment):
    """tests/test_final_extraction.py:325's binding, in both packages:
    each forged input fails to generate a witness or to check."""
    _, _, pis = _bound_case("block_leaf_bound")
    args, stub_pis = _forged(case)
    for pkg in PKGS:
        data, assign, stubs = _bound("block_leaf_bound", pkg)
        with pytest.raises((ValueError, AssertionError)):
            data.check_witness(_witness(data, assign, stubs, args, stub_pis), pis)


# ---------------------------------------------------------------------------
# proofs (MP2_SLOW)
# ---------------------------------------------------------------------------

slow = pytest.mark.skipif(not os.environ.get("MP2_SLOW"),
                          reason="set MP2_SLOW=1 for prove-heavy tests")


@slow
def test_pipeline_indexing_end_to_end_in_port():
    """The indexing half of tests/test_circuit_pipeline.py's
    test_circuit_pipeline_end_to_end in the port, over the script's blocks
    100 -> 101 (block 100 a block_leaf_bound, block 101 a
    block_parent_bound over it): every root verified, every PI equal to
    the JAX package's host models (testdata/pipeline_golden.json)."""
    cfg, chain = _chain("port", SCRIPT_ADDR)
    ix = circuit_pipeline.CircuitTableIndexer(cfg, device="cpu")
    golden = _golden()["host"]["blocks_100_101"]
    for blk, g in zip(chain, golden, strict=True):
        final_env = ix.apply_block(blk)
        assert ix.fx.verify(final_env)
        rows_env = ix.rows_root_env[blk.number]
        assert ix.vdb.rows.verify(rows_env)
        assert rows_env.user_inputs == g["rows_root_public_inputs"]
        block_env = ix.block_node_env[blk.number]
        assert ix.vdb.block.verify(block_env)
        assert block_env.member == g["block_plan"][-1]["member"]
        assert block_env.user_inputs == g["block_plan"][-1]["public_inputs"]
        assert ix.vdb.ivc.verify(ix.ivc_env)
        assert ix.ivc_env.user_inputs == g["ivc_public_inputs"]
        assert final_env.user_inputs[final.F_DV] == g["rows_digest"]


@slow
def test_block_leaf_bound_end_to_end_in_port():
    """tests/test_final_extraction.py:325 through the port's indexer: block
    101 applied first proves its extraction, rows tree, block_leaf_bound
    and ivc_first, each verified and held to the JAX package's host values;
    the reference's block set with the same extraction has the same set
    digest (testdata/pipeline_golden.json)."""
    cfg, chain = _chain("port", SCRIPT_ADDR)
    ix = circuit_pipeline.CircuitTableIndexer(cfg, device="cpu")
    g = _golden()["host"]["block_101_first"]
    ix.apply_block(chain[1])
    block_env = ix.block_node_env[101]
    assert block_env.member == "block_leaf_bound" and ix.vdb.block.verify(block_env)
    assert block_env.user_inputs == g["block_plan"][0]["public_inputs"]
    assert ix.vdb.ivc.verify(ix.ivc_env)
    assert ix.ivc_env.user_inputs == g["ivc_public_inputs"]
    sets = _golden()["sets"]
    assert list(ix.vdb.block.set_digest) == sets["block"]["set_digest"]
    assert list(ix.vdb.ivc.set_digest) == sets["ivc"]["set_digest"]
