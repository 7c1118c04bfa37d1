"""Write mp2_tpu_torch/testdata/merged_golden.json from the JAX package.

The PyTorch port's merged table (`extraction/final_circuits`'s `final_merge`,
`models/pipeline.MergedTableConfig`, `models/circuit_pipeline.MergedTableIndexer`
and `api.build_circuits_params` over a merged table) is held against
`mp2_tpu`.  The table is chip_smoke.py's pipeline table (contract
bytes(range(20)), chain 1, mapping slot 4) merged with the single slot 9,
and its chain is tests/test_merged_table.py's: balances {0x11: 100, 0x22:
250} then {0x11: 120, 0x22: 250}, total supply 350 then 370, blocks 100 and
101 as mp2_tpu/models/pipeline.make_chain builds them.  Three parts:

  host   the host models' values of both blocks (the mapping walk's and the
         single-slot walk's root PIs from extract_storage_slots, the account
         leaf's, the header's and final_merge's PIs, the metadata hash) and
         MergedTableIndexer.apply_block over blocks 100 then 101 through the
         recording stand-ins of tests/test_torch_merged_table.py (the (set,
         member, user PIs) of every proof it asks for, in order), then the
         merged query of tests/test_merged_table.py (SUM(value), MAX(supply)
         over [100, 101]) through run_query: its QueryResult, calls and
         revealed values;
  sets   at the branch arities given (default 1,2,3): the multiplier table's
         values set `vx_b`, the merged final set (`final_simple`,
         `final_merge`), and the verifiable DB's block set (with
         `block_leaf_bound` and `block_parent_bound` over that final set)
         and IVC set, each with the record chip_smoke.py's `_set_record`
         keeps.  The values set of the mapping table at the default
         arities, the contract and block sets and the rows set enter as
         what a cross-set verifier reads of them (a finalized set, its
         digest, standard shape and height), from
         extraction_golden.json, final_extraction_golden.json and
         vdb_golden.json; at other arities the mapping table's values set
         is built and recorded too.  Checked: `final_simple`'s member
         digest at the default arities and `block_leaf`'s and
         `block_parent`'s (which verify only the rows set) equal the
         recorded ones;
  query  QueryCircuits over the default arities' IVC set (entering as its
         digest, shape and height) at MergedTableIndexer's defaults: four
         columns, row and index tree depth 4, no tabular rows.

Nothing is proved.  Each part rewrites only its own key of the file.

Usage (from the repo root; `host` takes seconds, `sets` about half an hour
on a CPU at each arity, `query` about five minutes after `sets` at the
default arities):

    JAX_PLATFORMS=cpu python tools/make_merged_golden.py [host] [sets[:1,2]] [query]
"""

import fcntl
import json
import os
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TESTDATA = os.path.join(REPO, "mp2_tpu_torch", "testdata")
GOLDEN = os.path.join(TESTDATA, "merged_golden.json")
CONTRACT = bytes(range(20))
CHAIN_ID = 1
SLOT = 4
SINGLE_SLOT = 9
BLOCKS = [{b"\x11": 100, b"\x22": 250}, {b"\x11": 120, b"\x22": 250}]
SUPPLY = [350, 370]
FIRST_BLOCK = 100
DEFAULT_ARITIES = (1, 2, 3)
QUERY = ("SELECT SUM(value), MAX(supply) FROM t WHERE block >= $MIN_BLOCK AND "
         "block <= $MAX_BLOCK", {"$MIN_BLOCK": 100, "$MAX_BLOCK": 101})
QUERY_PARAMS = {"num_columns": 4, "num_placeholders": 4, "num_predicate_ops": 4,
                "num_result_ops": 2, "num_outputs": 2}
TREE_DEPTH = 4
TABULAR_ROWS = 0


def _load(name):
    with open(os.path.join(TESTDATA, name)) as f:
        return json.load(f)


def _chain():
    from mp2_tpu.models.pipeline import MergedTableConfig, make_chain

    cfg = MergedTableConfig(contract_address=CONTRACT, chain_id=CHAIN_ID, slot=SLOT,
                            single_slot=SINGLE_SLOT)
    blocks = make_chain(cfg, BLOCKS, start_block=FIRST_BLOCK, single_values=SUPPLY)
    assert [b.number for b in blocks] == [100, 101]
    return cfg, blocks


def _ints(xs):
    return [int(v) for v in xs]


def _set_record(fw):
    return {
        "set_digest": _ints(fw.set_digest),
        "standard_n": fw.standard.n,
        "member_order": list(fw.member_order),
        "members": {
            name: {
                "digest": _ints(fw.members[name].digest),
                "circuit_digest": _ints(fw.members[name].data.circuit_digest),
                "n": fw.members[name].data.n,
                "wrap_chain_n": [fw.members[name].data.n]
                + [wc.data.n for wc in fw._wrap_chain_for(fw.members[name].data)],
            }
            for name in fw.member_order
        },
    }


def _timed(name, fn):
    t0, c0 = time.perf_counter(), time.process_time()
    out = fn()
    print(f"  {name}: {time.perf_counter() - t0:.1f} s wall, "
          f"{time.process_time() - c0:.1f} s CPU", flush=True)
    return out


def _finalized(set_digest, standard, set_height):
    """What a cross-set verifier reads of a finalized set (recursion/
    runtime.py add_aggregation_circuit): its digest, shape and height."""
    return SimpleNamespace(circuit_set=True, set_digest=tuple(int(v) for v in set_digest),
                           standard=standard, set_height=set_height)


def _recorders():
    """tests/test_torch_merged_table.py, whose stand-ins record what the
    merged indexer asks each circuit set to prove."""
    import importlib.util

    sys.path.insert(0, os.path.join(REPO, "tests"))  # its own import of test_torch_pipeline
    path = os.path.join(REPO, "tests", "test_torch_merged_table.py")
    spec = importlib.util.spec_from_file_location("_merged_recorders", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host():
    rec = _recorders()
    cfg, blocks = _chain()
    out = {
        "table": {"contract_address": CONTRACT.hex(), "chain_id": CHAIN_ID, "slot": SLOT,
                  "single_slot": SINGLE_SLOT, "key_id": int(cfg.key_id),
                  "value_id": int(cfg.value_id), "supply_id": int(cfg.supply_id),
                  "block_id": int(cfg.block_id)},
        "blocks": [{k.hex(): v for k, v in e.items()} for e in BLOCKS],
        "supply": SUPPLY,
        "host_models": [rec.host_models("ref", blk) for blk in blocks],
    }
    ix, log, indexed = rec.indexed_blocks("ref")
    out["blocks_100_101"] = indexed
    out["query"] = rec.run_merged_query("ref", ix, log)
    return out


def sets(arities=DEFAULT_ARITIES):
    from mp2_tpu.extraction.circuits import fixture_header_offsets
    from mp2_tpu.extraction.final_circuits import EXT_W, FinalExtractionCircuits
    from mp2_tpu.extraction.mpt_circuits import ValuesExtractionCircuits
    from mp2_tpu.prover.config import test_config
    from mp2_tpu.recursion.runtime import RecursionFramework
    from mp2_tpu.recursion.wrap import discover_standard
    from mp2_tpu.vdb import circuits as C

    cfg, blocks = _chain()
    xg, fg = _load("extraction_golden.json"), _load("final_extraction_golden.json")
    light = _load("vdb_golden.json")["light"]
    pg = _load("pipeline_golden.json")["sets"]
    assert fixture_header_offsets(blocks[0].header_rlp) == fg["host"]["header_offsets"]
    ext_standard, _ = discover_standard(test_config(), EXT_W + 4)
    assert ext_standard.n == xg["set"]["standard_n"] == fg["sets"]["final"]["standard_n"]
    bx = SimpleNamespace(fw=_finalized(fg["sets"]["block"]["set_digest"], ext_standard, 1))
    cx = SimpleNamespace(fw=_finalized(fg["sets"]["contract"]["set_digest"], ext_standard, 2))
    out = {"branch_arities": list(arities)}
    if tuple(arities) == tuple(xg["set"]["branch_arities"]):
        # mp2_tpu/extraction/mpt_circuits.py:787-788's height for its members
        height = max(1, (len(xg["set"]["member_order"]) - 1).bit_length())
        vx = SimpleNamespace(fw=_finalized(xg["set"]["set_digest"], ext_standard, height))
    else:
        vx = _timed("values set (mapping)", lambda: ValuesExtractionCircuits(
            [cfg.column], cfg.value_id, config=test_config(), mapping=(SLOT, cfg.key_id),
            branch_arities=arities))
        out["vx"] = _set_record(vx.fw)
    vx_b = _timed("values set (single slot)", lambda: ValuesExtractionCircuits(
        [cfg.single_column], cfg.supply_id, config=test_config(), branch_arities=arities))
    out["vx_b"] = _set_record(vx_b.fw)
    fx = _timed("final set (merged)", lambda: FinalExtractionCircuits(
        bx, cx, vx, config=test_config(), merge_with=vx_b))
    out["fx"] = _set_record(fx.fw)
    if "vx" not in out:
        assert (out["fx"]["members"]["final_simple"]
                == fg["sets"]["final"]["members"]["final_simple"])

    def block_and_ivc():
        # vdb/circuits.VerifiableDbCircuits's block and IVC sets over `fx`,
        # the rows set entering as its digest, shape and height
        rows_standard, _ = discover_standard(test_config(), C.NUM_USER_PIS + 4)
        assert rows_standard.n == light["rows"]["standard_n"]
        rows = _finalized(light["rows"]["set_digest"], rows_standard, 2)
        block = RecursionFramework(test_config(), C.NUM_USER_PIS, set_height=2)
        block.add_aggregation_circuit("block_leaf", 0, C._build_block_leaf, foreign=[rows])
        block.add_aggregation_circuit("block_leaf_bound", 0, C._build_block_leaf_bound,
                                      foreign=[rows, fx.fw])
        block.add_aggregation_circuit("block_parent", 2, C._build_block_parent,
                                      foreign=[rows])
        block.add_aggregation_circuit("block_parent_bound", 2, C._build_block_parent_bound,
                                      foreign=[rows, fx.fw])
        block.finalize()
        ivc = RecursionFramework(test_config(), C.NUM_USER_PIS, set_height=1)
        ivc.add_aggregation_circuit("ivc_first", 0, C._build_ivc_first, foreign=[block])
        ivc.add_aggregation_circuit("ivc_subsequent", 1, C._build_ivc_subsequent,
                                    foreign=[block])
        ivc.finalize()
        return block, ivc

    block, ivc = _timed("verifiable DB block and IVC sets", block_and_ivc)
    out["block"], out["ivc"] = _set_record(block), _set_record(ivc)
    for m in ("block_leaf", "block_parent"):
        assert out["block"]["members"][m] == pg["block"]["members"][m]
    return out


def query():
    from mp2_tpu.prover.config import test_config
    from mp2_tpu.recursion.wrap import discover_standard
    from mp2_tpu.vdb.circuits import NUM_USER_PIS
    from mp2_tpu.vdb.query.chunks import QueryCircuits
    from mp2_tpu.vdb.query.universal import UniversalQueryParams

    with open(GOLDEN) as f:
        ivc_rec = json.load(f)[_sets_key(DEFAULT_ARITIES)]["ivc"]
    standard, _ = discover_standard(test_config(), NUM_USER_PIS + 4)
    assert standard.n == ivc_rec["standard_n"]
    ivc = _finalized(ivc_rec["set_digest"], standard, 1)
    qc = _timed("query sets", lambda: QueryCircuits(
        test_config(), UniversalQueryParams(**QUERY_PARAMS), ivc_framework=ivc,
        row_tree_depth=TREE_DEPTH, index_tree_depth=TREE_DEPTH, tabular_rows=TABULAR_ROWS))
    return {"params": dict(QUERY_PARAMS, row_tree_depth=TREE_DEPTH,
                           index_tree_depth=TREE_DEPTH, tabular_rows=TABULAR_ROWS),
            "row": _set_record(qc.row), "chunk": _set_record(qc.chunk),
            "revelation": _set_record(qc.revelation)}


def _sets_key(arities):
    return "sets_" + "_".join(str(a) for a in arities)


def _part(arg):
    """(key in the file, function) of one command-line part."""
    name, _, spec = arg.partition(":")
    if name == "sets":
        arities = tuple(int(a) for a in spec.split(",")) if spec else DEFAULT_ARITIES
        return _sets_key(arities), lambda: sets(arities)
    return name, {"host": host, "query": query}[name]


def main(args):
    for arg in args or ["host", "sets", "query"]:
        key, fn = _part(arg)
        print(f"{key}:", flush=True)
        t0, c0 = time.perf_counter(), time.process_time()
        part = fn()
        print(f"{key}: {time.perf_counter() - t0:.1f} s wall, "
              f"{time.process_time() - c0:.1f} s CPU", flush=True)
        with open(__file__) as lock:  # another part may run beside this one
            fcntl.flock(lock, fcntl.LOCK_EX)
            rec = {}
            if os.path.exists(GOLDEN):
                with open(GOLDEN) as f:
                    rec = json.load(f)
            rec[key] = part
            with open(GOLDEN, "w") as f:
                json.dump(rec, f, indent=1, sort_keys=True)
                f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
