"""Write mp2_tpu_torch/testdata/pipeline_golden.json from the JAX package.

The PyTorch port's indexing half of `models/circuit_pipeline.CircuitTableIndexer`
and the extraction-bound members of the block set (`block_leaf_bound`,
`block_parent_bound`) are held against `mp2_tpu`.  A recursive proof from the
JAX package takes minutes on a CPU and its `final_simple` is out of reach,
so `chip_smoke.py` and the tests compare the port with what this script
records once, on the CPU, for the mapping table of
tools/make_final_extraction_golden.py (contract bytes(range(20)), chain 1,
slot 4) and blocks 100 and 101 as mp2_tpu/models/pipeline.make_chain builds
them:

  host   the host models' values of the indexer (the rows tree, the block
         tree and the IVC step of mp2_tpu/models/circuit_pipeline.py:182-340,
         computed with mp2_tpu's ryhope, vdb and extraction host models,
         without proving): for block 101 applied as the indexer's first
         block and for blocks 100 then 101, each block's rows plan (each
         node's key, member and public inputs, in proving order), the rows
         root's public inputs, the rows digest (which must equal the final
         extraction's DV), the block plan (key, member, whether it has a
         right child, public inputs), the metadata hash and the IVC step's
         member and public inputs;
  sets   VerifiableDbCircuits(test_config(), extraction=fx) over the sets
         mp2_tpu/models/circuit_pipeline.py:132-146 builds: the block set
         (with `block_leaf_bound` and `block_parent_bound`) and the IVC set
         over it, each with its set digest, standard n, member order and,
         per member, its digest, circuit digest, rows and wrap chain; the
         cells and rows sets are checked equal to vdb_golden.json's light
         ones (they do not depend on the extraction).

  query  the query side of the indexer at tests/test_circuit_pipeline.py's
         parameters (the default UniversalQueryParams, row and index tree
         depth 4, two tabular rows): QueryCircuits(test_config(), ...,
         ivc_framework=<the IVC set of `sets`>), each of its row, chunk
         and revelation sets with the record `sets` keeps; then block 101
         applied as the indexer's first block and the flagship test's
         three queries (an aggregate over [100, 101], the same over the
         empty range [200, 210], a tabular DISTINCT ... LIMIT 2) through
         `run_query` over the recording stand-ins of
         tests/test_torch_pipeline.py: each query's QueryResult and the
         (set, member, user PIs) of every proof it asks for, in order.
         The revelation members verify the IVC set only through its set
         digest, standard shape and set height, so the IVC set enters as
         those three values, the digest read from the `sets` record.

Nothing is proved: `block_leaf_bound` on the card is held to these public
inputs, these set digests and the port's own verifier.

Usage (from the repo root; `host` takes seconds, `sets` about half an
hour on a CPU, most of it the values and final sets, `query` about five
minutes and needs `sets` first; each part rewrites only its own key of the
file):

    JAX_PLATFORMS=cpu python tools/make_pipeline_golden.py [host] [sets] [query]
"""

import fcntl
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "pipeline_golden.json")
VDB_GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "vdb_golden.json")
CONTRACT = bytes(range(20))
CHAIN_ID = 1
SLOT = 4
BLOCKS = [{b"\x11": 100, b"\x22": 200}, {b"\x11": 150, b"\x22": 200, b"\x33": 50}]
FIRST_BLOCK = 100
BRANCH_ARITIES = (1, 2, 3)


def _chain():
    from mp2_tpu.models.pipeline import MappingTableConfig, make_chain

    cfg = MappingTableConfig(contract_address=CONTRACT, chain_id=CHAIN_ID, slot=SLOT)
    blocks = make_chain(cfg, BLOCKS, start_block=FIRST_BLOCK)
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


def _final_dm(cfg, blk):
    """The final extraction's DM of a block (the host models)."""
    from mp2_tpu.extraction import storage_key as SK
    from mp2_tpu.extraction.api import (SlotEntry, extract_block, extract_contract,
                                        extract_storage_slots, final_extraction)

    values = extract_storage_slots(blk.storage, [cfg.column], [
        SlotEntry(SLOT, SK.mapping_location(SLOT, k), mapping_key=k, key_id=cfg.key_id)
        for k in sorted(blk.entries)])
    final = final_extraction(extract_block(blk.header_rlp),
                             extract_contract(blk.state, CONTRACT), values,
                             blk.storage.root_hash(), blk.state.root_hash())
    return final


def _apply(cfg, blocks):
    """The indexer's host steps for each block in turn: what
    CircuitTableIndexer.apply_block proves, without proving."""
    from mp2_tpu.extraction import values as V
    from mp2_tpu.vdb import circuits as C
    from mp2_tpu.vdb import digests as D
    from mp2_tpu.vdb.trees import (BlockPayload, Cell, RowPayload, build_cells_tree,
                                   new_block_tree, new_row_tree)

    rows_db, block_db = new_row_tree(), new_block_tree()
    md0, out = None, []
    for blk in blocks:
        final = _final_dm(cfg, blk)

        def tx(t):
            for k, v in blk.entries.items():
                key_int = int.from_bytes(k, "big")
                t.store((key_int, 0), RowPayload(
                    secondary=Cell(cfg.key_id, key_int, False),
                    row_unique_data=V.row_unique_data_for_mapping_leaf(k),
                    cells=build_cells_tree([Cell(cfg.value_id, v, False)])))
            for key in list(rows_db.payloads):
                if not any(int.from_bytes(k, "big") == key[0] for k in blk.entries):
                    t.remove(key)

        rows_plan = []
        for key in rows_db.in_transaction(tx).into_workplan():
            l, r = rows_db.tree.children(key)
            kids = [c for c in (l, r) if c is not None]
            rows_plan.append({"key": list(key),
                              "member": ("rows_leaf", "rows_partial", "rows_full")[len(kids)],
                              "public_inputs": _ints(C.rows_pi_values(rows_db.payload(key)))})
        root_pl = rows_db.payload(rows_db.root())
        rows_digest = D.compute_final_digest(False, root_pl.individual_vd,
                                             root_pl.multiplier_vd, root_pl.multiplier_cnt)
        assert rows_digest == final.values_digest, "extraction DV != rows digest"
        node = BlockPayload(index_id=cfg.block_id, block_number=blk.number,
                            rows_hash=root_pl.hash, rows_digest=rows_digest)
        block_plan = []
        for key in block_db.in_transaction(lambda t: t.store(blk.number, node)).into_workplan():
            l, r = block_db.tree.children(key)
            bound = key == blk.number
            member = ("block_leaf" if l is None and r is None else "block_parent") + (
                "_bound" if bound else "")
            block_plan.append({"key": key, "member": member, "has_right": r is not None,
                               "public_inputs": _ints(C.block_pi_values(
                                   block_db.payload(key)))})
        md = D.block_metadata_hash(final.metadata_digest, cfg.block_id)
        root_hash = block_db.payload(block_db.root()).hash
        out.append({
            "block_number": blk.number,
            "rows_plan": rows_plan,
            "rows_root_key": list(rows_db.root()),
            "rows_root_public_inputs": _ints(C.rows_pi_values(root_pl)),
            "rows_digest": _ints(rows_digest.to_fields()),
            "final_values_digest": _ints(final.values_digest.to_fields()),
            "block_plan": block_plan,
            "block_root_key": block_db.root(),
            "metadata_hash": _ints(md),
            "ivc_member": "ivc_first" if md0 is None else "ivc_subsequent",
            "ivc_public_inputs": _ints(C.ivc_pi_values(root_hash, md, blk.number)),
        })
        md0 = md0 or md
        assert md == md0, "metadata hash changed"
    return out


def host():
    cfg, blocks = _chain()
    return {
        "table": {"contract_address": CONTRACT.hex(), "chain_id": CHAIN_ID, "slot": SLOT,
                  "key_id": int(cfg.key_id), "value_id": int(cfg.value_id),
                  "block_id": int(cfg.block_id)},
        "blocks": [{k.hex(): v for k, v in e.items()} for e in BLOCKS],
        "block_101_first": _apply(cfg, blocks[1:])[0],
        "blocks_100_101": _apply(cfg, blocks),
    }


def _timed(name, fn):
    t0, c0 = time.perf_counter(), time.process_time()
    out = fn()
    print(f"  {name}: {time.perf_counter() - t0:.1f} s wall, "
          f"{time.process_time() - c0:.1f} s CPU", flush=True)
    return out


def sets():
    from mp2_tpu.extraction.circuits import fixture_header_offsets
    from mp2_tpu.extraction.final_circuits import (BlockExtractionFramework,
                                                   ContractExtractionCircuits,
                                                   FinalExtractionCircuits)
    from mp2_tpu.extraction.mpt_circuits import ValuesExtractionCircuits
    from mp2_tpu.prover.config import test_config
    from mp2_tpu.vdb.circuits import VerifiableDbCircuits

    cfg, blocks = _chain()
    header = blocks[-1].header_rlp
    vx = _timed("values set", lambda: ValuesExtractionCircuits(
        [cfg.column], cfg.value_id, config=test_config(), mapping=(SLOT, cfg.key_id),
        branch_arities=BRANCH_ARITIES))
    cx = _timed("contract set", lambda: ContractExtractionCircuits(
        CONTRACT, config=test_config()))
    bx = _timed("block set", lambda: BlockExtractionFramework(
        config=test_config(), **fixture_header_offsets(header)))
    fx = _timed("final set", lambda: FinalExtractionCircuits(bx, cx, vx,
                                                             config=test_config()))
    vdb = _timed("verifiable DB sets", lambda: VerifiableDbCircuits(test_config(),
                                                                     extraction=fx))
    with open(VDB_GOLDEN) as f:
        light = json.load(f)["light"]
    for name in ("cells", "rows"):
        fw, g = getattr(vdb, name), light[name]
        rec = _set_record(fw)
        assert rec["set_digest"] == g["set_digest"] and rec["standard_n"] == g["standard_n"]
        assert {m: r["digest"] for m, r in rec["members"].items()} == g["member_digests"]
        assert {m: r["wrap_chain_n"] for m, r in rec["members"].items()} == g["wrap_chain_n"]
    return {"final_set_digest": _ints(fx.fw.set_digest),
            "cells_and_rows_equal_vdb_golden_light": True,
            "block": _set_record(vdb.block), "ivc": _set_record(vdb.ivc)}


QUERIES = [
    ("aggregate", "SELECT SUM(value), COUNT(*) FROM t WHERE block >= $MIN_BLOCK "
     "AND block <= $MAX_BLOCK", {"$MIN_BLOCK": 100, "$MAX_BLOCK": 101}),
    ("empty_range", "SELECT SUM(value), COUNT(*) FROM t WHERE block >= $MIN_BLOCK "
     "AND block <= $MAX_BLOCK", {"$MIN_BLOCK": 200, "$MAX_BLOCK": 210}),
    ("tabular", "SELECT DISTINCT value FROM t WHERE block >= $MIN_BLOCK AND "
     "block <= $MAX_BLOCK AND value >= 150 LIMIT 2", {"$MIN_BLOCK": 100, "$MAX_BLOCK": 101}),
]
QUERY_PARAMS = {"num_columns": 3, "num_placeholders": 4, "num_predicate_ops": 4,
                "num_result_ops": 2, "num_outputs": 2}
TREE_DEPTH = 4
TABULAR_ROWS = 2


def _recorders():
    """tests/test_torch_pipeline.py, whose stand-ins record what the indexer
    asks each circuit set to prove."""
    import importlib.util

    path = os.path.join(REPO, "tests", "test_torch_pipeline.py")
    spec = importlib.util.spec_from_file_location("_pipeline_recorders", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def query_result_record(res):
    return {"rows": [_ints(r) for r in res.rows],
            "num_matching_rows": int(res.num_matching_rows), "overflow": bool(res.overflow),
            "computational_hash": _ints(res.computational_hash),
            "placeholder_hash": _ints(res.placeholder_hash),
            "chunks": [[list(k) for k in c] for c in res.chunks]}


def run_queries(rec, pkg):
    """Block 101 as the first block through `pkg`'s indexer over the
    recording stand-ins, then the three queries: per query its result,
    its calls (set, member, user PIs) and the revealed values."""
    from mp2_tpu.vdb.query.ops import Placeholders as JPlaceholders
    from mp2_tpu_torch.vdb.query.ops import Placeholders

    ph = {"port": Placeholders, "ref": JPlaceholders}[pkg]
    ix, log, _ = rec._indexer(pkg, rec.SCRIPT_ADDR, 101, queries=True)
    out = {}
    for name, sql, values in QUERIES:
        start = len(log.calls)
        res, env, reveal = ix.run_query(sql, ph(dict(values)))
        out[name] = {"sql": sql, "placeholders": values, "result": query_result_record(res),
                     "calls": [{"set": c["set"], "member": c["member"], "user_pis": c["pis"]}
                               for c in log.calls[start:]],
                     "member": env.member, "reveal": _ints(reveal)}
    return out


def query():
    from mp2_tpu.prover.config import test_config
    from mp2_tpu.recursion.wrap import discover_standard
    from mp2_tpu.vdb.circuits import NUM_USER_PIS
    from mp2_tpu.vdb.query.chunks import QueryCircuits
    from mp2_tpu.vdb.query.universal import UniversalQueryParams

    with open(GOLDEN) as f:
        ivc_rec = json.load(f)["sets"]["ivc"]
    standard, _ = discover_standard(test_config(), NUM_USER_PIS + 4)
    assert standard.n == ivc_rec["standard_n"]
    # what a cross-set verifier reads of the IVC set (recursion/runtime.py
    # add_aggregation_circuit): a finalized set, its digest, shape, height
    ivc = type("IvcSet", (), {"circuit_set": True, "set_digest": ivc_rec["set_digest"],
                              "standard": standard, "set_height": 1})()
    qc = _timed("query sets", lambda: QueryCircuits(
        test_config(), UniversalQueryParams(**QUERY_PARAMS), ivc_framework=ivc,
        row_tree_depth=TREE_DEPTH, index_tree_depth=TREE_DEPTH,
        tabular_rows=TABULAR_ROWS))
    queries = _timed("queries", lambda: run_queries(_recorders(), "ref"))
    return {"params": dict(QUERY_PARAMS, row_tree_depth=TREE_DEPTH,
                           index_tree_depth=TREE_DEPTH, tabular_rows=TABULAR_ROWS),
            "row": _set_record(qc.row), "chunk": _set_record(qc.chunk),
            "revelation": _set_record(qc.revelation),
            "block_101_first": queries}


PARTS = {"host": host, "sets": sets, "query": query}


def main(names):
    for name in names or list(PARTS):
        print(f"{name}:", flush=True)
        t0, c0 = time.perf_counter(), time.process_time()
        part = PARTS[name]()
        print(f"{name}: {time.perf_counter() - t0:.1f} s wall, "
              f"{time.process_time() - c0:.1f} s CPU", flush=True)
        with open(__file__) as lock:  # the other part may run beside this one
            fcntl.flock(lock, fcntl.LOCK_EX)
            rec = {}
            if os.path.exists(GOLDEN):
                with open(GOLDEN) as f:
                    rec = json.load(f)
            rec[name] = part
            with open(GOLDEN, "w") as f:
                json.dump(rec, f, indent=1, sort_keys=True)
                f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
