"""Write mp2_tpu_torch/testdata/final_extraction_golden.json from the JAX package.

The PyTorch port's contract, block and final extraction sets
(`extraction/final_circuits.py`) are held against `mp2_tpu`.  Their
members have 2^14 to 2^16 rows, and a recursive proof from the JAX package
takes minutes on a CPU, so `chip_smoke.py` and the tests compare the port
with what this script records once, on the CPU, for the mapping table of
tools/make_extraction_golden.py (contract bytes(range(20)), chain 1, slot
4) and blocks 100 and 101 as mp2_tpu/models/pipeline.make_chain builds
them (entries {0x11: 100, 0x22: 200}, then {0x11: 150, 0x22: 200, 0x33:
50}):

  host     block 101's host outputs: `extract_block` of its header,
           `extract_contract` of its state trie, `final_extraction` over
           those and `extract_storage_slots` of its storage trie, the final
           public inputs `final_pi_values` gives for them, the header
           offsets, and the metadata hash `block_metadata_hash(DM, block
           id)`, which must equal `metadata.metadata_hash` of the table;
  sets     the sets mp2_tpu/models/circuit_pipeline.py:132-145 builds:
           ContractExtractionCircuits(contract), BlockExtractionFramework
           over block 101's header offsets and FinalExtractionCircuits over
           them and the values set (which is built for it): for each, the
           set digest, the standard n, and for each member its digest, its
           circuit digest and degree, and its wrap chain;
  proofs   the `account_leaf` proof of block 101's state path (its state
           trie holds one account) and the header proof of block 101, each
           wrapped to the standard shape: public inputs and the sha256 of
           the proof (`proof_to_dict`).

The storage trie is not proved here (the values set and one leaf take ~27
minutes, tools/make_extraction_golden.py), so there is no `final_simple`
proof to record: the port's is held to these public inputs and to its own
verifier.

Usage (from the repo root; `sets` takes ~30 minutes on a CPU, most of it
the values set, and `proofs` about as long; the two may run side by side,
each rewrites only its own part of the file):

    JAX_PLATFORMS=cpu python tools/make_final_extraction_golden.py [host] [sets] [proofs]
"""

import fcntl
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "final_extraction_golden.json")
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
    return cfg, blocks[-1]


def _set_record(fw):
    return {
        "set_digest": [int(v) for v in fw.set_digest],
        "standard_n": fw.standard.n,
        "member_order": list(fw.member_order),
        "members": {
            name: {
                "digest": [int(v) for v in fw.members[name].digest],
                "circuit_digest": [int(v) for v in fw.members[name].data.circuit_digest],
                "n": fw.members[name].data.n,
                "wrap_chain_n": [fw.members[name].data.n]
                + [wc.data.n for wc in fw._wrap_chain_for(fw.members[name].data)],
            }
            for name in fw.member_order
        },
    }


def _env_record(env, pis):
    from mp2_tpu.prover.serde import proof_to_dict
    from mp2_tpu_torch.prover.serde import proof_sha256

    return {"member": env.member,
            "public_inputs": [int(v) for v in env.public_inputs],
            "user_public_inputs": [int(v) for v in pis],
            "proof_sha256": proof_sha256(proof_to_dict(env.proof))}


def host():
    from mp2_tpu.extraction import metadata as M
    from mp2_tpu.extraction import storage_key as SK
    from mp2_tpu.extraction.api import (SlotEntry, extract_block, extract_contract,
                                        extract_storage_slots, final_extraction)
    from mp2_tpu.extraction.circuits import fixture_header_offsets
    from mp2_tpu.extraction.final_circuits import final_pi_values
    from mp2_tpu.extraction.mpt_circuits import mpt_pi_values
    from mp2_tpu.utils.u256 import pack_bytes_be
    from mp2_tpu.vdb import digests as D

    cfg, blk = _chain()
    values = extract_storage_slots(blk.storage, [cfg.column], [
        SlotEntry(SLOT, SK.mapping_location(SLOT, k), mapping_key=k, key_id=cfg.key_id)
        for k in sorted(blk.entries)])
    block = extract_block(blk.header_rlp)
    contract = extract_contract(blk.state, CONTRACT)
    final = final_extraction(block, contract, values, blk.storage.root_hash(),
                             blk.state.root_hash())
    block_pis = (pack_bytes_be(block.block_hash) + pack_bytes_be(block.parent_hash)
                 + pack_bytes_be(block.state_root) + [block.block_number])
    values_pis = mpt_pi_values(values.node_hash, values.values_digest,
                               values.metadata_digest, values.n_leaves)
    md_hash = D.block_metadata_hash(final.metadata_digest, cfg.block_id)
    table = M.SlotInputs.mapping([M.SlotInput(SLOT)])
    assert tuple(md_hash) == tuple(M.metadata_hash(table, CONTRACT, CHAIN_ID))
    return {
        "table": {"contract_address": CONTRACT.hex(), "chain_id": CHAIN_ID, "slot": SLOT,
                  "key_id": int(cfg.key_id), "value_id": int(cfg.value_id),
                  "block_id": int(cfg.block_id)},
        "blocks": [{k.hex(): v for k, v in e.items()} for e in BLOCKS],
        "block_number": blk.number,
        "header_rlp": blk.header_rlp.hex(),
        "header_offsets": fixture_header_offsets(blk.header_rlp),
        "extract_block": {"block_hash": block.block_hash.hex(),
                          "parent_hash": block.parent_hash.hex(),
                          "state_root": block.state_root.hex(),
                          "block_number": block.block_number},
        "extract_contract": {"node_hash": contract.node_hash.hex(),
                             "storage_root": contract.storage_root.hex(),
                             "metadata_digest": [int(v) for v in
                                                 contract.metadata_digest.to_fields()]},
        "final_extraction": {"block_hash": final.block_hash.hex(),
                             "prev_block_hash": final.prev_block_hash.hex(),
                             "block_number": final.block_number,
                             "values_digest": [int(v) for v in
                                               final.values_digest.to_fields()],
                             "metadata_digest": [int(v) for v in
                                                 final.metadata_digest.to_fields()],
                             "is_merge": final.is_merge},
        "final_public_inputs": [int(v) for v in final_pi_values(
            block_pis, values_pis, contract.metadata_digest)],
        "metadata_hash": [int(v) for v in md_hash],
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

    cfg, blk = _chain()
    vx = _timed("values set", lambda: ValuesExtractionCircuits(
        [cfg.column], cfg.value_id, config=test_config(), mapping=(SLOT, cfg.key_id),
        branch_arities=BRANCH_ARITIES))
    cx = _timed("contract set", lambda: ContractExtractionCircuits(
        CONTRACT, config=test_config()))
    bx = _timed("block set", lambda: BlockExtractionFramework(
        config=test_config(), **fixture_header_offsets(blk.header_rlp)))
    fx = _timed("final set", lambda: FinalExtractionCircuits(bx, cx, vx,
                                                             config=test_config()))
    return {"values_set_digest": [int(v) for v in vx.fw.set_digest],
            "contract": _set_record(cx.fw), "block": _set_record(bx.fw),
            "final": _set_record(fx.fw)}


def proofs():
    from mp2_tpu.extraction.circuits import fixture_header_offsets
    from mp2_tpu.extraction.final_circuits import (BlockExtractionFramework,
                                                   ContractExtractionCircuits)
    from mp2_tpu.prover.config import test_config

    _, blk = _chain()
    cx = _timed("contract set", lambda: ContractExtractionCircuits(
        CONTRACT, config=test_config()))
    bx = _timed("block set", lambda: BlockExtractionFramework(
        config=test_config(), **fixture_header_offsets(blk.header_rlp)))
    path = blk.state.get_proof(CONTRACT)
    assert len(path) == 1, "the pipeline's state trie holds one account"
    c_env, c_pis = _timed("account_leaf proof", lambda: cx.prove_state_path(path))
    assert cx.verify(c_env)
    b_env, b_pis = _timed("header proof", lambda: bx.prove_header(blk.header_rlp))
    assert bx.verify(b_env)
    return {"account_leaf": _env_record(c_env, c_pis), "header": _env_record(b_env, b_pis)}


PARTS = {"host": host, "sets": sets, "proofs": proofs}


def main(names):
    for name in names or list(PARTS):
        print(f"{name}:", flush=True)
        t0, c0 = time.perf_counter(), time.process_time()
        part = PARTS[name]()
        print(f"{name}: {time.perf_counter() - t0:.1f} s wall, "
              f"{time.process_time() - c0:.1f} s CPU", flush=True)
        with open(__file__) as lock:  # other parts may run beside this one
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
