"""Write mp2_tpu_torch/testdata/extraction_golden.json from the JAX package.

The PyTorch port's values extraction over a storage trie
(`extraction/mpt_circuits.ValuesExtractionCircuits`) is held against
`mp2_tpu`.  Its members have 2^16 rows, and a recursive proof from the JAX
package takes minutes on a CPU, so `chip_smoke.py` and the tests compare
the port with what this script records once, on the CPU:

  table    the mapping table of tests/test_circuit_pipeline.py:30
           (contract bytes(range(20)), chain 1, slot 4) with its key and
           value column identifiers, derived as mp2_tpu/models/pipeline.py
           derives them;
  set      ValuesExtractionCircuits([column], value_id, test_config(),
           mapping=(slot, key_id), branch_arities=(1, 2, 3)), as
           mp2_tpu/models/circuit_pipeline.py:132-136 builds it: the set
           digest, the standard n, and for each member its digest (the
           wrapped circuit's), the circuit digest and degree of the member
           itself, and its wrap chain;
  trie     block 101's storage trie as mp2_tpu/models/pipeline.make_chain
           builds it (keys 0x11, 0x22, 0x33 with values 150, 200, 50, and
           the unrelated leaf): its root hash, and the public inputs
           H | DV | DM | N that the host model `extract_storage_slots`
           gives for its three entries, packed as `mpt_pi_values` packs
           them;
  leaf     the `leaf_mapping` proof of the 0x11 entry, wrapped to the
           set's standard shape: its public inputs and the sha256 of its
           proof (`proof_to_dict`).

Usage (from the repo root; about half an hour on a CPU, most of it the
set-up and the leaf's proof):

    JAX_PLATFORMS=cpu python tools/make_extraction_golden.py
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "extraction_golden.json")
CONTRACT = bytes(range(20))
CHAIN_ID = 1
SLOT = 4
ENTRIES = {b"\x11": 150, b"\x22": 200, b"\x33": 50}  # block 101 of the pipeline test
BLOCK = 101
BRANCH_ARITIES = (1, 2, 3)
LEAF_KEY = b"\x11"


def main():
    from mp2_tpu.extraction import storage_key as SK
    from mp2_tpu.extraction.api import SlotEntry, extract_storage_slots
    from mp2_tpu.extraction.mpt_circuits import ValuesExtractionCircuits, mpt_pi_values
    from mp2_tpu.models.pipeline import MappingTableConfig, make_chain
    from mp2_tpu.prover.config import test_config
    from mp2_tpu.prover.serde import proof_to_dict
    from mp2_tpu_torch.prover.serde import proof_sha256

    cfg = MappingTableConfig(contract_address=CONTRACT, chain_id=CHAIN_ID, slot=SLOT)
    (blk,) = make_chain(cfg, [ENTRIES], start_block=BLOCK)
    assert blk.number == BLOCK and blk.entries == ENTRIES
    trie = blk.storage

    entries = [SlotEntry(SLOT, SK.mapping_location(SLOT, k), mapping_key=k,
                         key_id=cfg.key_id) for k in sorted(ENTRIES)]
    out = extract_storage_slots(trie, [cfg.column], entries)
    host_pis = mpt_pi_values(out.node_hash, out.values_digest, out.metadata_digest,
                             out.n_leaves)

    t0, c0 = time.perf_counter(), time.process_time()
    vx = ValuesExtractionCircuits([cfg.column], cfg.value_id, config=test_config(),
                                  mapping=(SLOT, cfg.key_id),
                                  branch_arities=BRANCH_ARITIES)
    fw = vx.fw
    print(f"set-up: {time.perf_counter() - t0:.1f} s wall, "
          f"{time.process_time() - c0:.1f} s CPU", flush=True)
    members = {
        name: {
            "digest": [int(v) for v in fw.members[name].digest],
            "circuit_digest": [int(v) for v in fw.members[name].data.circuit_digest],
            "n": fw.members[name].data.n,
            "wrap_chain_n": [fw.members[name].data.n]
            + [wc.data.n for wc in fw._wrap_chain_for(fw.members[name].data)],
        }
        for name in fw.member_order
    }

    t0, c0 = time.perf_counter(), time.process_time()
    leaf_body = trie.get_proof(SK.mapping_location(SLOT, LEAF_KEY))[-1]
    env, pis = vx.prove_leaf_mapping(leaf_body, LEAF_KEY)
    assert vx.verify(env)
    print(f"leaf: {time.perf_counter() - t0:.1f} s wall, "
          f"{time.process_time() - c0:.1f} s CPU", flush=True)

    rec = {
        "table": {"contract_address": CONTRACT.hex(), "chain_id": CHAIN_ID,
                  "slot": SLOT, "key_id": int(cfg.key_id),
                  "value_id": int(cfg.value_id)},
        "set": {"branch_arities": list(BRANCH_ARITIES),
                "set_digest": [int(v) for v in fw.set_digest],
                "standard_n": fw.standard.n, "member_order": list(fw.member_order),
                "members": members},
        "trie": {"block": BLOCK,
                 "entries": {k.hex(): v for k, v in ENTRIES.items()},
                 "unrelated_value": 7,
                 "root_hash": trie.root_hash().hex(),
                 "host_root_public_inputs": [int(v) for v in host_pis]},
        "leaf": {"key": LEAF_KEY.hex(), "member": env.member,
                 "public_inputs": [int(v) for v in env.public_inputs],
                 "user_public_inputs": [int(v) for v in pis],
                 "proof_sha256": proof_sha256(proof_to_dict(env.proof))},
    }
    with open(GOLDEN, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
