"""Write mp2_tpu_torch/testdata/vdb_golden.json from the JAX package.

The PyTorch port's verifiable DB (the cells, rows, block and IVC circuit
sets of `vdb/circuits.VerifiableDbCircuits`) is held against `mp2_tpu`.
Recursive proofs from the JAX package take minutes on a CPU, so the tests
and `chip_smoke.py` compare the port with digests that this script records
once, on the CPU:

  light       VerifiableDbCircuits(test_config()): for each of the cells,
              rows, block and IVC sets, the set digest (the fixed
              verification key), the standard n, and each member's digest
              and wrap chain;
  production  the same at CircuitConfig() (no proving);
  chain       the light chain of tests/test_vdb_circuits.py:153-203: cells
              Cell(7, 700), Cell(8, 800) proved by `prove_cells_tree`
              (cells_leaf, then cells_partial), then `rows_leaf` over that
              cells tree with the secondary cell Cell(5, 55) and
              row_unique_data (9, 8, 7, 6); the inputs, the rows leaf's
              public inputs and the sha256 of each envelope's proof, in
              proving order.  Then `block_leaf` (index_id 99, block 1234)
              over the rows leaf and `ivc_first` over the block leaf, with
              the metadata hash H(1, 2, 3): their inputs, public inputs
              and proof sha256 under the `block_*` and `ivc_*` keys.

Usage (from the repo root; each part takes tens of minutes on a CPU; light
and chain share one set-up when they run in one process, production runs
best in a process of its own beside them):

    JAX_PLATFORMS=cpu python tools/make_vdb_golden.py [PART ...]

With no PART all three are computed; a named part replaces only its own
entry in the existing file.
"""

import functools
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "vdb_golden.json")
CHAIN_CELLS = ((7, 700), (8, 800))
CHAIN_SECONDARY = (5, 55)
CHAIN_ROW_UNIQUE_DATA = (9, 8, 7, 6)
CHAIN_ROW_KEY = (55, 0)
CHAIN_INDEX_ID = 99
CHAIN_BLOCK_NUMBER = 1234
CHAIN_METADATA_INPUTS = (1, 2, 3)  # the metadata hash is H(1, 2, 3)
SETS = ("cells", "rows", "block", "ivc")


def _set_record(fw):
    return {
        "set_digest": [int(v) for v in fw.set_digest],
        "standard_n": fw.standard.n,
        "member_digests": {name: [int(v) for v in fw.members[name].digest]
                           for name in fw.member_order},
        "wrap_chain_n": {name: [fw.members[name].data.n]
                         + [wc.data.n for wc in fw._wrap_chain_for(fw.members[name].data)]
                         for name in fw.member_order},
    }


def _circuits_record(vdb):
    return {name: _set_record(getattr(vdb, name)) for name in SETS}


@functools.lru_cache(maxsize=None)
def _light_circuits():
    from mp2_tpu.prover.config import test_config
    from mp2_tpu.vdb.circuits import VerifiableDbCircuits

    return VerifiableDbCircuits(test_config())


def light():
    return _circuits_record(_light_circuits())


def production():
    from mp2_tpu.prover.config import CircuitConfig
    from mp2_tpu.vdb.circuits import VerifiableDbCircuits

    return _circuits_record(VerifiableDbCircuits(CircuitConfig()))


def chain():
    from mp2_tpu.hash import poseidon2_host as p2h
    from mp2_tpu.prover.serde import proof_to_dict
    from mp2_tpu.vdb import circuits as C
    from mp2_tpu.vdb import digests as D
    from mp2_tpu.vdb.trees import (BlockPayload, Cell, RowPayload, build_cells_tree,
                                   new_block_tree, new_row_tree)
    from mp2_tpu_torch.prover.serde import proof_sha256

    vdb = _light_circuits()
    proved = []  # every member envelope of the cells set, in proving order
    prove_member = vdb.cells._prove_member

    def recording(m, inputs, user_pis):
        env = prove_member(m, inputs, user_pis)
        proved.append(env)
        return env

    vdb.cells._prove_member = recording
    cells = build_cells_tree([Cell(i, v) for i, v in CHAIN_CELLS])
    cells_env = vdb.prove_cells_tree(cells)
    vdb.cells._prove_member = prove_member
    assert proved[-1] is cells_env and vdb.cells.verify(cells_env)

    rows_db = new_row_tree()
    rows_db.in_transaction(lambda t: t.store(CHAIN_ROW_KEY, RowPayload(
        secondary=Cell(*CHAIN_SECONDARY), row_unique_data=CHAIN_ROW_UNIQUE_DATA,
        cells=cells)))
    payload = rows_db.payload(CHAIN_ROW_KEY)
    row_pis = C.rows_pi_values(payload)
    row_env = vdb.rows.prove_aggregation(
        "rows_leaf", [], (payload.secondary, CHAIN_ROW_UNIQUE_DATA), row_pis,
        foreign_children=[cells_env])
    assert vdb.rows.verify(row_env)
    envs = proved + [row_env]

    block_db = new_block_tree()
    block_db.in_transaction(lambda t: t.store(CHAIN_BLOCK_NUMBER, BlockPayload(
        index_id=CHAIN_INDEX_ID, block_number=CHAIN_BLOCK_NUMBER,
        rows_hash=payload.hash,
        rows_digest=D.compute_final_digest(False, payload.individual_vd,
                                           payload.multiplier_vd,
                                           payload.multiplier_cnt))))
    block = block_db.payload(CHAIN_BLOCK_NUMBER)
    block_pis = C.block_pi_values(block)
    block_env = vdb.block.prove_aggregation(
        "block_leaf", [], (CHAIN_INDEX_ID, CHAIN_BLOCK_NUMBER, False), block_pis,
        foreign_children=[row_env])
    assert vdb.block.verify(block_env)
    md = p2h.hash_no_pad(list(CHAIN_METADATA_INPUTS))
    ivc_pis = C.ivc_pi_values(block.hash, md, CHAIN_BLOCK_NUMBER)
    ivc_env = vdb.ivc.prove_aggregation(
        "ivc_first", [], (md, CHAIN_BLOCK_NUMBER), ivc_pis,
        foreign_children=[block_env])
    assert vdb.ivc.verify(ivc_env)
    upper = [block_env, ivc_env]
    return {
        "cells": [list(c) for c in CHAIN_CELLS],
        "secondary": list(CHAIN_SECONDARY),
        "row_unique_data": list(CHAIN_ROW_UNIQUE_DATA),
        "row_key": list(CHAIN_ROW_KEY),
        "rows_leaf_public_inputs": [int(v) for v in row_pis],
        "members": [e.member for e in envs],
        "proof_sha256": [proof_sha256(proof_to_dict(e.proof)) for e in envs],
        "block_index_id": CHAIN_INDEX_ID,
        "block_number": CHAIN_BLOCK_NUMBER,
        "block_leaf_public_inputs": [int(v) for v in block_pis],
        "ivc_metadata_inputs": list(CHAIN_METADATA_INPUTS),
        "ivc_first_public_inputs": [int(v) for v in ivc_pis],
        "block_ivc_members": [e.member for e in upper],
        "block_ivc_proof_sha256": [proof_sha256(proof_to_dict(e.proof)) for e in upper],
    }


PARTS = {"light": light, "production": production, "chain": chain}


def main(names):
    for name in names or list(PARTS):
        t0, c0 = time.perf_counter(), time.process_time()
        part = PARTS[name]()
        print(f"{name}: {time.perf_counter() - t0:.1f} s wall, "
              f"{time.process_time() - c0:.1f} s CPU", flush=True)
        rec = {}
        if os.path.exists(GOLDEN):  # re-read: other parts may run beside this one
            with open(GOLDEN) as f:
                rec = json.load(f)
        rec[name] = part
        with open(GOLDEN, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
