"""Write mp2_tpu_torch/testdata/tree_node_golden.json from the JAX package.

The PyTorch port is held against `mp2_tpu`: this script proves the B=2,
seed-0 tree-node batch at `test_config()` with `mp2_tpu.prover.batch.
prove_batch` on the CPU and records the sha256 of each proof's canonical
`proof_to_dict` JSON.  `chip_smoke.py` checks the port's proofs made on the
card against these digests, and tests/test_torch_prover.py checks that the
JAX package still produces them, so the file cannot drift.

Usage (from the repo root):  JAX_PLATFORMS=cpu python tools/make_tree_node_golden.py
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "mp2_tpu_torch", "testdata", "tree_node_golden.json")
BATCH = 2
SEED = 0


def golden_record():
    """The golden record as the JAX package computes it."""
    from mp2_tpu.prover.batch import prove_batch
    from mp2_tpu.prover.config import test_config
    from mp2_tpu.prover.serde import proof_to_dict
    from mp2_tpu.recursion.tp2_backend import _build_tree_node
    from mp2_tpu_torch.prover.serde import proof_sha256
    from mp2_tpu_torch.recursion.tp2_backend import tree_node_batch

    data, inputs = _build_tree_node(test_config())
    wits, pis = tree_node_batch(data, inputs, BATCH, SEED)
    proofs = prove_batch(data, wits, pis)
    return {
        "circuit": "tree_node",
        "config": "test_config",
        "batch": BATCH,
        "seed": SEED,
        "circuit_digest": [int(x) for x in data.circuit_digest],
        "proof_sha256": [proof_sha256(proof_to_dict(p)) for p in proofs],
    }


if __name__ == "__main__":
    rec = golden_record()
    with open(GOLDEN, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec))
