"""Time the pipeline's block 101 and its three queries alone on one card.

    python3 tools/time_pipeline_queries.py

Builds K1, K2, K2c and P1 from the sources in this checkout, then runs
chip_smoke.py's pipeline phases in this one process, with the card and the
host to itself: the indexer's set-up (the extraction, verifiable-DB and
query sets, each against its golden record), block 101 through
`apply_block` and tests/test_circuit_pipeline.py's three queries through
`run_query`, with every check those phases make.  It prints what they
print (each set's wall, each call's split into witness generation,
`prove_batch` and other, `pipeline_block_proofs_per_s` and
`pipeline_query_proofs_per_s`), then the card's name and power limit.
The kernel shapes are announced but not checked here (chip_smoke.py's
main process checks them).  Needs one CUDA card; imports no JAX.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("time_pipeline_queries: no CUDA device", file=sys.stderr)
        return 2
    golden = {}
    for name in ("extraction", "final_extraction", "vdb", "pipeline"):
        with open(os.path.join(S.TESTDATA, f"{name}_golden.json")) as f:
            golden[name] = json.load(f)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    x, fin, v, p = (golden[k] for k in ("extraction", "final_extraction", "vdb", "pipeline"))
    S._phase("kernel builds", S.phase_builds)
    cfg, chain = S._pipeline_chain()
    block = chain[-1]
    ix = S._phase("pipeline set-up", S.phase_pipeline_setup, card, torch.device("cuda"), cfg,
                  block, x, fin, v, p)
    S._settled()
    launches, shapes = {}, S._ShapeLog()
    S._phase("pipeline block 101", S.phase_pipeline_block, card, ix, cfg, block, x, fin, p,
             launches, shapes)
    S._phase("pipeline queries", S.phase_pipeline_queries, card, ix, p, launches, shapes)
    print(card)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)  # leave the sets' millions of objects to the operating system
