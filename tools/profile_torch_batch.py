"""Profile warm `prove_batch` calls of the PyTorch port on one CUDA card.

    python3 tools/profile_torch_batch.py [--runs 5] [--out FILE]

For the two tree-node shapes `chip_smoke.py` times (`test_config()` at B=32
and the production `CircuitConfig()` at B=8) and for the recursion's
leaf-wrap batch (the 2^13-row wrap circuit of the light framework's leaf
member, B=16, as the first level of `chip_smoke.py`'s reduce tree proves
it) it prints the walls of `--runs` unprofiled warm batches, then profiles
one more batch with `torch.profiler` and prints one JSON line per shape:
  device_events    kernels and copies the card ran for the batch
  device_busy_ms   their summed device time
  idle_share       1 - busy / the median unprofiled wall
  k1_ms, k1_events the Poseidon2 kernels' share of the device time (the
                   permutation, the Merkle leaf hash and the Merkle levels)
  k2_ms, k2_events the NTT kernel's share
  k2c_ms, k2c_events the four-step NTT kernel's share (2^15 points and up)
  host_cpu_ms      self CPU time of the profiled host ops
  peak_mem_gib     torch.cuda.max_memory_allocated over the profiled batch
The profiler's key_averages table (top rows by device time) goes to stdout,
or whole to `--out`.  Imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mp2_tpu_torch.hash import poseidon2_host as p2h  # noqa: E402
from mp2_tpu_torch.ops import ntt_cuda as N  # noqa: E402
from mp2_tpu_torch.ops import ntt_t_cuda as T  # noqa: E402
from mp2_tpu_torch.ops import poseidon2_cuda as K  # noqa: E402
from mp2_tpu_torch.prover.batch import prove_batch  # noqa: E402
from mp2_tpu_torch.prover.config import CircuitConfig, test_config  # noqa: E402
from mp2_tpu_torch.recursion.runtime import RecursionFramework  # noqa: E402
from mp2_tpu_torch.recursion.tp2_backend import _build_tree_node, tree_node_batch  # noqa: E402
from mp2_tpu_torch.recursion.verifier_gadget import set_proof_witness  # noqa: E402


def _timed(data, wits, pis):
    t0 = time.perf_counter()
    prove_batch(data, wits, pis)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def tree_node(cfg, batch):
    data, inputs = _build_tree_node(cfg, torch.device("cuda"))
    return (data, *tree_node_batch(data, inputs, batch, 0))


def _leaf_build(b):
    """The light framework's leaf member (as in chip_smoke.py): PIs = H(x)."""
    x = b.add_input()
    b.register_public_inputs(b.hash_no_pad([x]))

    def assign(inputs, xv):
        inputs[x] = xv

    return assign


def leaf_wrap(batch):
    """The wrap batch of `batch` leaf proofs: (wrap circuit, witnesses, PIs)."""
    fw = RecursionFramework(test_config(), num_user_pis=4, set_height=2)
    fw.add_leaf_circuit("leaf", _leaf_build)
    fw.finalize()
    m = fw.members["leaf"]
    wits, pis = [], []
    for v in range(batch):
        inputs = {}
        m.assign(inputs, v)
        inputs.update(zip(m.sd_targets, fw.set_digest))
        wits.append(m.data.generate_witness(inputs))
        pis.append(list(p2h.hash_no_pad([v])) + list(fw.set_digest))
    wrap_wits = []
    for proof in prove_batch(m.data, np.stack(wits), pis):
        inputs = {}
        set_proof_witness(inputs, m.wrap.proof_targets, proof)
        wrap_wits.append(m.wrap.data.generate_witness(inputs))
    return m.wrap.data, np.stack(wrap_wits), pis


def profile_shape(name, data, wits, pis, runs):
    """Unprofiled walls, then one profiled batch; returns (record, table)."""
    batch = len(pis)
    _timed(data, wits, pis)  # warm-up
    walls = [_timed(data, wits, pis) for _ in range(runs)]
    for w in (K.permute_planar, K.hash_leaves, K.merkle_levels, N.ntt_rows,
              T.ntt_four_step_t):
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prove_batch(data, wits, pis)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    k1 = [e for e in device if any(k in e.key for k in ("poseidon2", "hash_leaves",
                                                          "merkle_levels"))]
    k2 = [e for e in device if "ntt_rows" in e.key]
    k2c = [e for e in device if "ntt_cols" in e.key]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    rec = {
        "shape": name,
        "B": batch,
        "walls_s": walls,
        "median_wall_s": float(np.median(walls)),
        "device_events": sum(e.count for e in device),
        "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / 1e3 / float(np.median(walls)),
        "k1_ms": sum(e.self_device_time_total for e in k1) / 1e3,
        "k1_events": sum(e.count for e in k1),
        "k1_launches": K.launches(),
        "k2_ms": sum(e.self_device_time_total for e in k2) / 1e3,
        "k2_events": sum(e.count for e in k2),
        "k2_launches": N.ntt_rows.launches,
        "k2c_ms": sum(e.self_device_time_total for e in k2c) / 1e3,
        "k2c_events": sum(e.count for e in k2c),
        "k2c_launches": T.ntt_four_step_t.launches,
        "host_cpu_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return rec, events


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5, help="unprofiled warm batches per shape")
    ap.add_argument("--out", help="write the whole key_averages tables here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_batch: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    tables = []
    shapes = (("light", lambda: tree_node(test_config(), 32)),
              ("production", lambda: tree_node(CircuitConfig(), 8)),
              ("leaf_wrap", lambda: leaf_wrap(16)))
    for name, make in shapes:
        rec, events = profile_shape(name, *make(), args.runs)
        print(json.dumps(rec), flush=True)
        tables.append(f"== {name} (B={rec['B']})\n" + events.table(
            sort_by="self_device_time_total", row_limit=-1 if args.out else 12))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(tables))
    else:
        print("\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
