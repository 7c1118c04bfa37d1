"""Profile warm tree-node `prove_batch` calls of the PyTorch port on one CUDA card.

    python3 tools/profile_torch_batch.py [--runs 5] [--out FILE]

For the two shapes `chip_smoke.py` times (`test_config()` at B=32 and the
production `CircuitConfig()` at B=8) it prints the walls of `--runs`
unprofiled warm batches, then profiles one more batch with `torch.profiler`
and prints one JSON line per shape:
  device_events    kernels and copies the card ran for the batch
  device_busy_ms   their summed device time
  idle_share       1 - busy / the median unprofiled wall
  k1_ms, k1_events the Poseidon2 kernel's share of the device time
  host_cpu_ms      self CPU time of the profiled host ops
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

from mp2_tpu_torch.ops import poseidon2_cuda as K  # noqa: E402
from mp2_tpu_torch.prover.batch import prove_batch  # noqa: E402
from mp2_tpu_torch.prover.config import CircuitConfig, test_config  # noqa: E402
from mp2_tpu_torch.recursion.tp2_backend import _build_tree_node, tree_node_batch  # noqa: E402


def _timed(data, wits, pis):
    t0 = time.perf_counter()
    prove_batch(data, wits, pis)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_shape(name, cfg, batch, runs):
    """Unprofiled walls, then one profiled batch; returns (record, table)."""
    data, inputs = _build_tree_node(cfg, torch.device("cuda"))
    wits, pis = tree_node_batch(data, inputs, batch, 0)
    _timed(data, wits, pis)  # warm-up
    walls = [_timed(data, wits, pis) for _ in range(runs)]
    K.permute_planar.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prove_batch(data, wits, pis)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    k1 = [e for e in device if "poseidon2" in e.key]
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
        "k1_launches": K.permute_planar.launches,
        "host_cpu_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
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
    for name, cfg, batch in (("light", test_config(), 32),
                             ("production", CircuitConfig(), 8)):
        rec, events = profile_shape(name, cfg, batch, args.runs)
        print(json.dumps(rec))
        tables.append(f"== {name} (B={batch})\n" + events.table(
            sort_by="self_device_time_total", row_limit=-1 if args.out else 12))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(tables))
    else:
        print("\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
