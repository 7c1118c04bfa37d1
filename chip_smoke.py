"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Builds K1 (the Poseidon2 CUDA kernel) from the sources in this checkout,
holds it bit for bit against its plain PyTorch version and the host model at
the shapes the prover gives it, then proves batches of tree-node proofs with
`mp2_tpu_torch.prover.batch.prove_batch` on the card at both the light
(`test_config`, B=32) and the production (`CircuitConfig()`, B=8) shape,
verifies every proof with the port's own verifier, and checks the B=2 light
proofs against the digests the JAX package wrote
(`mp2_tpu_torch/testdata/tree_node_golden.json`).  Last, it times ten warm
batches per shape, the shapes alternating, and prints the median and the
quartiles of their walls as `tree_node_proofs_per_s*`.

Each phase prints its lines; any mismatch or exception exits non-zero.  The
second-to-last line is the kernel record as JSON, the last line
`{"ok": true, "device": {...}}`.  Needs one CUDA card; imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.hash import poseidon2 as p2
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.ops import poseidon2_cuda as K
from mp2_tpu_torch.prover.batch import prove_batch
from mp2_tpu_torch.prover.config import CircuitConfig, test_config
from mp2_tpu_torch.prover.serde import proof_sha256, proof_to_dict
from mp2_tpu_torch.prover.verify import verify
from mp2_tpu_torch.recursion.tp2_backend import _build_tree_node, tree_node_batch

GOLDEN = os.path.join("mp2_tpu_torch", "testdata", "tree_node_golden.json")
LIGHT_BATCH = 32
PROD_BATCH = 8
TIMED_BATCHES = 10


def _fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(fn, x, reps):
    """Mean device time of fn(x) in ms over `reps` calls, after a warm-up."""
    fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(a, b):
    """Largest |a - b| over all elements, as unsigned 64-bit values."""
    diff = a != b
    if not diff.any():
        return 0
    return max(abs(int(x) - int(y))
               for x, y in zip(gl.to_u64(a[diff]), gl.to_u64(b[diff])))


def phase_toolchain(card):
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([K._nvcc(), "--version"], capture_output=True, text=True)
    print("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    built = K.build()
    print(f"K1 build: {time.perf_counter() - t0:.3f} s wall "
          f"(nvcc {built.seconds:.3f} s) -> {os.path.relpath(built.path)}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())


def phase_kernel(card):
    """K1 against its plain version (bit for bit) and the host model."""
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    n = 1 << 20
    st = rng.integers(0, gl.P, size=(12, n), dtype=np.uint64)
    edges = [0, gl.P - 1, 1 << 32, (1 << 32) - 1]
    for k, v in enumerate(edges):  # whole edge states and mixed edge lanes
        st[:, k] = v
        st[:, len(edges) + k] = [edges[(k + i) % 4] for i in range(12)]
    x = gl.from_u64(st, dev)
    got = K.permute_planar(x)
    torch.cuda.synchronize()
    want = K.permute_planar_plain(x)
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    mism = int((got != want).sum())
    print(f"K1 vs plain at 2^20 lanes (+ edge lanes 0, p-1, 2^32, 2^32-1): "
          f"{mism} mismatches, max_abs_err {err} (tolerance 0: bit-exact)")
    if mism:
        _fail("K1 disagrees with its plain version")
    host_out = gl.to_u64(got[:, :64])
    for i in range(64):
        exp = p2h.permute([int(v) for v in st[:, i]])
        if [int(v) for v in host_out[:, i]] != exp:
            _fail(f"K1 disagrees with poseidon2_host.permute on state {i}")
    print("K1 vs poseidon2_host.permute: 64 states identical")

    # the prover's shapes: challenger/PI hash (B lanes), Merkle leaves
    # (128*B lanes), 2^20, and production grinding (2^19 * B lanes)
    timings = {}
    for lanes in (LIGHT_BATCH, 128 * PROD_BATCH, 128 * LIGHT_BATCH, n,
                  (1 << 19) * PROD_BATCH):
        xs = gl.from_u64(rng.integers(0, gl.P, size=(12, lanes), dtype=np.uint64), dev)
        a, b = K.permute_planar(xs), K.permute_planar_plain(xs)
        if not torch.equal(a, b):
            _fail(f"K1 disagrees with its plain version at {lanes} lanes")
        k_ms = _time_ms(K.permute_planar, xs, 50 if lanes <= n else 10)
        p_ms = _time_ms(K.permute_planar_plain, xs, 5 if lanes <= n else 2)
        timings[lanes] = (k_ms, p_ms)
        print(f"K1 at {lanes} lanes: kernel {k_ms:.4f} ms "
              f"({lanes / k_ms / 1e3:.1f}M perms/s), plain {p_ms:.4f} ms, "
              f"identical; {card}")
    return err, timings


def _prove_and_verify(name, data, inputs, batch):
    wits, pis = tree_node_batch(data, inputs, batch, 0)
    t0 = time.perf_counter()
    prove_batch(data, wits, pis)  # warm-up: lazy tables, kernel module load
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    K.permute_planar.launches = 0
    proofs = prove_batch(data, wits, pis)
    torch.cuda.synchronize()
    launches = K.permute_planar.launches
    ok = [verify(data, p) for p in proofs]
    print(f"{name}: B={batch}, warm-up {warm:.3f} s; K1 launches {launches}; "
          f"verified {sum(ok)}/{batch}")
    if not all(ok):
        _fail(f"{name}: the port's verifier rejected a proof")
    if launches == 0:
        _fail(f"{name}: the prove did not go through K1")
    return launches, (data, wits, pis)


def phase_timing(card, shapes):
    """TIMED_BATCHES warm batches per shape, the shapes alternating in one
    process. `shapes` maps a metric name to (data, witnesses, public inputs).
    Prints each shape's walls, their median and quartiles, and the proofs/s
    at those walls: the end-to-end metrics."""
    walls = {metric: [] for metric in shapes}
    order = list(shapes)
    for i in range(TIMED_BATCHES):
        for metric in order if i % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            prove_batch(*shapes[metric])
            torch.cuda.synchronize()
            walls[metric].append(time.perf_counter() - t0)
    for metric, w in walls.items():
        batch = len(shapes[metric][2])
        q1, med, q3 = np.percentile(w, [25, 50, 75])
        print(f"{metric} walls (s, B={batch}): {', '.join(f'{x:.4f}' for x in w)}")
        print(f"{metric} {batch / med:.3f} at the median wall {med:.4f} s "
              f"(q1 {q1:.4f} s -> {batch / q1:.3f}, q3 {q3:.4f} s -> "
              f"{batch / q3:.3f}; {TIMED_BATCHES} batches); {card}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with open(GOLDEN) as f:
        golden = json.load(f)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    # 1. device and toolchain
    phase_toolchain(card)

    # 2. K1 against its plain version and the host model
    err, timings = phase_kernel(card)

    # 3. the slice at the light shape
    t0 = time.perf_counter()
    data, inputs = _build_tree_node(test_config(), dev)
    print(f"tree_node circuit (test_config) built on the card in "
          f"{time.perf_counter() - t0:.3f} s: n={data.n}, "
          f"fixed_lde {tuple(data.fixed_lde.shape)}")
    if list(data.circuit_digest) != golden["circuit_digest"]:
        _fail("circuit digest differs from the JAX package's")
    launches, light = _prove_and_verify("light shape", data, inputs, LIGHT_BATCH)

    # 4. held against the JAX reference, kernel path and plain path
    wits, pis = tree_node_batch(data, inputs, golden["batch"], golden["seed"])
    digests = [proof_sha256(proof_to_dict(p)) for p in prove_batch(data, wits, pis)]
    if digests != golden["proof_sha256"]:
        _fail(f"B=2 proofs differ from the JAX golden digests: {digests}")
    p2.permute_planar = K.permute_planar_plain  # the plain path on the card
    before = K.permute_planar.launches
    try:
        plain = [proof_sha256(proof_to_dict(p)) for p in prove_batch(data, wits, pis)]
    finally:
        p2.permute_planar = K.permute_planar
    if K.permute_planar.launches != before:
        _fail("the plain-path prove launched K1")
    if plain != digests:
        _fail("the plain path on the card gives other proofs than K1")
    print(f"B=2 proofs on the card match the JAX golden digests "
          f"({', '.join(d[:12] for d in digests)}), kernel and plain path alike")

    # 5. the slice at the production shape (16 PoW bits of grinding)
    data, inputs = _build_tree_node(CircuitConfig(), dev)
    _, production = _prove_and_verify("production shape", data, inputs, PROD_BATCH)

    # 6. the end-to-end metrics: median and quartiles of alternating batches
    phase_timing(card, {"tree_node_proofs_per_s": light,
                        "tree_node_proofs_per_s_production": production})
    k_ms, p_ms = timings[1 << 20]
    print(json.dumps({"kernels": [{
        "name": "poseidon2_permute_planar",
        "route": "cuda",
        "source": "mp2_tpu_torch/csrc/poseidon2.cu",
        "replaces": "mp2_tpu/ops/poseidon2_pallas.py:114",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "lanes": 1 << 20,
        "by_lanes": {str(k): {"ms": v[0], "plain_ms": v[1]} for k, v in timings.items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
