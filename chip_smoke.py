"""Drive the PyTorch port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Builds K1 (the Poseidon2 CUDA kernels: the permutation, the Merkle leaf
hash and the Merkle levels), K2 (the NTT CUDA kernel of rows up to 2^14
points, with its LDE and coset-iNTT entries), K2c (the transpose-fused
four-step NTT CUDA kernel, with its LDE and coset-iNTT entries) and P1 (the
field-primitive probe) from the sources in this checkout, the four `nvcc`
runs started together, and prints each kernel's registers, spills and SASS
instruction counts.  P1 runs first: every primitive's cost on the card, the
lazy ones in both their carry-chain and compare-and-select forms, each chain bit
for bit against its plain twin.  Then it holds each kernel bit for bit
against its plain PyTorch version at the shapes the prover gives it (K1
also against the host model, and its Merkle entries against the
sponge-by-permutation composition they replaced; K2 at every size from 2^1
to 2^14 with every flag, and its entries, timed beside the pad +
coset-multiply + K2 compositions they replaced; K2c from 2^6 to 2^10 and
from 2^15 to 2^20, at B=1 and 3, and at the LDE widths, where the K2 +
torch-transpose four-step and the pad + coset-multiply + K2c composition it
replaced are timed beside it, and the prover's `ntt`, `intt`, `lde` and
`coset_intt` from 2^21 to 2^24 points, three K2c launches each).  Then it
drives these paths:

  tree-node proofs (the map phase): batches of tree-node proofs with
  `prover/batch.prove_batch` at the light (`test_config`, B=32) and the
  production (`CircuitConfig()`, B=8) shape, every proof verified by the
  port's verifier, the B=2 light proofs checked against the digests the JAX
  package wrote (`mp2_tpu_torch/testdata/tree_node_golden.json`), and ten
  warm batches per shape timed, alternating, each also with the NTTs on
  their plain path, printed as `tree_node_proofs_per_s*`;

  fixed-VK recursion (the reduce phase): `RecursionFramework` with a leaf
  and a 2-child aggregation member at `test_config()` (set digest, standard
  n, member digests and the proofs of 2 leaves + 1 aggregation checked
  against `mp2_tpu_torch/testdata/recursion_golden.json`, which the JAX
  package wrote), then a TREE_LEAVES-leaf binary reduce tree proved level
  by level, its root verified, printed as `fixed_vk_tree_proofs_per_s`;
  and the same framework at `CircuitConfig()` (set digest and standard n
  checked, 2 leaves + 1 aggregation proved and the root verified);

  the verifiable DB: `vdb/circuits.VerifiableDbCircuits` (the cells,
  rows, block and IVC sets) at `test_config()` and `CircuitConfig()`, set
  and member digests, standard n and wrap chains checked against
  `mp2_tpu_torch/testdata/vdb_golden.json`; the 2-cell -> `rows_leaf` ->
  `block_leaf` -> `ivc_first` chain proved and its envelopes checked
  against the JAX proofs; then one block that inserts VDB_ROWS rows of
  VDB_COLUMNS cells into an empty rows tree: every cells tree level by
  level across rows, then the rows tree's update plan through
  `parallel/scheduler.MapReduceScheduler`, each ready group of
  same-circuit nodes in one batched call; the root verified and its public
  inputs held against the host model, printed as
  `vdb_row_update_proofs_per_s`; then BLOCKS blocks appended to an empty
  block tree over that rows root, each block's block-tree update plan
  drained bottom-up (`block_leaf`, `block_parent` with and without a right
  child) and followed by an IVC step (`ivc_first`, then `ivc_subsequent`),
  every block-tree root and IVC proof verified and held against the host
  model, printed as `vdb_block_ivc_proofs_per_s`; and the sets at
  `CircuitConfig()`, with the chain to `rows_leaf` proved and verified;

  a block through the pipeline: `models/circuit_pipeline.CircuitTableIndexer`
  for the pipeline's mapping table (its chain from
  `models/pipeline.make_chain`, as mp2_tpu/models/pipeline.py:139-182
  builds it), its sets built by `_ensure_built` on block 101's header at
  `test_config()`: the values-extraction set
  (`extraction/mpt_circuits.ValuesExtractionCircuits` with `leaf_mapping`,
  `extension`, `branch1`, `branch2` and `branch3` members of 2^14 to 2^16
  rows, keccak, RLP and the MPT key chain in-circuit), the contract set
  (`extraction/final_circuits.ContractExtractionCircuits`: `account_leaf`,
  `branch`, `extension`), the block framework over block 101's header
  offsets, the final set (`final_simple`, which verifies a block, a
  contract and a values proof) and the verifiable DB's four sets over it
  (`VerifiableDbCircuits(extraction=fx)`, whose block set adds
  `block_leaf_bound` and `block_parent_bound`), their set, member and
  circuit digests, rows and wrap chains checked against
  `mp2_tpu_torch/testdata/{extraction,final_extraction,pipeline}_golden.json`
  and the cells and rows sets against `vdb_golden.json`, which the JAX
  package wrote; then block 101 applied as the indexer's first block by one
  call of `apply_block`: its storage trie from its leaves to the storage
  root through `prove_trie` (3 `leaf_mapping` and 2 `branch2` proofs), the
  contract's state path (one `account_leaf`), the header and `final_simple`
  over the three, its rows tree (three one-cell trees and `rows_leaf`,
  `rows_partial`, `rows_partial`), the block-tree leaf `block_leaf_bound`,
  which verifies `final_simple` in-circuit and pins its values digest to the
  rows digest and its block number to the leaf's, and `ivc_first`.  The trie
  root is verified and its public inputs held against the host model
  `extract_storage_slots`, the 0x11 leaf's, the account leaf's and the
  header's envelopes against the JAX package's proofs, `final_simple`'s
  public inputs against the host models (`extract_block`,
  `extract_contract`, `final_extraction`) and the JAX package's, their
  metadata hash against the JAX package's; the rows root,
  `block_leaf_bound` and `ivc_first` are verified and their public inputs
  held against the host models (`rows_pi_values`, `block_pi_values`,
  `ivc_pi_values`) and the JAX package's, the rows digest against
  `final_simple`'s values digest; printed as
  `extraction_storage_proofs_per_s` (the trie), `extraction_block_proofs_per_s`
  (the extraction) and `pipeline_block_proofs_per_s` (the 16 proofs of
  `apply_block`); and every K2c and K1 Merkle entry shape that this path
  feeds, held against its plain twin and timed beside its bound by the main
  process as the pipeline's process announces it;

  queries over that block: the same indexer, built with two tabular rows,
  also builds the query sets over its IVC set (`vdb/query/chunks.QueryCircuits`:
  the row set with the tree-bound `row` and `row_dummy`, the chunk set with
  `row_chunk`, `chunk_merge` and `non_existence`, the revelation set with
  `revelation` and `revelation_tabular`, each verifying the IVC set
  cross-set), held against `pipeline_golden.json`; after block 101 two
  `run_query` calls prove two of tests/test_circuit_pipeline.py's queries:
  an aggregate over blocks [100, 101] (`row_chunk`, `revelation`) and the
  same over the empty range [200, 210] (`non_existence`, `revelation`).
  Each revelation is verified and every member proof's public inputs, the
  revealed values (the computational and placeholder hashes, the IVC
  proof's block-tree root, the result) and the host result are held
  against the JAX package's; printed as `pipeline_query_proofs_per_s` (the
  4 proofs over the two calls' walls); the new kernel shapes are checked
  as above.  The third query, a tabular DISTINCT ... LIMIT 2 (two `row`
  proofs, `revelation_tabular`), is proved with the same checks by
  tests/test_torch_cuda.py::test_pipeline_tabular_query_on_card, which
  keeps this script inside its time limit on the slower hosts;

  a merged table through the proving API: the pipeline's table joined with
  the total supply in slot 9 (`models/pipeline.MergedTableConfig`,
  tests/test_merged_table.py's chain), its sets built by
  `api.build_circuits_params` on block 100's header (the two values sets,
  the contract and block sets, the final set with `final_simple` and
  `final_merge`, the verifiable DB's four sets over it), held against the
  golden files (`merged_golden.json` for the supply's values set, the
  merged final set and the bound block and IVC sets over it); then block
  100's extraction through `parallel/workqueue`: a `Coordinator` on
  127.0.0.1 leases the four child payloads (`values_trie` for the balances
  and for the supply, `contract`, `block`) to one `WorkerClient` thread
  whose `prove` is `api.generate_proof`, then the `final_merge` payload
  built from their serialized results: 9 member proofs (2 `leaf_mapping`,
  `branch2`, `branch1`; `leaf_single`, `branch1`; `account_leaf`, `block`,
  `final_merge`).  Every result is accepted by `api.verify_envelope` and a
  tampered copy refused; the walks' root PIs, the account leaf's and the
  header's equal the host models' and the JAX package's, and
  `final_merge`'s equal `final_merge_pi_values` of them and the JAX
  package's; printed as `merged_extraction_proofs_per_s`, with each new
  kernel shape checked as above.  Both blocks through `MergedTableIndexer`
  and the merged query are tests/test_torch_cuda.py::test_merged_table_pipeline_on_card.

Five processes of this script share the card.  The main one starts the
other four first, which set up their circuit sets on the host (their
first kernel launch waits until the main one has built the kernels) while
the main one builds the kernels and runs the kernel phases, the tree-node
batches and their timing, holding the whole card.  After that every step
that proves takes one of three lanes of the card, which the main process
grants: the heavy lane runs the row update (`--vdb-light`), then block 101
and the queries through the pipeline (`--extraction`); the block-path lane
runs the block path (`--vdb-light`), then the merged table's block 100
(`--merged`); the other lane runs the remaining steps one at a time:
the production recursion (main process), the production vdb chain
(`--vdb-production`), the light recursion (main process) and the light vdb
golden chain (`--vdb-light`).  The main process sets up both recursion
frameworks after the timing, the light one first, and checks the
pipeline's and the merged path's kernel shapes while they prove.  So no
other step that proves runs beside the kernel phases and the tree-node
timing.  `prove_batch`'s pieces are bounded so that a 2^16-row proof adds
~9 GiB to its process's resident sets, which lets the steps share the card.  The script prints
each step's times on its clock (asked for its lane, granted it, gave it
back), each prove_batch's stages' peak card memory, the least free card
memory it saw, the other processes' output, and fails with them.  Each
phase prints its wall.  A plain twin that takes over a second is timed
with one call.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after, and fails if a kernel of the path was not launched.  Any
mismatch or exception exits non-zero.  The line before the kernel record
names the card and its power limit; the second-to-last line is the kernel
record as JSON, the last line `{"ok": true, "device": {...}}`.  Needs one
CUDA card; imports no JAX.
"""

import contextlib
import dataclasses
import gc
import json
import os
import queue
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

# the wrap batches' eager field ops allocate and free tensors of many sizes;
# expandable segments keep the freed blocks usable across sizes
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import torch  # noqa: E402

from mp2_tpu_torch import api as API
from mp2_tpu_torch.extraction import api as XA
from mp2_tpu_torch.extraction import final_circuits as XF
from mp2_tpu_torch.extraction import metadata as XM
from mp2_tpu_torch.extraction import storage_key as SK
from mp2_tpu_torch.extraction.circuits import fixture_header_offsets
from mp2_tpu_torch.extraction.mpt_circuits import host_key_nibbles, mpt_pi_values
from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.ecgfp5 import Point
from mp2_tpu_torch.hash import poseidon2 as p2
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.models import circuit_pipeline as CP
from mp2_tpu_torch.models.circuit_pipeline import CircuitTableIndexer
from mp2_tpu_torch.models.pipeline import MappingTableConfig, MergedTableConfig, make_chain
from mp2_tpu_torch.ops import _nvcc
from mp2_tpu_torch.ops import ntt_cuda as N
from mp2_tpu_torch.ops import ntt_t_cuda as T
from mp2_tpu_torch.ops import poseidon2_cuda as K
from mp2_tpu_torch.ops import probe_cuda as PC
from mp2_tpu_torch.parallel import workqueue as WQ
from mp2_tpu_torch.parallel.scheduler import MapReduceScheduler
from mp2_tpu_torch.prover import batch as batch_mod
from mp2_tpu_torch.prover import merkle, ntt
from mp2_tpu_torch.prover.batch import prove_batch
from mp2_tpu_torch.prover.config import CircuitConfig, test_config
from mp2_tpu_torch.prover.prove import CircuitData
from mp2_tpu_torch.prover.serde import proof_sha256, proof_to_dict
from mp2_tpu_torch.prover.verify import verify
from mp2_tpu_torch.recursion import runtime
from mp2_tpu_torch.recursion.runtime import RecursionFramework
from mp2_tpu_torch.recursion.tp2_backend import _build_tree_node, tree_node_batch
from mp2_tpu_torch.ryhope.updatetree import UpdateTree
from mp2_tpu_torch.utils import trace
from mp2_tpu_torch.utils.keccak import keccak256
from mp2_tpu_torch.utils.u256 import left_pad32, pack_bytes_be
from mp2_tpu_torch.vdb import circuits as V
from mp2_tpu_torch.vdb import digests as D
from mp2_tpu_torch.vdb.query.ops import Placeholders
from mp2_tpu_torch.vdb.trees import (BlockPayload, Cell, RowPayload, build_cells_tree,
                                     new_block_tree, new_row_tree)

TESTDATA = os.path.join("mp2_tpu_torch", "testdata")
LIGHT_BATCH = 32
PROD_BATCH = 8
TIMED_BATCHES = 10
TREE_LEAVES = 4  # BASELINE config 3 says 16; cut to keep the script in its time limit
WIRES = 136  # columns of every circuit here (CircuitConfig.num_wires)

# The least time the card could take (bound_ms): H100 SXM, NVIDIA's data
# sheet and the Hopper white paper.  Device memory moves 3.35 TB/s.  The
# card has no 64-bit integer multiplier: a 64x64 -> 128 product is four
# 32-bit limb products, each a low and a high half, so 8 issues of the
# 32-bit integer multiplier, which runs 64 lanes per SM per clock on 132 SMs
# at the 1.98 GHz boost clock; a square needs three limb products (the
# cross term once), 6 issues.  Only the products the function needs are
# counted: none by a unit twiddle or by a known zero.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9
MUL64_ISSUES = 8
SQR64_ISSUES = 6
# a permutation: 118 S-boxes x^7 (2 squares, 2 products) and 22 * 12
# products by the internal diagonal
P2_ISSUES = (8 * 12 + 22) * (2 * SQR64_ISSUES + 2 * MUL64_ISSUES) + 22 * 12 * MUL64_ISSUES


def _fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _bound(nbytes, issues):
    """(least ms, what bounds it) for `nbytes` moved and `issues` of the
    32-bit integer multiplier."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = issues / INT32_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dit_muls(log_l, zero_stages=0):
    """Products of one radix-2 transform of 2^log_l points that are not by a
    unit twiddle (stage s has 2^log_l / 2^s of them), where the first
    `zero_stages` stages only copy: the input is non-zero at one slot in
    2^zero_stages (an LDE's zero padding)."""
    half = 1 << (log_l - 1)
    return sum(half - (1 << (log_l - s)) for s in range(zero_stages + 1, log_l + 1))


def _time_ms(fn, reps):
    """Mean device time of fn() in ms over `reps` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_once(fn):
    """(fn(), its device time in ms): one call between CUDA events, for the
    plain versions whose single call takes seconds."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _plain_timed(fn, reps):
    """(fn(), its device time in ms) for a plain twin: one call between CUDA
    events, and where that call took under a second the mean of `reps` more
    (a plain twin's time is no yardstick: one call will do where it takes
    seconds)."""
    out, ms = _timed_once(fn)
    if ms < 1000:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
    return out, ms


def _max_abs_err(a, b):
    """Largest |a - b| over all elements, as unsigned 64-bit values."""
    diff = a != b
    if not diff.any():
        return 0
    return max(abs(int(x) - int(y))
               for x, y in zip(gl.to_u64(a[diff]), gl.to_u64(b[diff])))


def _rand_rows(rng, shape, dev):
    """Random canonical values with the edge values 0, p-1, 2^32, 2^32-1
    at the head of every row."""
    x = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    edges = np.array([0, gl.P - 1, 1 << 32, (1 << 32) - 1], dtype=np.uint64)
    k = min(4, shape[-1])
    x[..., :k] = edges[:k]
    return gl.from_u64(x, dev)


# each kernel's wrappers; a kernel's launches are the sum of theirs
KERNELS = {"K1": (K.permute_planar, K.hash_leaves, K.merkle_levels),
           "K2": (N.ntt_rows,), "K2c": (T.ntt_four_step_t,), "P1": (PC.probe,)}
PROVER_KERNELS = ("K1", "K2", "K2c")


def _count(name):
    return sum(w.launches for w in KERNELS[name])


K2_ENTRIES = ("ntt_rows", "lde_rows", "coset_intt_rows")


@contextlib.contextmanager
def _plain_k2():
    """prover/ntt's K2 entries replaced by their plain twins: the NTTs'
    plain path below 2^15 points."""
    saved = {name: getattr(ntt, name) for name in K2_ENTRIES}
    for name in K2_ENTRIES:
        setattr(ntt, name, getattr(N, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ntt, name, fn)


def _phase(name, fn, *args):
    """Run one phase and print its wall."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _reset_counts():
    for wrappers in KERNELS.values():
        for w in wrappers:
            w.launches = 0


def _read_counts(path, launches, kernels=PROVER_KERNELS):
    """Record the kernels' launch counts of `path` (K1 also by entry); fail
    if one of the `kernels` that the path runs was not launched."""
    got = {name: _count(name) for name in KERNELS}
    got["K1 entries"] = {w.__name__: w.launches for w in KERNELS["K1"]}
    launches[path] = got
    print(f"{path}: " + ", ".join(f"{k} launches {v}" for k, v in got.items()))
    for name in kernels:
        if got[name] == 0:
            _fail(f"{path} did not go through {name}")
    return got


def _shape_key(entry, args):
    """An entry's call as (entry, each tensor's shape or the argument)."""
    return (entry,) + tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                            for a in args)


# each recorded entry: its kernel wrapper and its plain twin
SHAPE_ENTRIES = {"ntt_four_step_t": (T.ntt_four_step_t, T.ntt_four_step_plain),
                 "lde_t": (T.lde_t, T.lde_t_plain),
                 "coset_intt_t": (T.coset_intt_t, T.coset_intt_t_plain),
                 "hash_leaves": (K.hash_leaves, K.hash_leaves_plain),
                 "merkle_levels": (K.merkle_levels, K.merkle_levels_plain)}


SHAPE_MARK = "@shape"  # a helper's line announcing a shape its path fed


class _ShapeLog:
    """Records the shapes of every K2c entry call that prover/ntt makes and
    every K1 Merkle entry call that prover/merkle makes (a measurement hook
    of this script only: it wraps the names those modules call, so the
    wrappers and their launch counts are untouched).  Each new shape is
    also printed on a SHAPE_MARK line, for the main process to check while
    the path runs."""

    def __init__(self):
        self.keys = set()

    def _recorded(self, entry, fn):
        def call(*args):
            key = _shape_key(entry, args)
            if key not in self.keys:
                self.keys.add(key)
                print(f"{SHAPE_MARK} {json.dumps(key)}", flush=True)
            return fn(*args)

        return call

    def __enter__(self):
        self._ntt = {e: getattr(ntt, e) for e in ("ntt_four_step_t", "lde_t", "coset_intt_t")}
        for e, fn in self._ntt.items():
            setattr(ntt, e, self._recorded(e, fn))
        self._k1 = merkle.k1
        merkle.k1 = SimpleNamespace(
            hash_leaves=self._recorded("hash_leaves", K.hash_leaves),
            merkle_levels=self._recorded("merkle_levels", K.merkle_levels))
        return self

    def __exit__(self, *exc):
        for e, fn in self._ntt.items():
            setattr(ntt, e, fn)
        merkle.k1 = self._k1


def phase_builds():
    """Every kernel built from the sources in this checkout, one nvcc each,
    all at once."""
    t0 = time.perf_counter()
    mods = (("K1", K), ("K2", N), ("K2c", T), ("P1", PC))
    with ThreadPoolExecutor(len(mods)) as ex:
        builds = {name: ex.submit(mod.build) for name, mod in mods}
        builds = {name: f.result() for name, f in builds.items()}
    print(f"kernel builds: {time.perf_counter() - t0:.3f} s wall together")
    return builds


def phase_toolchain(card, builds):
    """The toolchain's versions, each build's ptxas lines and each kernel's
    SASS counts (`cuobjdump`, one process per library, all at once).
    Returns the lines to print and the counts: it runs in a thread beside
    the kernel phases, which print their own lines meanwhile."""
    lines = [card, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                   f"python {sys.version.split()[0]}"]
    nvcc = subprocess.run([_nvcc.nvcc(), "--version"], capture_output=True, text=True)
    lines.append("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    with ThreadPoolExecutor(len(builds)) as ex:
        sass = dict(zip(builds, ex.map(lambda b: _nvcc.sass_counts(b.path), builds.values())))
    for name, built in builds.items():
        lines.append(f"{name} build: nvcc {built.seconds:.3f} s -> "
                     f"{os.path.relpath(built.path)}")
        for line in built.log.splitlines():
            if ("registers" in line or "spill" in line or "entry function" in line) and \
                    (name != "P1" or "_Z" not in line):
                lines.append("  ptxas: " + line.strip())
        for fn, (n_sass, n_mul) in sass[name].items():
            if name != "P1":
                lines.append(f"  sass: {fn}: {n_sass} instructions, {n_mul} integer multiplies")
    return lines, sass


def phase_probe(card):
    """P1: each primitive's cost on the card (the slope of time against
    chain length over 2^23 elements), every chain bit for bit against its
    plain twin.  Returns the kernel record at mul_lazy, k = 128, the product
    the redesigned K1 and K2c are built on."""
    _reset_counts()
    table, err = PC.measure()
    launches = PC.probe.launches
    if launches == 0:
        _fail("the probe did not launch its kernel")
    PC.print_table(table, card)
    for op in ("add_lazy", "sub_lazy", "mul_lazy", "sqr_lazy"):
        print(f"P1 {op}: carry chains {table[op]['int_instr_per_op']:.2f}, compare and select "
              f"{table[op + '_sel']['int_instr_per_op']:.2f} int instructions/op")
    a, b = PC.inputs("cuda")
    plain_ms = _time_ms(lambda: PC.probe_plain("mul_lazy", 128, a, b), 2)
    bound_ms, bound_by = _bound(3 * 8 * PC.N, 128 * PC.N * MUL64_ISSUES)
    record = {"ms": table["mul_lazy"]["ms"][128], "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "launches": launches,
              "max_abs_err": err, "op": "mul_lazy", "k": 128, "elements": PC.N,
              "by_op": {op: {"ns_per_pass": row["ns_per_pass"], "gops": row["gops"],
                             "int_instr_per_op": row["int_instr_per_op"]}
                        for op, row in table.items()}}
    print(f"P1 record: mul_lazy x128 over {PC.N} elements {record['ms']:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); {launches} "
          f"launches, all bit-exact; {card}")
    return record


def phase_k1(card):
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
        a = K.permute_planar(xs)
        b, p_ms = _plain_timed(lambda: K.permute_planar_plain(xs), 5)
        if not torch.equal(a, b):
            _fail(f"K1 disagrees with its plain version at {lanes} lanes")
        del a, b
        k_ms = _time_ms(lambda: K.permute_planar(xs), 50 if lanes <= n else 10)
        bound_ms, bound_by = _bound(lanes * 12 * 8 * 2, lanes * P2_ISSUES)
        timings[lanes] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}
        print(f"K1 at {lanes} lanes: kernel {k_ms:.4f} ms "
              f"({lanes / k_ms / 1e3:.1f}M perms/s), plain {p_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), identical; {card}")
    return err, timings


def _old_tree(lde, cap):
    """The prover's Merkle tree before K1's entries: the plain twins'
    composition (bit-reverse the points, transpose, sponge each leaf, hash
    each level) on the permutation kernel, one launch per absorption and per
    level, the yardstick the entries replaced."""
    digests = K.hash_leaves_plain(lde, K.permute_planar)
    return [digests] + K.merkle_levels_plain(digests, cap, K.permute_planar)


def _new_tree(lde, cap):
    digests = K.hash_leaves(lde)
    return [digests] + K.merkle_levels(digests, cap)


def _plain_tree(lde, cap):
    digests = K.hash_leaves_plain(lde)
    return [digests] + K.merkle_levels_plain(digests, cap)


def phase_k1_merkle(card):
    """K1's leaf-hash and level entries at the prover's tree shapes against
    their plain twins and the sponge-by-permutation composition they
    replaced, bit for bit; K1 launches per tree; times of all three."""
    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    # wire trees of a B=16 wrap batch (2^13 rows, LDE 2^16) and a B=8
    # aggregation batch (2^14 rows, LDE 2^17) at test_config (cap 1), of
    # one rows or block_leaf member (2^15 rows, LDE 2^18) and one
    # block_parent (2^16 rows, LDE 2^19), and of a light tree-node batch
    # (B=32, 16 rows, LDE 128 points)
    shapes = [(f"tree ({batch}*{WIRES}, 2^{log_m})", batch, log_m, 1)
              for batch, log_m in ((16, 16), (8, 17), (1, 18), (1, 19), (LIGHT_BATCH, 7))]
    timings, err = {}, 0
    for name, batch, log_m, cap in shapes:
        m = 1 << log_m
        lde = _rand_rows(rng, (batch, WIRES, m), dev)
        before = K.launches()
        new = _new_tree(lde, cap)
        torch.cuda.synchronize()
        k1_launches = K.launches() - before
        plain, plain_ms = _timed_once(lambda: _plain_tree(lde, cap))
        old = _old_tree(lde, cap)
        for a, b, c in zip(new, plain, old, strict=True):
            err = max(err, _max_abs_err(a, b))
            if not (torch.equal(a, b) and torch.equal(a, c)):
                _fail(f"K1's Merkle entries disagree with their plain twins or the old "
                      f"composition at {name}")
        del plain, old
        new_ms = _time_ms(lambda: _new_tree(lde, cap), 10)
        old_ms = _time_ms(lambda: _old_tree(lde, cap), 5)
        perms = batch * m * -(-WIRES // 8) + batch * (m - (1 << cap))
        out_words = 4 * batch * (2 * m - (1 << cap))
        bound_ms, bound_by = _bound(8 * (batch * WIRES * m + out_words), perms * P2_ISSUES)
        timings[name] = {"ms": new_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "sponge_composition_ms": old_ms,
                         "k1_launches": k1_launches, "permutations": perms}
        print(f"K1 Merkle entries at {name}, cap {cap}: {k1_launches} launches, "
              f"{new_ms:.4f} ms ({perms / new_ms / 1e3:.1f}M perms/s); sponge-by-"
              f"permutation composition {old_ms:.4f} ms; plain {plain_ms:.4f} ms; "
              f"bound {bound_ms:.4f} ms ({bound_by}); identical; {card}")
        if log_m == 16 and k1_launches > 3:
            _fail(f"the {name} tree took {k1_launches} K1 launches, more than 3")
        del lde
        torch.cuda.empty_cache()
    return err, timings


def _k2_work(rows, n, twiddle_rows, scale):
    """(bytes, multiplier issues) of one ntt_rows call, as the function
    needs them: the rows and the twiddle read once, the rows written once
    (the kernel's own pass table is its design's choice, not counted)."""
    log_n = n.bit_length() - 1
    nbytes = 16 * rows * n + 8 * twiddle_rows * n
    muls = rows * _dit_muls(log_n) + rows * n * ((twiddle_rows > 0) + scale)
    return nbytes, muls * MUL64_ISSUES


def phase_k2(card):
    """K2 against its plain version, bit for bit, at every log n from 1 to
    14 with every flag; times at the prover's shapes."""
    rng = np.random.default_rng(2)
    dev = torch.device("cuda")
    err, checks = 0, 0
    flag_sets = [{}, {"scale": True}, {"bitrev_input": True}, {"twiddle": 4},
                 {"twiddle": 4, "scale": True, "bitrev_input": True}]
    for log_n in range(1, N.MAX_LOG_N + 1):
        n = 1 << log_n
        # several blocks of 2048 // n rows, the last one ragged at n <= 256;
        # a multiple of 4 so the 4-row twiddle tiles them
        rows = 12 if n >= 2048 else 4 * (2048 // n) + 4
        x = _rand_rows(rng, (rows, n), dev)
        tw = _rand_rows(rng, (4, n), dev)
        for inverse in (False, True):
            for flags in flag_sets:
                kw = dict(flags)
                if "twiddle" in kw:
                    kw["twiddle"] = tw
                got = N.ntt_rows(x, inverse, **kw)
                want = N.ntt_rows_plain(x, inverse, **kw)
                err = max(err, _max_abs_err(got, want))
                checks += 1
                if not torch.equal(got, want):
                    _fail(f"K2 disagrees with its plain version at n=2^{log_n}, "
                          f"inverse={inverse}, flags={sorted(flags)}")
    print(f"K2 vs plain: {checks} cases, log n 1..14, both directions, flags "
          f"none/scale/bitrev_input/twiddle/all; max_abs_err {err} "
          f"(tolerance 0: bit-exact)")

    # the prover's shapes: wire iNTT of a B=16 batch of 2^13-row wraps and a
    # B=8 batch of 2^14-row aggregations; the bitrev_input flag alone (K2d)
    shapes = [(f"iNTT ({batch}*{WIRES}, 2^{log_n})", batch * WIRES, log_n,
               {"scale": True}, True) for batch, log_n in ((16, 13), (8, 14))]
    shapes.append((f"bitrev_input (16*{WIRES}, 2^13)", 16 * WIRES, 13,
                   {"bitrev_input": True}, False))
    timings = {}
    for name, rows, log_n, kw, inverse in shapes:
        n = 1 << log_n
        x = _rand_rows(rng, (rows, n), dev)
        got = N.ntt_rows(x, inverse, **kw)
        want, p_ms = _plain_timed(lambda: N.ntt_rows_plain(x, inverse, **kw), 2)
        if not torch.equal(got, want):
            _fail(f"K2 disagrees with its plain version at {name}")
        del got, want
        k_ms = _time_ms(lambda: N.ntt_rows(x, inverse, **kw), 20)
        bound_ms, bound_by = _bound(*_k2_work(rows, n, 0, kw.get("scale", False)))
        timings[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        print(f"K2 at {name}: kernel {k_ms:.4f} ms ({rows * n / k_ms / 1e6:.3f}G "
              f"points/s), plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), identical; {card}")
        del x
        torch.cuda.empty_cache()

    # the LDE and coset-iNTT entries: every output size, rates 1 and 3,
    # against their plain twins; then timed at the tree node's wire LDE
    # (16 -> 128 points) and quotient coset iNTT, and at 2^13 points
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    checks = 0
    for log_n in range(1, N.MAX_LOG_N + 1):
        rows = 12 if log_n >= 11 else 4 * (2048 >> log_n) + 3
        x = _rand_rows(rng, (rows, 1 << log_n), dev)
        cases = [("coset_intt", x, N.coset_intt_rows(x, shift),
                  N.coset_intt_rows_plain(x, shift))]
        for rate in (1, 3) if log_n >= 3 else (1,):
            c = x[:, : 1 << (log_n - rate)].contiguous()
            cases.append((f"lde rate {rate}", c, N.lde_rows(c, rate, shift),
                          N.lde_rows_plain(c, rate, shift)))
        for kind, inp, got, want in cases:
            err = max(err, _max_abs_err(got, want))
            checks += 1
            if not torch.equal(got, want):
                _fail(f"K2's {kind} entry disagrees with its plain twin at 2^{log_n}")
            if kind.startswith("lde") and not torch.equal(
                    N.coset_intt_rows(got, shift)[:, : inp.shape[1]], inp):
                _fail(f"coset_intt_rows(lde_rows(c)) != c at 2^{log_n}")
    print(f"K2 entries vs plain: {checks} cases (coset iNTT and LDE at rates 1 and 3, "
          f"log n 1..14), coset_intt(lde(c)) == c; max_abs_err {err} (tolerance 0: "
          f"bit-exact)")
    entries = [(f"LDE ({batch}*{WIRES}, 2^{log_n - 3} -> 2^{log_n})", batch * WIRES, log_n,
                "lde") for batch, log_n in ((LIGHT_BATCH, 7), (16, 13))]
    entries += [(f"coset iNTT ({batch}*2, 2^{log_n})", batch * 2, log_n, "coset_intt")
                for batch, log_n in ((LIGHT_BATCH, 7), (16, 13))]
    for name, rows, log_n, kind in entries:
        if kind == "lde":
            x = _rand_rows(rng, (rows, 1 << (log_n - 3)), dev)
            new = lambda: N.lde_rows(x, 3, shift)  # noqa: E731
            plain = lambda: N.lde_rows_plain(x, 3, shift)  # noqa: E731
            old = lambda: N.lde_rows_plain(x, 3, shift, N.ntt_rows)  # noqa: E731
        else:
            x = _rand_rows(rng, (rows, 1 << log_n), dev)
            new = lambda: N.coset_intt_rows(x, shift)  # noqa: E731
            plain = lambda: N.coset_intt_rows_plain(x, shift)  # noqa: E731
            old = lambda: N.coset_intt_rows_plain(x, shift, N.ntt_rows)  # noqa: E731
        want, p_ms = _plain_timed(plain, 2)
        if not torch.equal(new(), want) or not torch.equal(new(), old()):
            _fail(f"K2's {kind} entry disagrees with its plain twin or the old "
                  f"composition at {name}")
        del want
        k_ms = _time_ms(new, 20)
        old_ms = _time_ms(old, 20)
        bound_ms, bound_by = _bound(*_k2_entry_work(rows, log_n, kind))
        timings[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "composition_ms": old_ms}
        print(f"K2 {kind} entry at {name}: kernel {k_ms:.4f} ms, the composition it "
              f"replaced {old_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), identical; {card}")
        del x
    torch.cuda.empty_cache()
    return err, timings


def _k2_entry_work(rows, log_n, kind, rate=3):
    """(bytes, multiplier issues) of K2's LDE entry at `rate` (coefficients
    in, 2^log_n points out, a coset factor per coefficient after the first;
    the first `rate` stages of the transform only copy, the input being
    non-zero at one slot in 2^rate) or its coset-iNTT entry (a factor per
    point), as the function needs them, as `_k2c_entry_work` counts K2c's:
    the input read once and the output written once (the coset factors and
    the pass table are the kernel's tables, their products counted)."""
    n = 1 << log_n
    if kind == "lde":
        n_in = n >> rate
        nbytes = 8 * rows * (n_in + n)
        muls = _dit_muls(log_n, rate) + n_in - 1
    else:
        nbytes = 16 * rows * n
        muls = _dit_muls(log_n) + n
    return nbytes, rows * muls * MUL64_ISSUES


def _four_step_k2(x, inverse):
    """The four-step as the port ran it before K2c: K2's passes with torch
    transposes (the plain four-step's code with the kernel passes), the
    yardstick K2c replaced."""
    return T.ntt_four_step_plain(x, inverse, N.ntt_rows)


def _k2c_work(rows, n, inverse):
    """(bytes, multiplier issues) of one ntt_four_step_t call, as the
    function needs them: every input read once and every output written once
    (the kernel's passes move them two or three times, and its middle-
    twiddle and stage tables are its design's choice, their products
    counted); the products of a radix-2 transform of n points (as many as
    the four-step's passes and middle twiddles need), one for the scale of
    an inverse."""
    nbytes = 16 * rows * n
    muls = rows * _dit_muls(n.bit_length() - 1) + rows * n * inverse
    return nbytes, muls * MUL64_ISSUES


def phase_k2c(card):
    """K2c against its plain version, bit for bit: at every log n from 6 to
    10 (the sizes at which the CPU tests hold the plain version against the
    JAX kernel) and from 15 to 20, both directions, at B=1 and B=3, and at
    the slice's widths; a row also against the CPU.  Times at the LDE
    shapes, beside the plain four-step and the K2 + transpose composition."""
    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    err, checks = 0, 0
    for log_n in list(range(T.MIN_LOG_N, 11)) + list(range(15, 21)):
        for rows in (1, 3):
            x = _rand_rows(rng, (rows, 1 << log_n), dev)
            for inverse in (False, True):
                got = T.ntt_four_step_t(x, inverse)
                want = T.ntt_four_step_plain(x, inverse)
                err = max(err, _max_abs_err(got, want))
                checks += 1
                if not torch.equal(got, want):
                    _fail(f"K2c disagrees with its plain version at n=2^{log_n}, "
                          f"B={rows}, inverse={inverse}")
                if rows == 1 and not torch.equal(
                        got.cpu(), T.ntt_four_step_plain(x.cpu(), inverse)):
                    _fail(f"K2c at n=2^{log_n} disagrees with the CPU")
        if log_n >= 15 and not torch.equal(ntt.intt(ntt.ntt(x)), x):
            _fail(f"intt(ntt(x)) != x at 2^{log_n}")
    print(f"K2c vs plain: {checks} cases, log n 6..10 and 15..20, B=1 and 3, both "
          f"directions, B=1 also vs the CPU; max_abs_err {err} (tolerance 0: "
          f"bit-exact); intt(ntt(x)) == x from 2^15")

    # above 2^20 points: the prover's entries, three K2c launches each,
    # against the plain twins on the card
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    timings = {}
    for log_n in range(21, 25):
        rows = 2 if log_n < 24 else 1
        n = 1 << log_n
        x = _rand_rows(rng, (rows, n), dev)
        c = x[:, : n >> 3].contiguous()
        calls = [("ntt", lambda: ntt.ntt(x), lambda: T.ntt_four_step_plain(x, False)),
                 ("intt", lambda: ntt.intt(x), lambda: T.ntt_four_step_plain(x, True)),
                 ("lde", lambda: ntt.lde(c, 3, shift), lambda: T.lde_t_plain(c, 3, shift)),
                 ("coset_intt", lambda: ntt.coset_intt(x, shift),
                  lambda: T.coset_intt_t_plain(x, shift))]
        for kind, new, plain in calls:
            before = T.ntt_four_step_t.launches
            got = new()
            if T.ntt_four_step_t.launches != before + 3:
                _fail(f"prover/ntt.{kind} at 2^{log_n} did not take three K2c launches")
            want = plain()
            err = max(err, _max_abs_err(got, want))
            if not torch.equal(got, want):
                _fail(f"prover/ntt.{kind} disagrees with the plain twin at 2^{log_n}")
            del got, want
        name = f"transform ({rows}, 2^{log_n})"
        k_ms = _time_ms(lambda: ntt.ntt(x), 5)
        bound_ms, bound_by = _bound(*_k2c_work(rows, n, False))
        timings[name] = {"ms": k_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K2c at {name}, three passes {T.passes(log_n)}: kernel {k_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); ntt, intt, lde (rate 3) and coset_intt "
              f"identical to their plain twins; {card}")
        del x, c
        torch.cuda.empty_cache()
    print(f"K2c from 2^21 to 2^24: prover/ntt's ntt, intt, lde and coset_intt bit-exact, "
          f"max_abs_err {err}")

    # the slice's LDE shapes: B=16 batches of 2^13-row wraps (2^16 points),
    # B=8 aggregation members of 2^14 rows (2^17), a rows member of 2^15
    # rows (2^18); the wire iNTT of a 2^15-row member
    shapes = [(f"LDE ({batch}*{WIRES}, 2^{log_n})", batch * WIRES, log_n, False)
              for batch, log_n in ((16, 16), (8, 17), (1, 18))]
    shapes.append((f"iNTT (2*{WIRES}, 2^15)", 2 * WIRES, 15, True))
    for name, rows, log_n, inverse in shapes:
        n = 1 << log_n
        x = _rand_rows(rng, (rows, n), dev)
        got = T.ntt_four_step_t(x, inverse)
        want, p_ms = _plain_timed(lambda: T.ntt_four_step_plain(x, inverse), 2)
        err = max(err, _max_abs_err(got, want))
        if not torch.equal(got, want) or not torch.equal(got, _four_step_k2(x, inverse)):
            _fail(f"K2c disagrees with its plain version at {name}")
        del got, want
        k_ms = _time_ms(lambda: T.ntt_four_step_t(x, inverse), 20)
        old_ms = _time_ms(lambda: _four_step_k2(x, inverse), 20)
        bound_ms, bound_by = _bound(*_k2c_work(rows, n, inverse))
        timings[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "k2_transpose_ms": old_ms}
        print(f"K2c at {name}: kernel {k_ms:.4f} ms ({rows * n / k_ms / 1e6:.3f}G "
              f"points/s), K2 + torch transposes {old_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), identical; "
              f"{card}")
        del x
        torch.cuda.empty_cache()

    # the LDE and coset-iNTT entries at the paths' shapes (rate 3: the
    # coefficients of 2^13, 2^14, 2^15 rows and of a 2^16-row block_parent;
    # the quotient's coset iNTT of a B=16 and a B=8 batch and of one
    # block_leaf and one block_parent, 2 challenges), against their plain
    # twins and the compositions they replaced (pad + plain coset multiply
    # + K2c)
    entries = [(f"LDE ({batch}*{WIRES}, 2^{log_n - 3} -> 2^{log_n})", batch * WIRES,
                log_n, "lde") for batch, log_n in ((16, 16), (8, 17), (1, 18), (1, 19))]
    entries += [(f"coset iNTT ({batch}*2, 2^{log_n})", batch * 2, log_n, "coset_intt")
                for batch, log_n in ((16, 16), (8, 17), (1, 18), (1, 19))]
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    for name, rows, log_n, kind in entries:
        if kind == "lde":
            x = _rand_rows(rng, (rows, 1 << (log_n - 3)), dev)
            new = lambda: T.lde_t(x, 3, shift)  # noqa: E731
            plain = lambda: T.lde_t_plain(x, 3, shift)  # noqa: E731
            old = lambda: T.lde_t_plain(x, 3, shift, T.ntt_four_step_t)  # noqa: E731
        else:
            x = _rand_rows(rng, (rows, 1 << log_n), dev)
            new = lambda: T.coset_intt_t(x, shift)  # noqa: E731
            plain = lambda: T.coset_intt_t_plain(x, shift)  # noqa: E731
            old = lambda: T.coset_intt_t_plain(x, shift, T.ntt_four_step_t)  # noqa: E731
        got = new()
        want, p_ms = _plain_timed(plain, 2)
        err = max(err, _max_abs_err(got, want))
        if not torch.equal(got, want) or not torch.equal(got, old()):
            _fail(f"K2c's {kind} entry disagrees with its plain twin or the old "
                  f"composition at {name}")
        if kind == "coset_intt" and log_n == 16:
            x2 = T.lde_t(got[:, :1 << 13].contiguous(), 3, shift)
            if not torch.equal(T.coset_intt_t(x2, shift)[:, :1 << 13], got[:, :1 << 13]):
                _fail("coset_intt_t(lde_t(c)) != c")
        del got, want
        k_ms = _time_ms(new, 20)
        old_ms = _time_ms(old, 20)
        bound_ms, bound_by = _bound(*_k2c_entry_work(rows, log_n, kind))
        timings[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "composition_ms": old_ms}
        print(f"K2c {kind} entry at {name}: kernel {k_ms:.4f} ms, the composition it "
              f"replaced {old_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), identical; {card}")
        del x
        torch.cuda.empty_cache()
    return err, timings


def _k2c_entry_work(rows, log_n, kind, rate=3):
    """(bytes, multiplier issues) of an LDE at `rate` (coefficients in,
    2^log_n points out, a coset factor per coefficient after the first) or a
    coset iNTT (a factor per point) as the function needs them: the input
    read once and the output written once (the kernel's tables are its
    design's choice, their products counted).  The LDE's four-step: pass 1's
    columns of n1 points hold one coefficient in 2^rate, so its first `rate`
    stages only copy; then pass 2's columns and the middle twiddle, which is
    1 in the first row and column of the (n1, n2) view."""
    n = 1 << log_n
    log1, log2 = T.passes(log_n)  # two passes up to 2^20 points
    n1, n2 = 1 << log1, 1 << log2
    if kind == "lde":
        n_in = n >> rate
        nbytes = 8 * rows * (n_in + n)
        muls = (n2 * _dit_muls(log1, rate) + n1 * _dit_muls(log2) + (n - n1 - n2 + 1)
                + (n_in - 1))
    else:
        nbytes = 16 * rows * n
        muls = _dit_muls(log_n) + n
    return nbytes, rows * muls * MUL64_ISSUES


def _prove_and_verify(name, data, inputs, batch, launches):
    wits, pis = tree_node_batch(data, inputs, batch, 0)
    t0 = time.perf_counter()
    prove_batch(data, wits, pis)  # warm-up: lazy tables, kernel module load
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    _reset_counts()
    proofs = prove_batch(data, wits, pis)
    torch.cuda.synchronize()
    _read_counts(name, launches, ("K1", "K2"))
    ok = [verify(data, p) for p in proofs]
    print(f"{name}: B={batch}, warm-up {warm:.3f} s; verified {sum(ok)}/{batch}")
    if not all(ok):
        _fail(f"{name}: the port's verifier rejected a proof")
    return data, wits, pis


def phase_tree_nodes(card, dev, launches):
    """The map phase: tree-node batches at both shapes, the golden B=2."""
    with open(os.path.join(TESTDATA, "tree_node_golden.json")) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    data, inputs = _build_tree_node(test_config(), dev)
    print(f"tree_node circuit (test_config) built on the card in "
          f"{time.perf_counter() - t0:.3f} s: n={data.n}, "
          f"fixed_lde {tuple(data.fixed_lde.shape)}")
    if list(data.circuit_digest) != golden["circuit_digest"]:
        _fail("circuit digest differs from the JAX package's")
    light = _prove_and_verify("tree_node light B=32", data, inputs, LIGHT_BATCH, launches)

    # held against the JAX reference, kernel path and plain path
    wits, pis = tree_node_batch(data, inputs, golden["batch"], golden["seed"])
    digests = [proof_sha256(proof_to_dict(p)) for p in prove_batch(data, wits, pis)]
    if digests != golden["proof_sha256"]:
        _fail(f"B=2 proofs differ from the JAX golden digests: {digests}")
    # the plain paths on the card: every K1 and K2 entry by its plain twin
    entries = (K.hash_leaves, K.merkle_levels)
    p2.permute_planar = K.permute_planar_plain
    K.hash_leaves, K.merkle_levels = K.hash_leaves_plain, K.merkle_levels_plain
    before = [w.launches for w in KERNELS["K1"] + KERNELS["K2"]]
    try:
        with _plain_k2():
            plain = [proof_sha256(proof_to_dict(p)) for p in prove_batch(data, wits, pis)]
    finally:
        p2.permute_planar = K.permute_planar
        K.hash_leaves, K.merkle_levels = entries
    if [w.launches for w in KERNELS["K1"] + KERNELS["K2"]] != before:
        _fail("the plain-path prove launched a kernel")
    if plain != digests:
        _fail("the plain path on the card gives other proofs than the kernels")
    print(f"B=2 proofs on the card match the JAX golden digests "
          f"({', '.join(d[:12] for d in digests)}), kernel and plain path alike")

    data, inputs = _build_tree_node(CircuitConfig(), dev)
    production = _prove_and_verify("tree_node production B=8", data, inputs,
                                   PROD_BATCH, launches)
    return light, production


def phase_timing(card, shapes):
    """TIMED_BATCHES warm batches per shape and NTT route, all alternating in
    one process.  `shapes` maps a metric name to (data, witnesses, public
    inputs).  The `_plain_ntt` variants run the NTTs on their plain torch
    path (the route before K2), everything else as usual.  Prints each
    variant's walls, their median and quartiles, and the proofs/s at them."""
    variants = [(metric, route) for metric in shapes for route in ("", "_plain_ntt")]
    walls = {v: [] for v in variants}
    for i in range(TIMED_BATCHES):
        for metric, route in variants if i % 2 == 0 else variants[::-1]:
            with _plain_k2() if route else contextlib.nullcontext():
                t0 = time.perf_counter()
                prove_batch(*shapes[metric])
                torch.cuda.synchronize()
                walls[(metric, route)].append(time.perf_counter() - t0)
    for (metric, route), w in walls.items():
        batch = len(shapes[metric][2])
        q1, med, q3 = np.percentile(w, [25, 50, 75])
        name = metric + route
        print(f"{name} walls (s, B={batch}): {', '.join(f'{x:.4f}' for x in w)}")
        print(f"{name} {batch / med:.3f} at the median wall {med:.4f} s "
              f"(q1 {q1:.4f} s -> {batch / q1:.3f}, q3 {q3:.4f} s -> "
              f"{batch / q3:.3f}; {TIMED_BATCHES} batches); {card}")


def _leaf_build(b):
    """The framework's leaf member: PIs = H(x)."""
    x = b.add_input()
    b.register_public_inputs(b.hash_no_pad([x]))

    def assign(inputs, xv):
        inputs[x] = xv

    return assign


def _agg_build(b, children):
    """The 2-child aggregation member: PIs = H(h_left || h_right)."""
    left = children[0].public_inputs()[:4]
    right = children[1].public_inputs()[:4]
    b.register_public_inputs(b.hash_no_pad(left + right))


def _framework(name, cfg, dev, golden):
    """Declare, finalize and check a framework against the golden record."""
    t0 = time.perf_counter()
    fw = RecursionFramework(cfg, num_user_pis=4, set_height=2, device=dev)
    t_std = time.perf_counter() - t0
    fw.add_leaf_circuit("leaf", _leaf_build)
    fw.add_aggregation_circuit("node", 2, _agg_build)
    fw.finalize()
    chains = {m: [fw.members[m].data.n] + [wc.data.n for wc in
                                           fw._wrap_chain_for(fw.members[m].data)]
              for m in fw.member_order}
    print(f"{name} framework: standard shape in {t_std:.3f} s, finalized in "
          f"{time.perf_counter() - t0:.3f} s on the host and the card; standard "
          f"n={fw.standard.n}, wrap chains {chains}")
    if list(fw.set_digest) != golden["set_digest"] or fw.standard.n != golden["standard_n"]:
        _fail(f"{name}: set digest or standard n differs from the JAX package's")
    for m in fw.member_order:
        if list(fw.members[m].digest) != golden["member_digests"][m]:
            _fail(f"{name}: member {m}'s digest differs from the JAX package's")
    print(f"{name}: set digest {fw.set_digest[0]:#x}..., standard n and member "
          f"digests equal to the JAX package's")
    return fw


class _StageLog:
    """Counts every prove_batch of the recursion runtime, its batched paths
    and, through the serial `prove`, its serial ones: circuit n, B, wall,
    K1, K2 and K2c launches, and each stage's peak allocated and reserved
    card memory of this process (a measurement hook of this script only)."""

    def __init__(self):
        self.stages = []
        self._orig = batch_mod.prove_batch
        self._peak = 0

    def peak_gib(self):
        """The highest allocation of this process since the log opened."""
        return max(self._peak, torch.cuda.max_memory_allocated()) / 2**30

    def __enter__(self):
        torch.cuda.reset_peak_memory_stats()

        def counted(data, wits, pis):
            k = {name: _count(name) for name in PROVER_KERNELS}
            self._peak = max(self._peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            peaks = {"resident": (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())}

            def stage_done(stage):
                # the allocator counts on the host as work is queued: no sync
                seen = peaks.get(stage, (0, 0))  # a stage run once per chunk
                peaks[stage] = (max(seen[0], torch.cuda.max_memory_allocated()),
                                max(seen[1], torch.cuda.max_memory_reserved()))
                self._peak = max(self._peak, peaks[stage][0])
                torch.cuda.reset_peak_memory_stats()

            batch_mod.STAGE_HOOKS.append(stage_done)
            t0 = time.perf_counter()
            try:
                out = self._orig(data, wits, pis)
                torch.cuda.synchronize()
            finally:
                batch_mod.STAGE_HOOKS.remove(stage_done)
            self.stages.append({"n": data.n, "B": len(pis),
                                "s": time.perf_counter() - t0, "peaks": peaks,
                                **{name: _count(name) - k[name]
                                   for name in PROVER_KERNELS}})
            return out

        runtime.prove_batch = batch_mod.prove_batch = counted
        return self

    def __exit__(self, *exc):
        runtime.prove_batch = batch_mod.prove_batch = self._orig

    def print(self):
        """One line per prove_batch: n, B, wall, launches, then the
        allocated (reserved) GiB of this process before it and at the peak
        of each stage."""
        for st in self.stages:
            mem = ", ".join(f"{k} {a / 2**30:.2f} ({r / 2**30:.2f})"
                            for k, (a, r) in st["peaks"].items())
            print(f"  prove_batch n={st['n']} B={st['B']}: {st['s']:.3f} s, "
                  f"K1 {st['K1']}, K2 {st['K2']}, K2c {st['K2c']} launches; GiB {mem}")


def _two_leaves_one_aggregation(fw, values):
    hs = [list(p2h.hash_no_pad([v])) for v in values]
    leaves = fw.prove_leaves_batch("leaf", [(v,) for v in values], hs)
    agg_pis = list(p2h.hash_no_pad(hs[0] + hs[1]))
    (agg,) = fw.prove_aggregations_batch("node", [leaves], [()], [agg_pis])
    return hs, leaves, agg_pis, agg


def phase_recursion_light(card, fw, golden, launches):
    """The light framework's golden 2 leaves + 1 aggregation, then the timed
    TREE_LEAVES-leaf reduce tree."""
    # the golden inputs: 2 leaves + 1 aggregation, digests from the JAX package
    t0 = time.perf_counter()
    hs, leaves, agg_pis, agg = _two_leaves_one_aggregation(fw, golden["leaf_values"])
    torch.cuda.synchronize()
    got = [proof_sha256(proof_to_dict(e.proof)) for e in leaves]
    got_agg = proof_sha256(proof_to_dict(agg.proof))
    if hs != golden["leaf_public_inputs"] or agg_pis != golden["aggregation_public_inputs"]:
        _fail("light: the golden inputs differ")
    if got != golden["leaf_proof_sha256"] or got_agg != golden["aggregation_proof_sha256"]:
        _fail(f"light: envelope proofs differ from the JAX golden digests: {got}, {got_agg}")
    if not all(fw.verify(e) for e in leaves + [agg]):
        _fail("light: fw.verify rejected a golden-input envelope")
    print(f"light: 2 leaves + 1 aggregation in {time.perf_counter() - t0:.3f} s "
          f"(first use of each shape); envelope proofs equal to the JAX golden "
          f"digests ({', '.join(d[:12] for d in got + [got_agg])}); verified")

    # a TREE_LEAVES-leaf binary reduce tree (BASELINE config 3), batched per level
    values = list(range(TREE_LEAVES))
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    os.environ["MP2_TRACE"] = "1"  # the runtime's spans, one stderr line each
    _reset_counts()
    with _StageLog() as log:
        t0 = time.perf_counter()
        hs = [list(p2h.hash_no_pad([v])) for v in values]
        level = fw.prove_leaves_batch("leaf", [(v,) for v in values], hs)
        n_proofs = len(level)
        while len(level) > 1:
            pis = [list(p2h.hash_no_pad(hs[j] + hs[j + 1])) for j in range(0, len(hs), 2)]
            level = fw.prove_aggregations_batch(
                "node", [level[j:j + 2] for j in range(0, len(level), 2)],
                [()] * len(pis), pis)
            hs = pis
            n_proofs += len(level)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del os.environ["MP2_TRACE"]
    counts = _read_counts(f"recursion light tree ({TREE_LEAVES} leaves)", launches)
    root = level[0]
    if not fw.verify(root):
        _fail("light: fw.verify rejected the tree's root")
    if tuple(root.proof.public_inputs[-4:]) != fw.set_digest or root.user_inputs[:4] != hs[0]:
        _fail("light: the root's public inputs are not (tree hash, set digest)")
    spans = trace.report()
    wit_s = spans.get("witness_batch", (0, 0.0))[1]
    prove_s = sum(st["s"] for st in log.stages)
    print(f"light tree: {n_proofs} member proofs ({TREE_LEAVES} leaves, "
          f"{n_proofs - TREE_LEAVES} aggregations), each wrapped, in {wall:.3f} s; "
          f"root verified, trailing PIs = set digest")
    print(f"fixed_vk_tree_proofs_per_s {n_proofs / wall:.4f} ({n_proofs} member "
          f"proofs / {wall:.3f} s wall, wraps included); {card}")
    print(f"light tree time: prove_batch {prove_s:.3f} s ({prove_s / wall:.3f}), "
          f"witness generation {wit_s:.3f} s ({wit_s / wall:.3f}), other host work "
          f"(child witnesses, hashing, envelopes) {wall - prove_s - wit_s:.3f} s; "
          f"host share outside prove_batch {(wall - prove_s) / wall:.3f}; peak device "
          f"memory {log.peak_gib():.3f} GiB")
    log.print()
    return counts, n_proofs / wall


def phase_recursion_production(card, fw, launches):
    """2 leaves + 1 aggregation of the production framework, the root
    verified."""
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with _StageLog() as log:
        t0 = time.perf_counter()
        _, leaves, _, agg = _two_leaves_one_aggregation(fw, [11, 22])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _read_counts("recursion production (2 leaves + 1 aggregation)", launches)
    if not fw.verify(agg):
        _fail("production: fw.verify rejected the aggregation root")
    print(f"production: 2 leaves + 1 aggregation, each wrapped, in {wall:.3f} s "
          f"(first use of each shape); root verified; peak device memory "
          f"{log.peak_gib():.3f} GiB; {card}")
    log.print()


VDB_ROWS = 4  # rows inserted by one block; cut to keep the script in its time limit
VDB_COLUMNS = 3  # value columns of the table (cells per row)
SECONDARY_ID = 10  # column identifiers of the table
COLUMN_IDS = (11, 12, 13)
VDB_SETS = ("cells", "rows", "block", "ivc")
BLOCKS = 3  # blocks appended to the block tree over the row update's table
# each block's members in proving order: its block-tree plan, then the IVC step
BLOCK_MEMBERS = (("block_leaf", "ivc_first"), ("block_parent", "ivc_subsequent"),
                 ("block_leaf", "block_parent", "ivc_subsequent"))
BLOCK_INDEX_ID = 14  # column identifier of the block number
METADATA_INPUTS = (1, 2, 3)  # the IVC metadata hash is H(1, 2, 3)


def _vdb_sets(name, vdb, golden, sets=VDB_SETS):
    """Check the sets of `vdb` named `sets` against the golden record of the
    JAX package."""
    for set_name in sets:
        fw, g = getattr(vdb, set_name), golden[set_name]
        chains = {m: [fw.members[m].data.n] + [wc.data.n for wc in
                                               fw._wrap_chain_for(fw.members[m].data)]
                  for m in fw.member_order}
        print(f"{name} {set_name} set: standard n={fw.standard.n}, wrap chains {chains}")
        if list(fw.set_digest) != g["set_digest"] or fw.standard.n != g["standard_n"]:
            _fail(f"{name} {set_name}: set digest or standard n differs from the JAX package's")
        if chains != g["wrap_chain_n"]:
            _fail(f"{name} {set_name}: wrap chains differ from the JAX package's")
        for m in fw.member_order:
            if list(fw.members[m].digest) != g["member_digests"][m]:
                _fail(f"{name} {set_name}: member {m}'s digest differs from the JAX package's")
    digests = ", ".join(f"{s} {getattr(vdb, s).set_digest[0]:#x}..." for s in sets)
    print(f"{name}: set digests ({digests}), standard n, member digests and wrap chains "
          f"equal to the JAX package's")


def _row_chain(vdb, cells_values, secondary, rud, key):
    """A cells tree proved by prove_cells_tree, then rows_leaf over it (the
    serial path); returns every envelope in proving order, the rows leaf's
    public inputs and its payload."""
    proved = []
    prove_member = vdb.cells._prove_member

    def recording(m, inputs, user_pis):
        env = prove_member(m, inputs, user_pis)
        proved.append(env)
        return env

    vdb.cells._prove_member = recording  # a recording hook of this script only
    try:
        cells = build_cells_tree([Cell(i, v) for i, v in cells_values])
        cells_env = vdb.prove_cells_tree(cells)
    finally:
        vdb.cells._prove_member = prove_member
    db = new_row_tree()
    db.in_transaction(lambda t: t.store(key, RowPayload(
        secondary=Cell(*secondary), row_unique_data=rud, cells=cells)))
    payload = db.payload(key)
    pis = V.rows_pi_values(payload)
    row_env = vdb.rows.prove_aggregation(
        "rows_leaf", [], (payload.secondary, rud), pis, foreign_children=[cells_env])
    return proved + [row_env], pis, payload


def _rows_digest(rows):
    """The block's rows digest of a rows-tree root payload (no merge)."""
    return D.compute_final_digest(False, rows.individual_vd, rows.multiplier_vd,
                                  rows.multiplier_cnt)


def _block_ivc_chain(vdb, g, rows, rows_env):
    """block_leaf over a rows root (the golden chain's index id and block
    number), then ivc_first over it with the metadata hash H(golden inputs),
    on the serial path; returns both envelopes and their public inputs."""
    number, index_id = g["block_number"], g["block_index_id"]
    db = new_block_tree()
    db.in_transaction(lambda t: t.store(number, BlockPayload(
        index_id=index_id, block_number=number, rows_hash=rows.hash,
        rows_digest=_rows_digest(rows))))
    block = db.payload(number)
    block_pis = V.block_pi_values(block)
    block_env = vdb.block.prove_aggregation(
        "block_leaf", [], (index_id, number, False), block_pis, foreign_children=[rows_env])
    md = p2h.hash_no_pad(list(g["ivc_metadata_inputs"]))
    ivc_pis = V.ivc_pi_values(block.hash, md, number)
    ivc_env = vdb.ivc.prove_aggregation(
        "ivc_first", [], (md, number), ivc_pis, foreign_children=[block_env])
    return [block_env, ivc_env], [block_pis, ivc_pis]


def _vdb_table(seed):
    """The block's rows: U256 secondary index values and cell values from
    numpy, 4 random row-unique-data fields, keys (secondary value, 0)."""
    rng = np.random.default_rng(seed)

    def u256():
        return int.from_bytes(rng.bytes(32), "big")

    rows = {}
    for _ in range(VDB_ROWS):
        sec = u256()
        rud = tuple(int(v) for v in rng.integers(0, gl.P, size=4, dtype=np.uint64))
        cells = build_cells_tree([Cell(i, u256()) for i in COLUMN_IDS[:VDB_COLUMNS]])
        rows[(sec, 0)] = RowPayload(secondary=Cell(SECONDARY_ID, sec),
                                    row_unique_data=rud, cells=cells)
    return rows


def _cells_forest_plan(trees):
    """One workplan over the cells trees of many rows (keys (row key, node)):
    every tree's leaves are ready first, so each level of all trees is one
    batched call per member."""
    children, parent = {}, {}
    for rk, res in trees.items():
        parent[(rk, res.tree.root_inner())] = None
        for k in res.nodes:
            kids = [(rk, c) for c in res.tree.children_inner(k) if c is not None]
            children[(rk, k)] = kids
            parent.update((c, (rk, k)) for c in kids)
    return UpdateTree(root=None, children_map=children, parent_map=parent).into_workplan()


def _prove_row_update(vdb, db, plan):
    """The row-update path: every changed row's cells tree, level by level
    across rows, then the rows tree's update plan bottom-up, each ready
    group of same-circuit nodes in one batched call (MapReduceScheduler
    over prove_leaves_batch / prove_aggregations_batch)."""
    keys = sorted(plan.keys(), key=repr)
    trees = {rk: db.payload(rk).cells for rk in keys}
    envs = {}

    def cells_kind(key):
        rk, k = key
        node, tree = trees[rk].nodes[k], trees[rk].tree
        l, r = tree.children_inner(k)
        kids = [(rk, c) for c in (l, r) if c is not None]
        name = ("cells_leaf", "cells_partial", "cells_full")[len(kids)]
        pis = V.cells_pi_values(node.hash, node.split, node.individual_cnt,
                                node.multiplier_cnt)
        return name, (node.cell, kids, pis)

    def prove_cells(name, items):
        fw = vdb.cells
        args = [(cell,) for _, (cell, _, _) in items]
        pis = [p for _, (_, _, p) in items]
        if name == "cells_leaf":
            out = fw.prove_leaves_batch(name, args, pis)
        else:
            out = fw.prove_aggregations_batch(
                name, [[envs[c] for c in kids] for _, (_, kids, _) in items], args, pis)
        envs.update((key, env) for (key, _), env in zip(items, out))
        return out

    cells_envs, cells_stats = MapReduceScheduler(prove_cells).run(
        _cells_forest_plan(trees), cells_kind)
    roots = {rk: cells_envs[(rk, t.tree.root_inner())] for rk, t in trees.items()}

    def rows_kind(key):
        l, r = db.tree.children(key)
        payload = db.payload(key)
        kids = [c for c in (l, r) if c is not None]
        args = (payload.secondary, payload.row_unique_data)
        if len(kids) == 1:
            args += (l is not None,)
        name = ("rows_leaf", "rows_partial", "rows_full")[len(kids)]
        return name, (kids, args, V.rows_pi_values(payload), roots[key])

    def prove_rows(name, items):
        out = vdb.rows.prove_aggregations_batch(
            name, [[envs[c] for c in kids] for _, (kids, _, _, _) in items],
            [a for _, (_, a, _, _) in items], [p for _, (_, _, p, _) in items],
            foreign_children_list=[[cells] for _, (_, _, _, cells) in items])
        envs.update((key, env) for (key, _), env in zip(items, out))
        return out

    rows_envs, rows_stats = MapReduceScheduler(prove_rows).run(plan.into_workplan(), rows_kind)
    return cells_envs, rows_envs, cells_stats, rows_stats


def phase_vdb_light_setup(card, dev, golden):
    """The four sets at test_config() against the golden digests; returns
    the sets."""
    t0 = time.perf_counter()
    vdb = V.VerifiableDbCircuits(test_config(), device=dev)
    print(f"vdb light (test_config): the four sets built and finalized in "
          f"{time.perf_counter() - t0:.3f} s on the host and the card")
    _vdb_sets("vdb light", vdb, golden["light"])
    return vdb


def phase_vdb_chain(card, vdb, golden):
    """The golden 2-cell -> rows_leaf -> block_leaf -> ivc_first chain at
    test_config(), each envelope against the JAX package's proof."""
    g = golden["chain"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    envs, pis, rows = _row_chain(vdb, g["cells"], g["secondary"],
                                 tuple(g["row_unique_data"]), tuple(g["row_key"]))
    upper, upper_pis = _block_ivc_chain(vdb, g, rows, envs[-1])
    torch.cuda.synchronize()
    got = [proof_sha256(proof_to_dict(e.proof)) for e in envs]
    got_upper = [proof_sha256(proof_to_dict(e.proof)) for e in upper]
    if [e.member for e in envs] != g["members"] or pis != g["rows_leaf_public_inputs"]:
        _fail(f"vdb chain: members {[e.member for e in envs]} or rows_leaf PIs differ")
    if ([e.member for e in upper] != g["block_ivc_members"]
            or upper_pis != [g["block_leaf_public_inputs"], g["ivc_first_public_inputs"]]):
        _fail(f"vdb chain: members {[e.member for e in upper]} or block/IVC PIs differ")
    if got != g["proof_sha256"] or got_upper != g["block_ivc_proof_sha256"]:
        _fail(f"vdb chain: envelope proofs differ from the JAX golden digests: "
              f"{got + got_upper}")
    if not (vdb.cells.verify(envs[-2]) and vdb.rows.verify(envs[-1])
            and vdb.block.verify(upper[0]) and vdb.ivc.verify(upper[1])):
        _fail("vdb chain: fw.verify rejected the cells root, the rows leaf, the block "
              "leaf or the IVC proof")
    members = g["members"] + g["block_ivc_members"]
    print(f"vdb chain: {' -> '.join(members)} in {time.perf_counter() - t0:.3f} s "
          f"(serial prove); envelope proofs equal to the JAX golden digests "
          f"({', '.join(d[:12] for d in got + got_upper)}); verified; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def phase_vdb_update(card, vdb, launches):
    """One block inserts VDB_ROWS rows into an empty rows tree; the update is
    proved, timed and its root held against the host model."""
    db = new_row_tree()
    rows = _vdb_table(0)
    plan = db.in_transaction(lambda t: [t.store(k, v) for k, v in rows.items()])
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    os.environ["MP2_TRACE"] = "1"  # the runtime's spans, one stderr line each
    _reset_counts()
    with _StageLog() as log:
        t0 = time.perf_counter()
        cells_envs, rows_envs, cells_stats, rows_stats = _prove_row_update(vdb, db, plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del os.environ["MP2_TRACE"]
    counts = _read_counts(f"vdb row update ({VDB_ROWS} rows x {VDB_COLUMNS} cells)",
                          launches)
    n_proofs = len(cells_envs) + len(rows_envs)
    root = rows_envs[db.root()]
    if not vdb.rows.verify(root):
        _fail("vdb: fw.verify rejected the rows root")
    want = V.rows_pi_values(db.payload(db.root())) + list(vdb.rows.set_digest)
    if root.public_inputs != want:
        _fail("vdb: the rows root's public inputs differ from the host model's")
    spans = trace.report()
    wit_s = spans.get("witness_batch", (0, 0.0))[1]
    prove_s = sum(st["s"] for st in log.stages)
    print(f"vdb row update: {n_proofs} member proofs ({len(cells_envs)} cells, "
          f"{len(rows_envs)} rows), each wrapped, in {wall:.3f} s; rows root verified, "
          f"PIs = host model's root payload + set digest")
    print(f"vdb_row_update_proofs_per_s {n_proofs / wall:.4f} ({n_proofs} member "
          f"proofs / {wall:.3f} s wall, wraps included); {card}")
    print(f"vdb row update time: prove_batch {prove_s:.3f} s ({prove_s / wall:.3f}), "
          f"witness generation {wit_s:.3f} s ({wit_s / wall:.3f}), other host work "
          f"{wall - prove_s - wit_s:.3f} s; peak device memory "
          f"{log.peak_gib():.3f} GiB")
    for name, st in (("cells", cells_stats), ("rows", rows_stats)):
        print(f"vdb {name} schedule: levels {st.levels}, batches {st.batches}, "
              f"items {st.items}, max batch {st.max_batch}, per level {st.per_level_sizes}")
    log.print()
    return counts, db, root


def _prove_block_plan(vdb, block_db, plan, rows_env, envs):
    """A block-tree update plan bottom-up (the reference's
    `_prove_block_plan`, models/circuit_pipeline.py:311-340, without the
    extraction-bound members): a leaf, or a parent over its left child and
    its right child or, where there is none, the left one again; every node
    verifies its own rows root.  Each node is a batch of one; returns the
    (key, member) of each node in proving order."""
    nodes = []
    for key in plan.into_workplan():
        l, r = block_db.tree.children(key)
        payload = block_db.payload(key)
        args = (payload.index_id, payload.block_number)
        if l is None and r is None:
            name, kids = "block_leaf", []
        else:
            name, kids = "block_parent", [envs[l], envs[r if r is not None else l]]
            args += (r is not None,)
        (envs[key],) = vdb.block.prove_aggregations_batch(
            name, [kids], [args + (False,)], [V.block_pi_values(payload)],
            foreign_children_list=[[rows_env]])
        nodes.append((key, name))
    return nodes


def phase_vdb_block_ivc(card, vdb, rows_db, rows_env, launches):
    """BLOCKS blocks appended to an empty block tree over the row update's
    rows root (the table changes in no row, so no rows proof is re-run):
    each block's block-tree plan drained bottom-up, then an IVC step over
    the new block-tree root; timed, every root verified and held against
    the host model."""
    rows = rows_db.payload(rows_db.root())
    md = p2h.hash_no_pad(list(METADATA_INPUTS))
    block_db = new_block_tree()
    envs, ivc, proved, blocks, roots = {}, None, [], [], []
    torch.cuda.reset_peak_memory_stats()
    os.environ["MP2_TRACE"] = "1"  # the runtime's spans, one stderr line each
    _reset_counts()
    with _StageLog() as log:
        t0 = time.perf_counter()
        for number in range(1, BLOCKS + 1):
            tb, first_stage = time.perf_counter(), len(log.stages)
            trace.reset()
            plan = block_db.in_transaction(lambda t: t.store(number, BlockPayload(
                index_id=BLOCK_INDEX_ID, block_number=number, rows_hash=rows.hash,
                rows_digest=_rows_digest(rows))))
            nodes = _prove_block_plan(vdb, block_db, plan, rows_env, envs)
            root = block_db.payload(block_db.root())
            ivc_pis = V.ivc_pi_values(root.hash, md, number)
            if ivc is None:
                (ivc,) = vdb.ivc.prove_aggregations_batch(
                    "ivc_first", [[]], [(md, number)], [ivc_pis],
                    foreign_children_list=[[envs[block_db.root()]]])
            else:
                (ivc,) = vdb.ivc.prove_aggregations_batch(
                    "ivc_subsequent", [[ivc]], [(number,)], [ivc_pis],
                    foreign_children_list=[[envs[block_db.root()]]])
            torch.cuda.synchronize()
            wall_b = time.perf_counter() - tb
            roots.append((envs[block_db.root()], V.block_pi_values(root), ivc, ivc_pis))
            members = [name for _, name in nodes] + [ivc.member]
            proved += members
            prove_s = sum(st["s"] for st in log.stages[first_stage:])
            wit_s = trace.report().get("witness_batch", (0, 0.0))[1]
            blocks.append(f"block {number}: plan {[k for k, _ in nodes]}, "
                          f"{' + '.join(members)} in {wall_b:.3f} s: prove_batch "
                          f"{prove_s:.3f} s, witness generation {wit_s:.3f} s, other "
                          f"host work {wall_b - prove_s - wit_s:.3f} s")
        wall = time.perf_counter() - t0
    del os.environ["MP2_TRACE"]
    counts = _read_counts(f"vdb block tree + IVC ({BLOCKS} blocks)", launches)
    for block_env, block_pis, ivc_env, ivc_pis in roots:
        if not (vdb.block.verify(block_env) and vdb.ivc.verify(ivc_env)):
            _fail("vdb: fw.verify rejected a block-tree root or an IVC proof")
        if (block_env.public_inputs != block_pis + list(vdb.block.set_digest)
                or ivc_env.public_inputs != ivc_pis + list(vdb.ivc.set_digest)):
            _fail("vdb: a block-tree root's or an IVC proof's public inputs differ "
                  "from the host model's")
    want = [m for members in BLOCK_MEMBERS[:BLOCKS] for m in members]
    if proved != want:
        _fail(f"vdb: the block-tree and IVC steps proved {proved}, not {want}")
    prove_s = sum(st["s"] for st in log.stages)
    print(f"vdb block tree + IVC: {len(proved)} member proofs ({', '.join(proved)}), "
          f"each wrapped, in {wall:.3f} s; every block-tree root and IVC proof "
          f"verified, PIs = the host model's + set digest")
    print(f"vdb_block_ivc_proofs_per_s {len(proved) / wall:.4f} ({len(proved)} member "
          f"proofs / {wall:.3f} s wall, wraps included); {card}")
    for line in blocks:
        print(f"  {line}")
    print(f"vdb block tree + IVC time: prove_batch {prove_s:.3f} s "
          f"({prove_s / wall:.3f}); peak device memory "
          f"{log.peak_gib():.3f} GiB")
    log.print()
    return counts


def phase_vdb_production_setup(card, dev, golden):
    """The four sets at CircuitConfig() against the golden digests."""
    t0 = time.perf_counter()
    vdb = V.VerifiableDbCircuits(CircuitConfig(), device=dev)
    print(f"vdb production (CircuitConfig): the four sets built and finalized in "
          f"{time.perf_counter() - t0:.3f} s")
    _vdb_sets("vdb production", vdb, golden["production"])
    return vdb


def phase_vdb_production_chain(card, vdb, golden):
    """The 2-cell -> rows_leaf chain at CircuitConfig() proved and verified
    (cut there to keep the script in its time limit; the light chain goes
    on to block_leaf and ivc_first)."""
    g = golden["chain"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    envs, pis, _ = _row_chain(vdb, g["cells"], g["secondary"],
                              tuple(g["row_unique_data"]), tuple(g["row_key"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (vdb.cells.verify(envs[-2]) and vdb.rows.verify(envs[-1])):
        _fail("vdb production: fw.verify rejected the cells root or the rows leaf")
    if (pis != g["rows_leaf_public_inputs"]
            or envs[-1].public_inputs != pis + list(vdb.rows.set_digest)):
        _fail("vdb production: the rows leaf's PIs differ from the host model's")
    print(f"vdb production chain: {' -> '.join(e.member for e in envs)} in "
          f"{wall:.3f} s (serial prove, first use of each shape); cells root and rows "
          f"leaf verified; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {card}")


# the mapping table and chain of tests/test_circuit_pipeline.py:29-37 (chain 1,
# slot 4, blocks 100 and 101 as mp2_tpu/models/pipeline.py:139-182 builds them,
# here through the port's models.pipeline.make_chain), but not its contract:
# that test's ADDR (:19) is bytes(range(10, 30)), while this script,
# tests/test_extraction_circuits.py:23, tests/test_final_extraction.py:44 and
# the golden files (testdata/{extraction,final_extraction,pipeline}_golden.json)
# use bytes(range(20)); the golden files depend on it
PIPELINE_CONTRACT = bytes(range(20))
PIPELINE_CHAIN_ID = 1
PIPELINE_SLOT = 4
PIPELINE_BLOCKS = ({b"\x11": 100, b"\x22": 200}, {b"\x11": 150, b"\x22": 200, b"\x33": 50})
# block 101 applied as the indexer's first block: its storage trie, its state
# path (its state trie holds one account), header and final_simple; its rows
# tree (plan [(51, 0), (34, 0), (17, 0)]: each row's one-cell tree, then the
# row); the new block-tree leaf, bound to the extraction; the IVC step
EXTRACTION_PROOFS = ["leaf_mapping"] * 3 + ["branch2"] * 2
FINAL_EXTRACTION_PROOFS = ["account_leaf", "block", "final_simple"]
ROWS_PROOFS = ["cells_leaf", "rows_leaf"] + ["cells_leaf", "rows_partial"] * 2
PIPELINE_PROOFS = (EXTRACTION_PROOFS + FINAL_EXTRACTION_PROOFS + ROWS_PROOFS
                   + ["block_leaf_bound", "ivc_first"])
# apply_block's four steps, each by the sets that prove it
PIPELINE_STEPS = (("extraction", ("vx", "cx", "bx", "fx")), ("rows", ("cells", "rows")),
                  ("block node", ("block",)), ("IVC", ("ivc",)))


def _pipeline_chain():
    """The table's config and blocks 100 and 101."""
    cfg = MappingTableConfig(PIPELINE_CONTRACT, PIPELINE_CHAIN_ID, PIPELINE_SLOT)
    return cfg, make_chain(cfg, PIPELINE_BLOCKS)


def _set_record(fw):
    """A set's digest, standard n, member order and, per member, its digest,
    circuit digest, rows and wrap chain, as the golden records hold them."""
    return {"set_digest": list(fw.set_digest), "standard_n": fw.standard.n,
            "member_order": list(fw.member_order),
            "members": {m: {"digest": list(fw.members[m].digest),
                            "circuit_digest": list(fw.members[m].data.circuit_digest),
                            "n": fw.members[m].data.n,
                            "wrap_chain_n": [fw.members[m].data.n] + [
                                wc.data.n for wc in fw._wrap_chain_for(fw.members[m].data)]}
                        for m in fw.member_order}}


def _check_set(name, fw, g, wall):
    """Print a set's shape and fail unless its record equals the golden one."""
    rec = _set_record(fw)
    print(f"{name} set (test_config): built and finalized in {wall:.3f} s on the host and "
          f"the card; standard n={fw.standard.n}; members " + ", ".join(
              f"{m} {r['n']} rows, wrap chain {r['wrap_chain_n']}"
              for m, r in rec["members"].items()))
    for key in ("set_digest", "standard_n", "member_order"):
        if rec[key] != g[key]:
            _fail(f"{name}: the set's {key} differs from the JAX package's")
    for m, r in rec["members"].items():
        if r != g["members"][m]:
            _fail(f"{name}: member {m}'s digest, circuit digest, rows or wrap chain "
                  f"differ from the JAX package's")
    print(f"{name} set: set digest {fw.set_digest[0]:#x}..., standard n, member and "
          f"circuit digests, rows and wrap chains equal to the JAX package's")


INDEXER_SETS = ("ValuesExtractionCircuits", "ContractExtractionCircuits",
                "BlockExtractionFramework", "FinalExtractionCircuits", "VerifiableDbCircuits",
                "QueryCircuits")
PIPELINE_TABULAR_ROWS = 2  # the indexer of tests/test_circuit_pipeline.py
QUERY_SETS = ("row", "chunk", "revelation")
_QUERY_RANGE = "block >= $MIN_BLOCK AND block <= $MAX_BLOCK"
# tests/test_circuit_pipeline.py's three queries after block 101: (name, SQL,
# placeholders, the member proofs run_query asks for, the result rows)
PIPELINE_QUERIES = (
    ("aggregate", f"SELECT SUM(value), COUNT(*) FROM t WHERE {_QUERY_RANGE}",
     {"$MIN_BLOCK": 100, "$MAX_BLOCK": 101}, ["row_chunk", "revelation"], [[400, 3]]),
    ("empty_range", f"SELECT SUM(value), COUNT(*) FROM t WHERE {_QUERY_RANGE}",
     {"$MIN_BLOCK": 200, "$MAX_BLOCK": 210}, ["non_existence", "revelation"], [[0, 0]]),
    ("tabular", f"SELECT DISTINCT value FROM t WHERE {_QUERY_RANGE} AND value >= 150 LIMIT 2",
     {"$MIN_BLOCK": 100, "$MAX_BLOCK": 101}, ["row", "row", "revelation_tabular"],
     [[150], [200]]),
)
# the script proves the first two; the tabular query is proved by
# tests/test_torch_cuda.py::test_pipeline_tabular_query_on_card, which keeps
# the script inside its time limit on the slower hosts
SCRIPT_QUERIES = PIPELINE_QUERIES[:2]


@contextlib.contextmanager
def _timed_sets(walls, module=CP, names=INDEXER_SETS):
    """The wall of each set that `module` builds, by class, one per build in
    order (a measurement hook of this script only: it wraps the
    constructors models/circuit_pipeline or api calls)."""
    saved = {name: getattr(module, name) for name in names}

    def timed(name, cls):
        def build(*args, **kw):
            t0 = time.perf_counter()
            out = cls(*args, **kw)
            walls.setdefault(name, []).append(time.perf_counter() - t0)
            return out

        return build

    for name, cls in saved.items():
        setattr(module, name, timed(name, cls))
    try:
        yield
    finally:
        for name, cls in saved.items():
            setattr(module, name, cls)


def phase_pipeline_setup(card, dev, cfg, block, xgolden, fgolden, vgolden, pgolden):
    """CircuitTableIndexer for the pipeline's mapping table at test_config()
    with two tabular rows (tests/test_circuit_pipeline.py's indexer) and its
    sets, built through _ensure_built on block 101's header as
    mp2_tpu/models/circuit_pipeline.py:128-154 builds them: the values,
    contract, block and final extraction sets against
    testdata/{extraction,final_extraction}_golden.json, the verifiable DB's
    cells and rows sets against vdb_golden.json's light ones, its block set
    (with block_leaf_bound and block_parent_bound over the final set) and IVC
    set, and the query sets over the IVC set (row, chunk, revelation)
    against pipeline_golden.json, each written by the JAX package.  Returns
    the indexer."""
    host = fgolden["host"]
    if ([cfg.key_id, cfg.value_id] != [xgolden["table"]["key_id"], xgolden["table"]["value_id"]]
            or cfg.block_id != host["table"]["block_id"]):
        _fail("pipeline: the table's column identifiers differ from the JAX package's")
    offsets = fixture_header_offsets(block.header_rlp)
    if block.header_rlp.hex() != host["header_rlp"] or offsets != host["header_offsets"]:
        _fail("pipeline: block 101's header or its offsets differ from the JAX package's")
    ix = CircuitTableIndexer(cfg, config=test_config(), tabular_rows=PIPELINE_TABULAR_ROWS,
                             device=dev)
    qp = pgolden["query"]["params"]
    if (dataclasses.asdict(ix.query_params)
            != {k: v for k, v in qp.items() if k not in ("row_tree_depth", "index_tree_depth",
                                                         "tabular_rows")}
            or [ix.row_tree_depth, ix.index_tree_depth, ix.tabular_rows]
            != [qp["row_tree_depth"], qp["index_tree_depth"], qp["tabular_rows"]]):
        _fail("pipeline: the indexer's query parameters differ from the JAX package's")
    walls = {}
    t0, c0 = time.perf_counter(), time.process_time()
    with _timed_sets(walls):
        ix._ensure_built(block.header_rlp)
    print(f"pipeline: CircuitTableIndexer._ensure_built in {time.perf_counter() - t0:.3f} s "
          f"({time.process_time() - c0:.3f} s of this process's CPU)")
    _check_set("extraction values", ix.vx.fw, xgolden["set"],
               walls["ValuesExtractionCircuits"][0])
    if list(ix.vx.fw.set_digest) != fgolden["sets"]["values_set_digest"]:
        _fail("pipeline: the values set differs from the one the JAX package's final set "
              "verifies")
    for name, fw, cls in (("contract", ix.cx.fw, "ContractExtractionCircuits"),
                          ("block", ix.bx.fw, "BlockExtractionFramework"),
                          ("final", ix.fx.fw, "FinalExtractionCircuits")):
        _check_set(f"extraction {name}", fw, fgolden["sets"][name], walls[cls][0])
    print(f"pipeline vdb (test_config, extraction=fx): the four sets built and finalized in "
          f"{walls['VerifiableDbCircuits'][0]:.3f} s")
    _vdb_sets("pipeline vdb", ix.vdb, vgolden["light"], ("cells", "rows"))
    if list(ix.fx.fw.set_digest) != pgolden["sets"]["final_set_digest"]:
        _fail("pipeline: the final set differs from the one the JAX package's block set "
              "verifies")
    for name in ("block", "ivc"):
        _check_set(f"pipeline vdb {name}", getattr(ix.vdb, name), pgolden["sets"][name],
                   walls["VerifiableDbCircuits"][0])
    print(f"pipeline query sets (test_config, over the IVC set, tree depth "
          f"{ix.row_tree_depth}, {ix.tabular_rows} tabular rows): built and finalized in "
          f"{walls['QueryCircuits'][0]:.3f} s")
    for name in QUERY_SETS:
        _check_set(f"pipeline query {name}", getattr(ix.qc, name), pgolden["query"][name],
                   walls["QueryCircuits"][0])
    return ix


@contextlib.contextmanager
def _member_log(fws, members, envs):
    """Each member proof of the frameworks `fws` on the serial path
    (prove_leaf, prove_aggregation): its framework's name, its wall, the
    time in witness generation (member and wraps) and its envelope (a
    measurement hook of this script only; the prove_batch share comes from a
    _StageLog around it).  `fws` maps a name to a framework."""
    clock = [0.0]
    generate_witness = CircuitData.generate_witness

    def timed_witness(data, inputs):
        t0 = time.perf_counter()
        try:
            return generate_witness(data, inputs)
        finally:
            clock[0] += time.perf_counter() - t0

    def logged(set_name, fw, prove_fn):
        def call(name, *args, **kw):
            t0, w0 = time.perf_counter(), clock[0]
            env = prove_fn(name, *args, **kw)
            torch.cuda.synchronize()
            members.append({"member": name, "set": set_name, "fw": fw,
                            "s": time.perf_counter() - t0, "witness_s": clock[0] - w0})
            envs.append((name, args, env))
            return env

        return call

    CircuitData.generate_witness = timed_witness
    for set_name, fw in fws.items():
        fw.prove_leaf = logged(set_name, fw, fw.prove_leaf)
        fw.prove_aggregation = logged(set_name, fw, fw.prove_aggregation)
    try:
        yield
    finally:
        CircuitData.generate_witness = generate_witness
        for fw in fws.values():
            del fw.prove_leaf, fw.prove_aggregation


def _member_stages(what, members, log):
    """Each member proof's prove_batch stages in the log: its own and its
    wraps' (the next 1 + wrap-chain-length stages)."""
    first, out = 0, []
    for m in members:
        data = m["fw"].members[m["member"]].data
        last = first + 1 + len(m["fw"]._wrap_chain_for(data))
        out.append(log.stages[first:last])
        first = last
    if first != len(log.stages):
        _fail(f"{what}: {len(log.stages)} prove_batch calls, not {first}")
    return out


def _print_members(what, members, log, wall):
    """Each member proof's wall split into prove_batch (the member's and its
    wraps', the next stages of the log), witness generation and other; then
    the path's split and each prove_batch's launches."""
    for m, own in zip(members, _member_stages(what, members, log)):
        data = m["fw"].members[m["member"]].data
        pb = sum(st["s"] for st in own)
        walls = " + ".join(f"{st['s']:.3f}" for st in own)
        ns = ", ".join(str(st["n"]) for st in own)
        print(f"  {m['member']} ({data.n} rows): {m['s']:.3f} s: prove_batch {pb:.3f} s "
              f"({walls} at n {ns}), witness generation {m['witness_s']:.3f} s, other "
              f"{m['s'] - pb - m['witness_s']:.3f} s")
    prove_s = sum(st["s"] for st in log.stages)
    wit_s = sum(m["witness_s"] for m in members)
    print(f"{what} time: prove_batch {prove_s:.3f} s ({prove_s / wall:.3f}), witness "
          f"generation {wit_s:.3f} s ({wit_s / wall:.3f}), other "
          f"{wall - prove_s - wit_s:.3f} s; peak device memory {log.peak_gib():.3f} GiB")
    log.print()


STEP_MARKS = ("_prove_extraction", "_prove_rows_plan", "_prove_block_plan")


@contextlib.contextmanager
def _step_marks(ix, marks):
    """When each of apply_block's steps ends, and when prove_trie starts and
    ends, on the host clock after a card sync (a measurement hook of this
    script only)."""
    def marked(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            marks[name + " start"] = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            marks[name] = time.perf_counter()
            return out

        return call

    for name in STEP_MARKS:
        setattr(ix, name, marked(name, getattr(ix, name)))
    ix.vx.prove_trie = marked("prove_trie", ix.vx.prove_trie)
    try:
        yield
    finally:
        for name in STEP_MARKS:
            delattr(ix, name)
        del ix.vx.prove_trie


def phase_pipeline_block(card, ix, cfg, block, xgolden, fgolden, pgolden, launches, shapes):
    """Block 101 through CircuitTableIndexer.apply_block as the indexer's
    first block (mp2_tpu/models/circuit_pipeline.py:182-340): its extraction
    (the storage trie through prove_trie, on the default path, then the
    state path, the header and final_simple), its rows tree (each row's
    cells tree, then the row), the block-tree leaf bound to the extraction
    (block_leaf_bound) and the IVC step (ivc_first), each member proof a
    batch of one, wrapped; timed.  Checked: the trie root verified and held
    against extract_storage_slots, the 0x11 leaf's envelope against the JAX
    package's proof; the account leaf's and the header's envelopes against
    the JAX package's proofs; final_simple verified, its PIs against the
    host models (extract_block, extract_contract, final_extraction) and the
    JAX package's, its metadata hash against the JAX package's; the rows
    root, block_leaf_bound and ivc_first verified, their PIs against the
    host models (rows_pi_values, block_pi_values, ivc_pi_values) and the
    JAX package's, the rows digest against final_simple's DV.  Each kernel
    shape the path feeds is announced (`shapes`, a _ShapeLog)."""
    g_trie = xgolden["trie"]
    if block.storage.root_hash().hex() != g_trie["root_hash"]:
        _fail("pipeline: block 101's trie has another root than the JAX package's")
    locations = {k: SK.mapping_location(cfg.slot, k) for k in sorted(block.entries)}
    values = XA.extract_storage_slots(block.storage, [cfg.column], [
        XA.SlotEntry(cfg.slot, loc, mapping_key=k, key_id=cfg.key_id)
        for k, loc in locations.items()])
    trie_pis = mpt_pi_values(values.node_hash, values.values_digest, values.metadata_digest,
                             values.n_leaves)
    if trie_pis != g_trie["host_root_public_inputs"]:
        _fail("pipeline: the host model's trie root PIs differ from the JAX package's")
    block_out = XA.extract_block(block.header_rlp)
    contract_out = XA.extract_contract(block.state, cfg.contract_address)
    final_out = XA.final_extraction(block_out, contract_out, values, block.storage.root_hash(),
                                    block.state.root_hash())
    final_host = (pack_bytes_be(final_out.block_hash) + pack_bytes_be(final_out.prev_block_hash)
                  + [final_out.block_number] + final_out.values_digest.to_fields()
                  + final_out.metadata_digest.to_fields() + [values.n_leaves])
    if final_host != fgolden["host"]["final_public_inputs"]:
        _fail("pipeline: the host models' final PIs differ from the JAX package's")

    fws = {"vx": ix.vx.fw, "cx": ix.cx.fw, "bx": ix.bx.fw, "fx": ix.fx.fw,
           **{name: getattr(ix.vdb, name) for name in VDB_SETS}}
    members, envs, marks = [], [], {}
    os.environ.pop("MP2_BATCH_LEAVES", None)  # the default path: one proof per trie node
    os.environ["MP2_TRACE"] = "1"  # the runtime's spans, one stderr line each
    _reset_counts()
    with _StageLog() as log, shapes, _member_log(fws, members, envs), \
            _step_marks(ix, marks):
        t0, c0 = time.perf_counter(), time.process_time()
        final_env = ix.apply_block(block)
        torch.cuda.synchronize()
        t_end, cpu = time.perf_counter(), time.process_time() - c0
    del os.environ["MP2_TRACE"]
    wall = t_end - t0
    _read_counts("pipeline block 101 (apply_block)", launches)
    proved = [m["member"] for m in members]
    if proved != PIPELINE_PROOFS:
        _fail(f"pipeline: apply_block proved {proved}, not {PIPELINE_PROOFS}")

    # the extraction: the checks of the trie, state path, header and final
    root_env = envs[len(EXTRACTION_PROOFS) - 1][2]
    root_pis = root_env.user_inputs
    paths = {k: block.storage.get_proof(loc) for k, loc in locations.items()}
    if not ix.vx.verify(root_env):
        _fail("pipeline: vx.verify rejected the trie root")
    if (root_pis[:31] != trie_pis or root_pis[95] != 0 or root_pis[30] != len(paths)
            or root_pis[:8] != pack_bytes_be(keccak256(paths[b"\x11"][0]))
            or root_env.public_inputs[-4:] != list(ix.vx.fw.set_digest)):
        _fail("pipeline: the trie root's PIs are not the host model's H, DV, DM, N with "
              "S = 0 and the set digest")
    gl_leaf = xgolden["leaf"]
    leaf_key = left_pad32(bytes.fromhex(gl_leaf["key"]))
    (leaf_env,) = [env for name, args, env in envs
                   if name == "leaf_mapping" and args[0][1] == leaf_key]
    leaf_sha = proof_sha256(proof_to_dict(leaf_env.proof))
    if leaf_env.public_inputs != gl_leaf["public_inputs"] or leaf_sha != gl_leaf["proof_sha256"]:
        _fail(f"pipeline: the 0x11 leaf's envelope differs from the JAX package's ({leaf_sha})")
    contract_env, block_env = (envs[len(EXTRACTION_PROOFS) + i][2] for i in (0, 1))
    if not (ix.cx.verify(contract_env) and ix.bx.verify(block_env)
            and ix.fx.verify(final_env)):
        _fail("pipeline: cx.verify, bx.verify or fx.verify rejected a proof")
    shas = []
    for name, env in (("account_leaf", contract_env), ("header", block_env)):
        g = fgolden["proofs"][name]
        sha = proof_sha256(proof_to_dict(env.proof))
        shas.append(sha)
        if env.public_inputs != g["public_inputs"] or sha != g["proof_sha256"]:
            _fail(f"pipeline: the {name} envelope differs from the JAX package's ({sha})")
    final_pis = final_env.user_inputs
    dm = (Point.from_fields(root_pis[19:30])
          + XM.contract_metadata_digest(cfg.contract_address))
    md_hash = D.block_metadata_hash(Point.from_fields(final_pis[XF.F_DM]), cfg.block_id)
    if (final_pis[:XF.NUM_FINAL_PIS] != final_host or final_pis[XF.F_BN] != block.number
            or final_pis[XF.F_N] != len(block.entries) or final_pis[XF.F_DV] != root_pis[8:19]
            or final_pis[XF.F_DM] != dm.to_fields()
            or final_env.public_inputs[-4:] != list(ix.fx.fw.set_digest)):
        _fail("pipeline: the final PIs are not the host models' (BH, PH, BN = 101, DV = the "
              "trie root's, DM = the trie root's + the contract's, N = 3) and the set digest")
    if list(md_hash) != fgolden["host"]["metadata_hash"]:
        _fail("pipeline: the metadata hash differs from the JAX package's")

    # the verifiable DB: the rows root, the bound block leaf, the IVC step
    g = pgolden["host"]["block_101_first"]
    rows_root = ix.rows_db.payload(ix.rows_db.root())
    rows_env = ix.rows_root_env[block.number]
    block_node = ix.block_db.payload(block.number)
    bound_env = ix.block_node_env[block.number]
    ivc_env = ix.ivc_env
    rows_pis = V.rows_pi_values(rows_root)
    bound_pis = V.block_pi_values(block_node)
    ivc_pis = V.ivc_pi_values(ix.block_db.payload(ix.block_db.root()).hash, md_hash,
                              block.number)
    if not (ix.vdb.rows.verify(rows_env) and ix.vdb.block.verify(bound_env)
            and ix.vdb.ivc.verify(ivc_env)):
        _fail("pipeline: the rows root, block_leaf_bound or ivc_first was rejected")
    if (bound_env.member != "block_leaf_bound" or ivc_env.member != "ivc_first"
            or ix.block_db.root() != block.number):
        _fail("pipeline: block 101 is not the block tree's bound leaf under ivc_first")
    if (rows_env.public_inputs != rows_pis + list(ix.vdb.rows.set_digest)
            or rows_pis != g["rows_root_public_inputs"]):
        _fail("pipeline: the rows root's PIs differ from the host model's or the JAX "
              "package's")
    if _rows_digest(rows_root).to_fields() != final_pis[XF.F_DV] or \
            final_pis[XF.F_DV] != g["rows_digest"]:
        _fail("pipeline: the rows digest differs from final_simple's DV")
    if (bound_env.public_inputs != bound_pis + list(ix.vdb.block.set_digest)
            or [bound_pis] != [r["public_inputs"] for r in g["block_plan"]]):
        _fail("pipeline: block_leaf_bound's PIs differ from the host model's or the JAX "
              "package's")
    if (ivc_env.public_inputs != ivc_pis + list(ix.vdb.ivc.set_digest)
            or ivc_pis != g["ivc_public_inputs"] or list(md_hash) != g["metadata_hash"]):
        _fail("pipeline: ivc_first's PIs differ from the host model's or the JAX package's")
    if (ix.proofs[("final_extraction", block.number)] is not final_env
            or ix.proofs[("ivc", block.number)] is not ivc_env):
        _fail("pipeline: the indexer's proof store lacks the final or the IVC envelope")

    trie_wall = marks["prove_trie"] - marks["prove_trie start"]
    ends = [t0] + [marks[name] for name in STEP_MARKS] + [t_end]
    n_ext = len(EXTRACTION_PROOFS) + len(FINAL_EXTRACTION_PROOFS)
    print(f"pipeline block 101: apply_block proved {len(proved)} member proofs "
          f"({', '.join(proved)}), each wrapped, in {wall:.3f} s; the trie root verified, PIs "
          f"0..30 = extract_storage_slots's (N {root_pis[30]}), S {root_pis[95]}; the 0x11 "
          f"leaf's, account_leaf's and header's envelopes equal to the JAX package's "
          f"({', '.join(s[:12] for s in [leaf_sha] + shas)}); cx, bx, fx verified, final PIs "
          f"= the host models' and the JAX package's (block {final_pis[XF.F_BN]}, N "
          f"{final_pis[XF.F_N]}), metadata hash {md_hash[0]:#x}... equal to the JAX "
          f"package's; the rows root, block_leaf_bound and ivc_first verified, their PIs = "
          f"the host models' and the JAX package's, the rows digest = final_simple's DV")
    print(f"extraction_storage_proofs_per_s {len(EXTRACTION_PROOFS) / trie_wall:.4f} "
          f"({len(EXTRACTION_PROOFS)} member proofs / {trie_wall:.3f} s wall of prove_trie, "
          f"wraps included); {card}")
    print(f"extraction_block_proofs_per_s {n_ext / (ends[1] - t0):.4f} ({n_ext} member "
          f"proofs of block 101's extraction / {ends[1] - t0:.3f} s wall: the storage trie "
          f"{trie_wall:.3f} s, the state path, header and final_simple "
          f"{ends[1] - t0 - trie_wall:.3f} s; wraps included); {card}")
    print(f"pipeline_block_proofs_per_s {len(proved) / wall:.4f} ({len(proved)} member proofs "
          f"/ {wall:.3f} s wall of apply_block, wraps included; {cpu:.3f} s of this process's "
          f"CPU); {card}")
    stages = _member_stages("pipeline block 101", members, log)
    for (step, sets), t_a, t_b in zip(PIPELINE_STEPS, ends, ends[1:]):
        own = [(m, st) for m, st in zip(members, stages) if m["set"] in sets]
        pb = sum(s["s"] for _, st in own for s in st)
        wit = sum(m["witness_s"] for m, _ in own)
        print(f"pipeline block 101, {step}: {len(own)} member proofs in {t_b - t_a:.3f} s: "
              f"prove_batch {pb:.3f} s, witness generation {wit:.3f} s, other "
              f"{t_b - t_a - pb - wit:.3f} s")
    _print_members("pipeline block 101", members, log, wall)


def _query_result_record(res):
    """A QueryResult as the golden record holds it."""
    return {"rows": [[int(v) for v in r] for r in res.rows],
            "num_matching_rows": int(res.num_matching_rows), "overflow": bool(res.overflow),
            "computational_hash": [int(v) for v in res.computational_hash],
            "placeholder_hash": [int(v) for v in res.placeholder_hash],
            "chunks": [[list(k) for k in c] for c in res.chunks]}


def phase_pipeline_queries(card, ix, pgolden, launches, shapes, queries=SCRIPT_QUERIES):
    """`queries` of tests/test_circuit_pipeline.py (PIPELINE_QUERIES) through
    CircuitTableIndexer.run_query after block 101 (mp2_tpu/models/
    circuit_pipeline.py:341-435): the aggregate over blocks [100, 101] (one
    row_chunk of block 101's three rows, then revelation), the same over the
    empty range [200, 210] (non_existence over the block tree, then
    revelation) and the tabular DISTINCT ... LIMIT 2 (two tree-bound row
    proofs, then revelation_tabular); each member proof a batch of one,
    wrapped; each call timed on the host clock to a card sync.  Checked:
    each revelation verified by ix.verify, its member, its revealed values
    (the computational and placeholder hashes, the IVC proof's block-tree
    root, the result) and every member proof's PIs against the JAX
    package's (pipeline_golden.json), the QueryResult against the JAX
    package's, the revealed block root against ivc_first's.  Each kernel
    shape the path feeds that block 101's did not is announced."""
    g_all = pgolden["query"]["block_101_first"]
    fws = {name: getattr(ix.qc, name) for name in QUERY_SETS}
    members, envs, calls = [], [], []
    _reset_counts()
    with _StageLog() as log, shapes, _member_log(fws, members, envs):
        for name, sql, values, _, _ in queries:
            first = len(members)
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            res, env, reveal = ix.run_query(sql, Placeholders(dict(values)))
            torch.cuda.synchronize()
            calls.append((name, res, env, reveal, first, len(members),
                          time.perf_counter() - t0, time.process_time() - c0))
    _read_counts(f"pipeline queries (run_query x{len(queries)})", launches)
    stages = _member_stages("pipeline queries", members, log)
    ivc_root = ix.ivc_env.user_inputs[0:4]
    for (name, sql, values, want_members, want_rows), call in zip(queries, calls,
                                                                  strict=True):
        _, res, env, reveal, a, b, wall, cpu = call
        g = g_all[name]
        proved = [m["member"] for m in members[a:b]]
        if proved != want_members:
            _fail(f"pipeline query {name}: run_query proved {proved}, not {want_members}")
        if not ix.verify(env) or env.member != g["member"]:
            _fail(f"pipeline query {name}: the revelation ({env.member}) was rejected or is "
                  f"not the JAX package's {g['member']}")
        got = [(m["set"], m["member"], [int(v) for v in e.user_inputs])
               for m, (_, _, e) in zip(members[a:b], envs[a:b])]
        if got != [(c["set"], c["member"], c["user_pis"]) for c in g["calls"]]:
            _fail(f"pipeline query {name}: a member proof's PIs differ from the JAX package's")
        if ([int(v) for v in reveal] != g["reveal"] or list(env.user_inputs) != g["reveal"]
                or env.public_inputs[-4:] != list(ix.qc.revelation.set_digest)):
            _fail(f"pipeline query {name}: the revealed PIs differ from the JAX package's")
        if reveal[8:12] != ivc_root:
            _fail(f"pipeline query {name}: the revealed block root is not ivc_first's")
        if _query_result_record(res) != g["result"] or res.rows != want_rows:
            _fail(f"pipeline query {name}: the result {res.rows} differs from the JAX "
                  f"package's")
        own = stages[a:b]
        pb = sum(st["s"] for st_m in own for st in st_m)
        wit = sum(m["witness_s"] for m in members[a:b])
        print(f"pipeline query {name}: {sql!r} with {values}: rows {res.rows}; "
              f"{len(proved)} member proofs ({', '.join(proved)}), each wrapped, in "
              f"{wall:.3f} s ({cpu:.3f} s of this process's CPU): prove_batch {pb:.3f} s, "
              f"witness generation {wit:.3f} s, other {wall - pb - wit:.3f} s; {env.member} "
              f"verified, every member's PIs, the revealed values (block root "
              f"{reveal[8]:#x}... = ivc_first's) and the result equal to the JAX package's")
    total = sum(c[6] for c in calls)
    print(f"pipeline_query_proofs_per_s {len(members) / total:.4f} ({len(members)} member "
          f"proofs / {total:.3f} s summed wall of {len(queries)} run_query call(s), wraps "
          f"included); {card}")
    _print_members("pipeline queries", members, log, total)


def _shape_bound(entry, spec):
    """(least ms, what bounds it) of one recorded entry call, counted as the
    kernel phases count them: K2c's transform and entries by `_k2c_work`
    and `_k2c_entry_work`; K1's leaf hash as one sponge of ceil(C / 8)
    permutations per leaf of C > 4 values (hash_or_noop: none up to 4), the
    LDE read once and the digests written once; its levels as one
    permutation per node above the leaves down to the cap, the leaves read
    once and the nodes written once."""
    if entry == "ntt_four_step_t":
        (rows, n), inverse = spec
        return _bound(*_k2c_work(rows, n, inverse))
    if entry == "lde_t":
        (rows, n_in), rate, _ = spec
        return _bound(*_k2c_entry_work(rows, (n_in << rate).bit_length() - 1, "lde", rate))
    if entry == "coset_intt_t":
        (rows, n), _ = spec
        return _bound(*_k2c_entry_work(rows, n.bit_length() - 1, "coset_intt"))
    if entry == "hash_leaves":
        ((batch, cols, m),) = spec
        perms = batch * m * (-(-cols // 8) if cols > 4 else 0)
        return _bound(8 * (batch * cols * m + 4 * batch * m), perms * P2_ISSUES)
    (batch, m, _), cap = spec  # merkle_levels
    nodes = batch * (m - (1 << cap))
    return _bound(8 * 4 * (batch * m + nodes), nodes * P2_ISSUES)


def _shape_from_json(text):
    """A SHAPE_MARK line's key, with its lists back as tuples."""
    return tuple(tuple(a) if isinstance(a, list) else a for a in json.loads(text))


def check_shape(card, key, rng, dev):
    """One announced entry shape (SHAPE_MARK's key) on random input against
    its plain twin, bit for bit, timed (the plain twin once) beside its
    bound.  Returns (kernel, label, times, max_abs_err)."""
    entry, *spec = key
    kernel, plain = SHAPE_ENTRIES[entry]
    args = [_rand_rows(rng, a, dev) if isinstance(a, tuple) else a for a in spec]
    want, p_ms = _timed_once(lambda: plain(*args))
    got = kernel(*args)
    got, want = (got, want) if isinstance(got, list) else ([got], [want])
    err = 0
    for a, b in zip(got, want, strict=True):
        err = max(err, _max_abs_err(a, b))
        if not torch.equal(a, b):
            _fail(f"{entry} disagrees with its plain twin at {spec}")
    del got, want
    k_ms = _time_ms(lambda: kernel(*args), 5)
    del args
    bound_ms, bound_by = _shape_bound(entry, spec)
    print(f"pipeline shape {entry} {spec}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), identical; {card}", flush=True)
    kernel_name = "K1" if entry in ("hash_leaves", "merkle_levels") else "K2c"
    return kernel_name, f"{entry} {spec}", {"ms": k_ms, "plain_ms": p_ms,
                                            "bound_ms": bound_ms, "bound_by": bound_by}, err


def phase_pipeline_shapes(card, shapes, lanes):
    """Every K2c and K1 Merkle entry shape that the pipeline's and the
    merged table's paths fed, as their processes announce them (SHAPE_MARK
    lines on `shapes`, a queue of (flag, key), then (flag, None) when the
    process's output ends), each held once against its plain twin, bit for
    bit, and timed (the plain twin once) beside its bound.  It runs in the
    main process while the paths prove, until both processes' output ends.
    Returns the max_abs_err and, per process, the times by kernel of the
    shapes it announced (the merged path's: those the pipeline's did not)."""
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    err, checked, fed, running = 0, {}, {flag: [] for flag in SHAPE_FLAGS}, set(SHAPE_FLAGS)
    while running:
        try:
            flag, key = shapes.get(timeout=1.0)
        except queue.Empty:
            if lanes.failed:
                _fail(f"{lanes.failed} failed while the main process checked the shapes")
            continue
        if key is None:
            running.discard(flag)
            continue
        fed[flag].append(key)
        if key not in checked:
            checked[key] = check_shape(card, key, rng, dev)
            err = max(err, checked[key][3])
    if not fed[EXTRACTION_FLAG] or not fed[MERGED_FLAG]:
        _fail("the pipeline or the merged process announced no kernel shape")
    times = {}
    new = {EXTRACTION_FLAG: fed[EXTRACTION_FLAG],
           MERGED_FLAG: [k for k in fed[MERGED_FLAG] if k not in fed[EXTRACTION_FLAG]]}
    for flag, keys in new.items():
        for key in keys:
            kernel_name, label, rec, _ = checked[key]
            times.setdefault(flag, {}).setdefault(kernel_name, {})[label] = rec
    print(f"pipeline path: {len(fed[EXTRACTION_FLAG])} K2c and K1 Merkle entry shapes; merged "
          f"path: {len(fed[MERGED_FLAG])}, {len(new[MERGED_FLAG])} of them not the pipeline's "
          f"({', '.join(checked[k][1] for k in new[MERGED_FLAG]) or 'none'}); all "
          f"{len(checked)} held against their plain twins, max_abs_err {err} (tolerance 0: "
          f"bit-exact)")
    torch.cuda.empty_cache()
    return err, times


# the merged table of tests/test_merged_table.py:122-135 on the pipeline's
# contract, chain and mapping slot (the golden files depend on them), its
# total supply in slot 9: ERC-20 balances {0x11: 100, 0x22: 250} and supply
# 350 at block 100, {0x11: 120, 0x22: 250} and 370 at block 101.  The script
# proves block 100's extraction through the API; both blocks through
# MergedTableIndexer are tests/test_torch_cuda.py::test_merged_table_pipeline_on_card
MERGED_SINGLE_SLOT = 9
MERGED_BLOCKS = ({b"\x11": 100, b"\x22": 250}, {b"\x11": 120, b"\x22": 250})
MERGED_SUPPLY = (350, 370)
MERGED_ARITIES = (1, 2, 3)  # build_circuits_params's default branch members
# tests/test_merged_table.py:153-156's query over both blocks: 720 and 370
MERGED_QUERY = (f"SELECT SUM(value), MAX(supply) FROM t WHERE {_QUERY_RANGE}",
                {"$MIN_BLOCK": 100, "$MAX_BLOCK": 101})
# block 100's walks: both balances under one branch under the root, the
# supply's leaf under the root; then the account leaf, the header and the join
MERGED_PROOFS = ["leaf_mapping", "leaf_mapping", "branch2", "branch1", "leaf_single",
                 "branch1", "account_leaf", "block", "final_merge"]
API_SETS = ("ValuesExtractionCircuits", "ContractExtractionCircuits",
            "BlockExtractionFramework", "FinalExtractionCircuits", "VerifiableDbCircuits")


def _merged_chain():
    """The merged table's config and blocks 100 and 101."""
    cfg = MergedTableConfig(PIPELINE_CONTRACT, PIPELINE_CHAIN_ID, PIPELINE_SLOT,
                            single_slot=MERGED_SINGLE_SLOT)
    return cfg, make_chain(cfg, MERGED_BLOCKS, single_values=MERGED_SUPPLY)


def merged_sets_golden(mgolden, arities=MERGED_ARITIES):
    """merged_golden.json's set records at `arities`."""
    return mgolden["sets_" + "_".join(str(a) for a in arities)]


def phase_merged_setup(card, dev, cfg, block, xgolden, fgolden, vgolden, mgolden):
    """The merged table's sets through the API's entry point,
    api.build_circuits_params on block 100's header at test_config() (as
    mp2_tpu/api.py:64-103 builds them): the mapping table's values set,
    the supply's (`vx_b`: leaf_single, extension, branch members), the
    contract and block sets, the final set with `final_simple` and
    `final_merge` and the verifiable DB's four sets over it; each held
    against the JAX package's record (extraction_golden.json,
    final_extraction_golden.json, vdb_golden.json and merged_golden.json).
    Returns the PublicParameters."""
    g = mgolden["host"]["table"]
    if [cfg.key_id, cfg.value_id, cfg.supply_id, cfg.block_id] != [
            g[k] for k in ("key_id", "value_id", "supply_id", "block_id")]:
        _fail("merged: the table's column identifiers differ from the JAX package's")
    if fixture_header_offsets(block.header_rlp) != fgolden["host"]["header_offsets"]:
        _fail("merged: block 100's header offsets differ from those of the JAX package's "
              "block set")
    walls = {}
    t0, c0 = time.perf_counter(), time.process_time()
    with _timed_sets(walls, API, API_SETS):
        params = API.build_circuits_params(cfg, block.header_rlp, config=test_config(),
                                           branch_arities=MERGED_ARITIES, device=dev)
    print(f"merged: api.build_circuits_params in {time.perf_counter() - t0:.3f} s "
          f"({time.process_time() - c0:.3f} s of this process's CPU), branch arities "
          f"{MERGED_ARITIES}")
    gs = merged_sets_golden(mgolden)
    _check_set("merged values (mapping)", params.vx.fw, gs.get("vx", xgolden["set"]),
               walls["ValuesExtractionCircuits"][0])
    _check_set("merged values (single slot)", params.vx_b.fw, gs["vx_b"],
               walls["ValuesExtractionCircuits"][1])
    for name, fw, cls in (("contract", params.cx.fw, "ContractExtractionCircuits"),
                          ("block", params.bx.fw, "BlockExtractionFramework")):
        _check_set(f"merged extraction {name}", fw, fgolden["sets"][name], walls[cls][0])
    _check_set("merged final", params.fx.fw, gs["fx"], walls["FinalExtractionCircuits"][0])
    print(f"merged vdb (test_config, extraction=fx): the four sets built and finalized in "
          f"{walls['VerifiableDbCircuits'][0]:.3f} s")
    _vdb_sets("merged vdb", params.vdb, vgolden["light"], ("cells", "rows"))
    for name in ("block", "ivc"):
        _check_set(f"merged vdb {name}", getattr(params.vdb, name), gs[name],
                   walls["VerifiableDbCircuits"][0])
    return params


def _merged_host(cfg, block, h):
    """Block 100's host models (extract_storage_slots over each walk,
    extract_contract, extract_block), held against the JAX package's: each
    walk's root PIs (H, DV, DM, N), the account leaf's and the header's."""
    keys = sorted(block.entries)
    a = XA.extract_storage_slots(block.storage, [cfg.column], [
        XA.SlotEntry(cfg.slot, SK.mapping_location(cfg.slot, k), mapping_key=k,
                     key_id=cfg.key_id) for k in keys])
    b = XA.extract_storage_slots(block.storage, [cfg.single_column], [
        XA.SlotEntry(cfg.single_slot, SK.simple_slot_location(cfg.single_slot))])
    contract = XA.extract_contract(block.state, cfg.contract_address)
    out = XA.extract_block(block.header_rlp)
    host = {"values a": mpt_pi_values(a.node_hash, a.values_digest, a.metadata_digest,
                                      a.n_leaves),
            "values b": mpt_pi_values(b.node_hash, b.values_digest, b.metadata_digest,
                                      b.n_leaves),
            "contract": XF.contract_pi_values(contract.node_hash, contract.storage_root,
                                              contract.metadata_digest,
                                              XF.host_key_nibbles(cfg.contract_address), 0),
            "block": (pack_bytes_be(out.block_hash) + pack_bytes_be(out.parent_hash)
                      + pack_bytes_be(out.state_root) + [out.block_number])}
    if ([host["values a"], host["values b"], host["contract"], host["block"]]
            != [h["values_a_root"][:31], h["values_b_root"][:31], h["contract"], h["block"]]):
        _fail("merged: block 100's host models differ from the JAX package's")
    return host, contract.metadata_digest


def _tampered(env_dict):
    """A copy of a serialized envelope with its first public input changed."""
    proof = dict(env_dict["proof"])
    pis = list(proof["public_inputs"])
    pis[0] = (pis[0] + 1) % gl.P
    proof["public_inputs"] = pis
    return {**env_dict, "proof": proof}


def phase_merged_api(card, params, cfg, block, mgolden, launches, shapes):
    """Block 100's extraction through the work queue and the API: a
    Coordinator on 127.0.0.1 serves the four child payloads (mp2_tpu/api.py's
    serialized CircuitInput dicts: values_trie for table a, the balances,
    and table b, the supply; contract; block) to one WorkerClient thread
    whose prove is api.generate_proof on the card; then the final_merge
    payload, built from the four serialized results, is added and proved
    the same way (table a individual, table b the multiplier).  Each member
    proof a batch of one, wrapped; timed from the first lease to the last
    completion, on the host clock to a card sync.  Checked: every result
    accepted by api.verify_envelope and a tampered copy refused; the walks'
    root PIs (H, DV, DM, N; S = 0), the account leaf's and the header's
    equal to the host models' and the JAX package's; final_merge's PIs
    equal to final_merge_pi_values of those PIs and to the JAX package's
    (merged_golden.json), with its set digest.  Each kernel shape the path
    feeds is announced (`shapes`, a _ShapeLog)."""
    h = mgolden["host"]["host_models"][0]
    host, contract_dm = _merged_host(cfg, block, h)
    keys = sorted(block.entries)
    loc = SK.simple_slot_location(cfg.single_slot)
    payloads = {
        "values a": {"kind": "values_trie", "paths": [
            [n.hex() for n in block.storage.get_proof(SK.mapping_location(cfg.slot, k))]
            for k in keys], "leaf_args": [k.hex() for k in keys]},
        "values b": {"kind": "values_trie", "table": "b",
                     "paths": [[n.hex() for n in block.storage.get_proof(loc)]],
                     "leaf_args": [[int(v) for v in host_key_nibbles(loc)]]},
        "contract": {"kind": "contract", "proof_nodes": [
            n.hex() for n in block.state.get_proof(cfg.contract_address)]},
        "block": {"kind": "block", "header": block.header_rlp.hex()},
    }
    q = WQ.WorkQueue(lease_timeout=3600.0)
    for key, payload in payloads.items():
        q.add(key, payload["kind"], json.dumps(payload).encode())
    coordinator = WQ.Coordinator(q)
    worker = WQ.WorkerClient(coordinator.address, "card")
    walls = []

    def prove(kind, payload):
        t0 = time.perf_counter()
        out = json.dumps(API.generate_proof(params, json.loads(payload))).encode()
        torch.cuda.synchronize()
        walls.append((kind, t0, time.perf_counter()))
        return out

    fws = {"vx": params.vx.fw, "vx_b": params.vx_b.fw, "cx": params.cx.fw,
           "bx": params.bx.fw, "fx": params.fx.fw}
    members, envs = [], []
    drained = []
    os.environ.pop("MP2_BATCH_LEAVES", None)  # the default path: one proof per trie node
    _reset_counts()
    with _StageLog() as log, shapes, _member_log(fws, members, envs), \
            ThreadPoolExecutor(1) as thread:
        c0 = time.process_time()
        drained.append(thread.submit(worker.run, prove).result())
        res = {k: json.loads(v) for k, v in q.results().items()}
        final = {"kind": "final_merge", "block": res["block"], "contract": res["contract"],
                 "table_a": res["values a"], "table_b": res["values b"],
                 "is_table_a_multiplier": False}
        q.add("final_merge", "final_merge", json.dumps(final).encode(), list(payloads))
        drained.append(thread.submit(worker.run, prove).result())
        t_end, cpu = time.perf_counter(), time.process_time() - c0
    worker.close()
    coordinator.close()
    _read_counts("merged block 100 (api.generate_proof through the work queue)", launches)
    wall = t_end - walls[0][1]
    proved = [m["member"] for m in members]
    if proved != MERGED_PROOFS or drained != [len(payloads), 1] or q.pending():
        _fail(f"merged: the worker proved {proved} in {drained} leases' rounds, not "
              f"{MERGED_PROOFS} in [4, 1]")

    res = {k: json.loads(v) for k, v in q.results().items()}
    for key, d in res.items():
        if not API.verify_envelope(params, d):
            _fail(f"merged: api.verify_envelope rejected the {key} result")
        if API.verify_envelope(params, _tampered(d)):
            _fail(f"merged: api.verify_envelope accepted a tampered {key} result")
    env = {k: runtime.WrappedEnvelope.from_dict(d) for k, d in res.items()}
    for key, fw in (("values a", params.vx.fw), ("values b", params.vx_b.fw)):
        pis = env[key].user_inputs
        if (pis[:31] != host[key] or pis[95] != 0
                or env[key].public_inputs[-4:] != list(fw.set_digest)):
            _fail(f"merged: the {key} root's PIs are not the host model's H, DV, DM, N with "
                  f"S = 0 and the set digest")
    if (env["contract"].user_inputs[:len(host["contract"])] != host["contract"]
            or env["block"].user_inputs[:len(host["block"])] != host["block"]):
        _fail("merged: the account leaf's or the header's PIs differ from the host models'")
    final_pis = env["final_merge"].user_inputs
    want = XF.final_merge_pi_values(host["block"], host["values a"], host["values b"],
                                    contract_dm, False)
    if (final_pis[:len(want)] != want or want != h["final_merge"]
            or env["final_merge"].public_inputs[-4:] != list(params.fx.fw.set_digest)
            or final_pis[XF.F_BN] != block.number or want[-2:] != [len(keys) + 1, 1]):
        _fail("merged: final_merge's PIs are not final_merge_pi_values of the walks', the "
              "account leaf's and the header's, or not the JAX package's")
    print(f"merged block 100 through the API: {len(payloads) + 1} payloads leased by a "
          f"Coordinator on {coordinator.address[0]} to one WorkerClient thread and proved by "
          f"api.generate_proof ({', '.join(f'{k} {b - a:.3f} s' for k, a, b in walls)}): "
          f"{len(proved)} member proofs ({', '.join(proved)}), each wrapped; every result "
          f"accepted by api.verify_envelope and a tampered copy refused; both walks' root "
          f"PIs (N {env['values a'].user_inputs[30]} and {env['values b'].user_inputs[30]}, "
          f"S 0), the account leaf's and the header's = the host models' and the JAX "
          f"package's; final_merge's PIs (block {final_pis[XF.F_BN]}, N "
          f"{want[-2]}, merge flag {want[-1]}) = final_merge_pi_values and the JAX package's")
    print(f"merged_extraction_proofs_per_s {len(proved) / wall:.4f} ({len(proved)} member "
          f"proofs / {wall:.3f} s wall from the first lease to the last completion, wraps "
          f"included; {cpu:.3f} s of this process's CPU); {card}")
    _print_members("merged block 100", members, log, wall)


# the other processes of this script and the card's lanes
VDB_LIGHT_FLAG = "--vdb-light"
VDB_PRODUCTION_FLAG = "--vdb-production"
EXTRACTION_FLAG = "--extraction"
MERGED_FLAG = "--merged"
HELPERS = (VDB_LIGHT_FLAG, VDB_PRODUCTION_FLAG, EXTRACTION_FLAG, MERGED_FLAG)
SHAPE_FLAGS = (EXTRACTION_FLAG, MERGED_FLAG)  # the helpers that announce kernel shapes
LANE_MARK = "@card"  # a helper's request for a lane and its release, one line each
# each lane's steps in the order they run.  Since prove_batch's quotient,
# FRI combination and constant-matrix products run in bounded pieces, a
# 2^16-row proof adds ~9 GiB to its process's resident sets (36 GiB before),
# so steps no longer need to take turns for memory: the lanes only order
# them.  The heavy lane ("H") runs the row update, then block 101 through
# the pipeline, whose process holds the most sets (~14 GiB) and whose set-up
# ends last; the block path ("B") starts after the row update, beside the
# pipeline's set-up, then runs the merged table's block 100 through the API,
# whose process sets up beside the others; the other lane ("O") runs the
# remaining steps
HEAVY_ORDER = ("vdb row update", "pipeline block 101 and queries")
BLOCK_ORDER = ("vdb block tree + IVC", "merged block 100 through the API")
OTHER_ORDER = ("recursion production", "vdb production chain", "recursion light",
               "vdb light golden chain")
LANES = {"H": HEAVY_ORDER, "B": BLOCK_ORDER, "O": OTHER_ORDER}


class _Card:
    """The card's lanes (LANES), granted by the main process, each running
    its steps in their fixed order, one at a time.  The main process holds
    every lane through the kernel phases and the tree-node timing.  Each
    request, grant and release is logged with its time."""

    def __init__(self, t_start, holder):
        self.cv = threading.Condition()
        self.t_start = t_start
        self.busy = {lane: holder for lane in LANES}
        self.queue = {lane: list(order) for lane, order in LANES.items()}
        self.log = []
        self.failed = None  # a helper that exited with an error
        for lane in self.busy:
            self._note(lane, holder, "granted")

    def _note(self, lane, step, event):
        self.log.append((time.perf_counter() - self.t_start, lane, step, event))

    def acquire(self, lane, step):
        with self.cv:
            self._note(lane, step, "wanted")
            while not (self.busy[lane] is None and self.queue[lane][0] == step):
                if self.failed:
                    _fail(f"{self.failed} failed while {step} waited for the card")
                self.cv.wait(1.0)
            self.queue[lane].pop(0)
            self.busy[lane] = step
            self._note(lane, step, "granted")

    def release(self, lane, step):
        with self.cv:
            if self.busy[lane] == step:
                self.busy[lane] = None
                self._note(lane, step, "released")
                self.cv.notify_all()

    def fail(self, who):
        with self.cv:
            self.failed = who
            self.cv.notify_all()

    @contextlib.contextmanager
    def lane(self, lane, step):
        self.acquire(lane, step)
        try:
            yield
        finally:
            self.release(lane, step)

    def report(self):
        """Each step's times on the script's clock: asked for its lane,
        granted it, gave it back."""
        spans = {}
        for t, lane, step, event in self.log:
            spans.setdefault((lane, step), {})[event] = t
        for (lane, step), ev in sorted(spans.items(),
                                       key=lambda kv: min(kv[1].values())):
            print(f"card lane {lane}: {step}: " + ", ".join(
                f"{e} at {t:.1f} s" for e, t in ev.items()))


class _FreeMemory:
    """The least free memory of the card (every process's allocations
    together), sampled every second, and when it was seen."""

    def __init__(self, t_start):
        self.t_start, self.least, self.total = t_start, None, None
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)
        self.thread.start()

    def _sample(self):
        while not self.stop.wait(1.0):
            free, self.total = torch.cuda.mem_get_info()
            if self.least is None or free < self.least[0]:
                self.least = (free, time.perf_counter() - self.t_start)

    def report(self):
        self.stop.set()
        self.thread.join()
        free, t = self.least
        print(f"least free card memory: {free / 2**30:.2f} of {self.total / 2**30:.2f} GiB, "
              f"at {t:.1f} s")


class _Helper:
    """This script in another process on the same card (`flag`); a thread
    reads its output, asks the card for the lanes it requests and answers
    with a line on its input once granted."""

    def __init__(self, flag, card, shapes):
        here = os.path.dirname(os.path.abspath(__file__))
        self.flag, self.card, self.lines, self.held = flag, card, [], set()
        self.stdin_lock = threading.Lock()
        self.last_line = self.exited = 0.0  # on the script's clock
        self.shapes = shapes  # (flag, each shape it announces), then (flag, None)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), flag], cwd=here,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, "PYTHONUNBUFFERED": "1"})
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            self.last_line = time.perf_counter() - self.card.t_start
            if line.startswith(SHAPE_MARK):
                self.shapes.put((self.flag, _shape_from_json(line[len(SHAPE_MARK):])))
            if line.startswith(LANE_MARK):
                _, verb, lane, step = line.split(maxsplit=3)
                step = step.strip()
                if verb == "want":
                    self.card.acquire(lane, step)
                    self.held.add((lane, step))
                    self.send("go")
                else:
                    self.card.release(lane, step)
                    self.held.discard((lane, step))
        self.shapes.put((self.flag, None))
        code = self.proc.wait()
        self.exited = time.perf_counter() - self.card.t_start
        if code != 0:
            self.card.fail(self.flag)
        for lane, step in self.held:
            self.card.release(lane, step)

    def send(self, line):
        """One line on its input."""
        with self.stdin_lock:
            self.proc.stdin.write(line + "\n")
            self.proc.stdin.flush()

    def result(self):
        """Its output, printed; its last line as JSON; fails with it."""
        self.thread.join()
        print("".join(self.lines), end="")
        if self.proc.returncode != 0:
            _fail(f"the {self.flag} process exited with {self.proc.returncode}")
        return json.loads(self.lines[-1])


def _join(helpers, card):
    """Wait for every helper and return their results; fail as soon as one
    fails."""
    while any(h.proc.poll() is None for h in helpers) and not card.failed:
        time.sleep(1.0)
    failed = [h for h in helpers if h.flag == card.failed]  # its result() fails
    return [h.result() for h in failed + helpers]


BUILT = "built"  # the main process's line to each helper once the kernels are built
_kernels_built = []  # in a helper: whether that line has come


def _main_line(want):
    """In a helper: wait for the main process's line `want` (BUILT, or "go"
    for a lane), noting BUILT whenever it comes."""
    while True:
        line = sys.stdin.readline().rstrip("\n")
        if line == BUILT:
            _kernels_built.append(True)
        if line == want:
            return
        if line != BUILT:
            _fail(f"the main process sent {line!r}, not {want!r}")


def _builds_from_main():
    """In a helper, started beside the kernel builds: its first kernel
    launch waits for the main process's line saying that the kernels are
    built, then loads them from the build directory (a helper never
    compiles them itself)."""
    def waiting(build):
        def call():
            if not _kernels_built:
                _main_line(BUILT)
            return build()

        return call

    for mod in (K, N, T):
        mod.build = waiting(mod.build)


def _settled():
    """After a process's set-up: its objects (the circuits' millions) move
    to the collector's permanent generation, so the first collections while
    it proves do not walk them all (25-45 s in the first proof after the
    extraction sets), the collector stays off while it proves (a witness
    generation leaves a few thousand tracked objects; the collections cost
    ~10% of its time), and the set-up's cached blocks go back to the
    card."""
    gc.freeze()
    gc.disable()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _lane(lane, step):
    """In a helper: wait until the main process grants `lane` to `step`;
    give it back at the end."""
    print(f"{LANE_MARK} want {lane} {step}", flush=True)
    _main_line("go")
    print(f"{step}: granted; this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB of the card ({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)",
          flush=True)
    try:
        yield
    finally:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the cached blocks go back to the card for the other lanes
        print(f"{LANE_MARK} done {lane} {step}", flush=True)


def vdb_light_process(card, dev, golden):
    """The light vdb sets (VDB_LIGHT_FLAG): set up beside the kernel
    phases, then the row update on the heavy lane, the block path on its
    own lane and the golden chain on the other lane.  The last line is the
    paths' launch counts."""
    launches = {}
    vdb = _phase("vdb light set-up", phase_vdb_light_setup, card, dev, golden)
    _settled()
    with _lane("H", HEAVY_ORDER[0]):
        counts, rows_db, rows_root = _phase("vdb row update", phase_vdb_update, card, vdb,
                                            launches)
    with _lane("B", BLOCK_ORDER[0]):
        _phase("vdb block tree + IVC", phase_vdb_block_ivc, card, vdb, rows_db, rows_root,
               launches)
    with _lane("O", OTHER_ORDER[3]):
        _phase("vdb light golden chain", phase_vdb_chain, card, vdb, golden)
    print(json.dumps({"launches": launches, "row_update": counts}))


def vdb_production_process(card, dev, golden):
    """The production vdb sets and their chain (VDB_PRODUCTION_FLAG)."""
    vdb = _phase("vdb production set-up", phase_vdb_production_setup, card, dev, golden)
    _settled()
    with _lane("O", OTHER_ORDER[1]):
        _phase("vdb production chain", phase_vdb_production_chain, card, vdb, golden)
    print(json.dumps({"launches": {}}))


def extraction_process(card, dev, xgolden, fgolden, vgolden, pgolden):
    """The pipeline (EXTRACTION_FLAG): CircuitTableIndexer's sets set up
    beside the kernel phases, then on the heavy lane block 101 through
    apply_block and the three queries through run_query, announcing each
    kernel shape they feed for the main process to check.  The last line is
    the paths' launch counts."""
    launches = {}
    cfg, chain = _pipeline_chain()
    block = chain[-1]
    ix = _phase("pipeline set-up", phase_pipeline_setup, card, dev, cfg, block, xgolden,
                fgolden, vgolden, pgolden)
    _settled()
    shapes = _ShapeLog()
    with _lane("H", HEAVY_ORDER[1]):
        _phase("pipeline block 101", phase_pipeline_block, card, ix, cfg, block, xgolden,
               fgolden, pgolden, launches, shapes)
        _phase("pipeline queries", phase_pipeline_queries, card, ix, pgolden, launches, shapes)
    print(json.dumps({"launches": launches}))


def merged_process(card, dev, xgolden, fgolden, vgolden, mgolden):
    """The merged table (MERGED_FLAG): its sets set up through
    api.build_circuits_params beside the kernel phases, then on the block
    path's lane block 100's extraction through the work queue and
    api.generate_proof, announcing each kernel shape it feeds for the main
    process to check.  The last line is the path's launch counts."""
    launches = {}
    cfg, chain = _merged_chain()
    block = chain[0]
    params = _phase("merged set-up", phase_merged_setup, card, dev, cfg, block, xgolden,
                    fgolden, vgolden, mgolden)
    _settled()
    with _lane("B", BLOCK_ORDER[1]):
        _phase("merged block 100", phase_merged_api, card, params, cfg, block, mgolden,
               launches, _ShapeLog())
    print(json.dumps({"launches": launches}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(TESTDATA, "recursion_golden.json")) as f:
        rgolden = json.load(f)
    with open(os.path.join(TESTDATA, "vdb_golden.json")) as f:
        vgolden = json.load(f)
    with open(os.path.join(TESTDATA, "extraction_golden.json")) as f:
        xgolden = json.load(f)
    with open(os.path.join(TESTDATA, "final_extraction_golden.json")) as f:
        fgolden = json.load(f)
    with open(os.path.join(TESTDATA, "pipeline_golden.json")) as f:
        pgolden = json.load(f)
    with open(os.path.join(TESTDATA, "merged_golden.json")) as f:
        mgolden = json.load(f)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    if sys.argv[1:] and sys.argv[1] in HELPERS:
        _builds_from_main()
    if sys.argv[1:] == [VDB_LIGHT_FLAG]:
        vdb_light_process(card, dev, vgolden)
        return 0
    if sys.argv[1:] == [VDB_PRODUCTION_FLAG]:
        vdb_production_process(card, dev, vgolden)
        return 0
    if sys.argv[1:] == [EXTRACTION_FLAG]:
        extraction_process(card, dev, xgolden, fgolden, vgolden, pgolden)
        return 0
    if sys.argv[1:] == [MERGED_FLAG]:
        merged_process(card, dev, xgolden, fgolden, vgolden, mgolden)
        return 0
    t_start = time.perf_counter()
    launches = {}

    # three processes of this script set up the vdb and pipeline sets on
    # the host from the start, beside the kernel builds (their first kernel
    # launch waits for them), then beside the kernel phases and the
    # tree-node timing, which hold the whole card (with the fixed
    # commitments' short launches); after them every step that proves takes
    # a lane of the card (see _Card)
    lanes = _Card(t_start, "kernel phases and tree-node timing")
    shape_queue = queue.Queue()
    helpers = [_Helper(flag, lanes, shape_queue) for flag in HELPERS]
    memory = _FreeMemory(t_start)
    toolchain = ThreadPoolExecutor(1)
    try:
        builds = _phase("kernel builds", phase_builds)
        for h in helpers:
            h.send(BUILT)
        sass_lines = toolchain.submit(_phase, "toolchain", phase_toolchain, card, builds)
        p1 = _phase("P1 probe", phase_probe, card)
        k1_err, k1_times = _phase("K1", phase_k1, card)
        k1m_err, k1m_times = _phase("K1 Merkle entries", phase_k1_merkle, card)
        k2_err, k2_times = _phase("K2", phase_k2, card)
        k2c_err, k2c_times = _phase("K2c", phase_k2c, card)
        torch.cuda.empty_cache()
        light, production = _phase("tree nodes", phase_tree_nodes, card, dev, launches)
        _phase("tree-node timing", phase_timing, card,
               {"tree_node_proofs_per_s": light,
                "tree_node_proofs_per_s_production": production})
        del light, production
        torch.cuda.empty_cache()
        lines, sass = sass_lines.result()
        print("\n".join(lines))
        toolchain.shutdown()
        for lane in LANES:
            lanes.release(lane, "kernel phases and tree-node timing")
        fw = _phase("recursion light set-up", _framework, "light (test_config)",
                    test_config(), dev, rgolden["light"])
        fw_production = _phase("recursion production set-up", _framework,
                               "production (CircuitConfig)", CircuitConfig(), dev,
                               rgolden["production"])
        _settled()
        with lanes.lane("O", OTHER_ORDER[0]):
            _phase("recursion production", phase_recursion_production, card, fw_production,
                   launches)
            del fw_production
            torch.cuda.empty_cache()
        with lanes.lane("O", OTHER_ORDER[2]):
            _phase("recursion light", phase_recursion_light, card, fw, rgolden["light"],
                   launches)
            del fw
            torch.cuda.empty_cache()
        shapes_err, shapes = _phase("pipeline and merged kernel shapes", phase_pipeline_shapes,
                                    card, shape_queue, lanes)
        results = _phase("the other processes (join)", _join, helpers, lanes)
    except BaseException:
        for h in helpers:
            if h.proc.poll() not in (None, 0):
                print("".join(h.lines), end="")
            h.proc.kill()
            h.proc.wait()
        raise
    lanes.report()
    for h in helpers:
        print(f"process {h.flag}: last line at {h.last_line:.1f} s, exited at "
              f"{h.exited:.1f} s")
    memory.report()
    for r in results:
        launches.update(r["launches"])
    counts = results[0]["row_update"]

    def by_path(name):
        return {p: c[name] for p, c in launches.items()}

    k2_shape = f"iNTT (16*{WIRES}, 2^13)"
    k2c_shape = f"LDE (16*{WIRES}, 2^16)"
    print(f"K1 launches in the {VDB_ROWS}-row update: {counts['K1']} ({counts['K1 entries']})")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [
        {"name": "probe_ops", "route": "cuda",
         "source": "mp2_tpu_torch/csrc/probe_ops.cu",
         "replaces": "tools/probe_ops.py:61", "library_ms": None,
         **p1, "launches_by_path": {"P1 probe": p1["launches"], **by_path("P1")}},
        {"name": "poseidon2_permute_planar", "route": "cuda",
         "source": "mp2_tpu_torch/csrc/poseidon2.cu",
         "replaces": "mp2_tpu/ops/poseidon2_pallas.py:114",
         "launches": counts["K1"], "max_abs_err": max(k1_err, k1m_err, shapes_err),
         **k1_times[1 << 20], "library_ms": None, "lanes": 1 << 20,
         "launches_by_path": by_path("K1"),
         "launches_by_entry_and_path": by_path("K1 entries"),
         "by_lanes": {str(k): v for k, v in k1_times.items()},
         "merkle_entries": k1m_times,
         "pipeline_shapes": shapes.get(EXTRACTION_FLAG, {}).get("K1", {}),
         "merged_shapes": shapes.get(MERGED_FLAG, {}).get("K1", {}), "sass": sass["K1"]},
        {"name": "ntt_rows", "route": "cuda",
         "source": "mp2_tpu_torch/csrc/ntt.cu",
         "replaces": "mp2_tpu/ops/ntt_pallas.py:237",
         "launches": counts["K2"], "max_abs_err": k2_err,
         **k2_times[k2_shape], "library_ms": None, "shape": k2_shape,
         "launches_by_path": by_path("K2"), "by_shape": k2_times, "sass": sass["K2"]},
        {"name": "ntt_four_step_t", "route": "cuda",
         "source": "mp2_tpu_torch/csrc/ntt_t.cu",
         "replaces": "mp2_tpu/ops/ntt_pallas.py:526",
         "launches": counts["K2c"], "max_abs_err": max(k2c_err, shapes_err),
         **k2c_times[k2c_shape], "library_ms": None, "shape": k2c_shape,
         "launches_by_path": by_path("K2c"), "by_shape": k2c_times,
         "pipeline_shapes": shapes.get(EXTRACTION_FLAG, {}).get("K2c", {}),
         "merged_shapes": shapes.get(MERGED_FLAG, {}).get("K2c", {}), "sass": sass["K2c"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    rc = main()
    # the phases' circuits, frameworks and tensors are left to the operating
    # system: freeing their millions of objects one by one at interpreter
    # exit would only delay the exit
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
