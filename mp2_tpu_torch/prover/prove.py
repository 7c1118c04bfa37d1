"""TP2 circuit data and proof objects: what `prover/batch.prove_batch` and
the host verifier share.

Port of `mp2_tpu/prover/prove.py`: `CircuitData` (compile, fixed-column
LDE and Merkle tree, witness generation and `check_witness`), `Openings`,
`Proof`, `_gate_terms`, `_lde_tables`, `_powers_device`, and the serial
`prove`.  The reference shows its batched and serial proofs bit-identical
(tests/test_recursion.py:331-397), so `prove` here is a batch of one
through `prover/batch.prove_batch` rather than a second copy of the prover.
`_shape_key` keyed JAX's jit caches and has no use in eager torch.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.prover import fri as fri_mod
from mp2_tpu_torch.prover import ntt
from mp2_tpu_torch.prover.algebra import HostExtAlgebra
from mp2_tpu_torch.prover.config import CircuitConfig
from mp2_tpu_torch.prover.merkle import MerkleTree

SHIFT = gl.MULTIPLICATIVE_GROUP_GENERATOR  # LDE coset shift


def _k_coeffs(num_wires: int) -> List[int]:
    """Pairwise coset-distinct column multipliers: 7^j (7 generates F*)."""
    ks = []
    cur = 1
    for _ in range(num_wires):
        ks.append(cur)
        cur = cur * 7 % P
    return ks


@dataclass
class CircuitData:
    config: CircuitConfig
    n: int
    log_n: int
    gate_types: List  # [(name, gate_instance)]
    selector_values: np.ndarray  # (n, T) uint64
    constants_values: np.ndarray  # (n, num_constants) uint64
    sigma_values: np.ndarray  # (n, W) uint64
    k_coeffs: List[int]
    rows_meta: List  # Row list (for witness gen / debug)
    dsu_parent: Dict
    generators: List
    public_inputs: List
    device: torch.device = None

    # fixed data on `device`
    fixed_coeffs: torch.Tensor = None  # (F, n)
    fixed_lde: torch.Tensor = None  # (F, 8n) natural order
    fixed_tree: MerkleTree = None

    circuit_digest: Tuple[int, int, int, int] = None

    # ------------------------------------------------------------------ build
    @staticmethod
    def compile(builder, device) -> "CircuitData":
        from mp2_tpu_torch.circuit import gates as G

        cfg = builder.config
        rows = builder.rows
        n_real = len(rows)
        n = max(8, getattr(builder, "_min_rows", 0), 1 << (n_real - 1).bit_length())
        while len(rows) < n:
            rows.append(type(rows[0])(G.NoopGate(), []))
        log_n = n.bit_length() - 1

        # gate-type registry in order of first appearance (constraint order!)
        gate_types: List = []
        seen = {}
        for r in rows:
            nm = r.gate.name
            if nm not in seen and r.gate.num_constraints() > 0:
                seen[nm] = len(gate_types)
                gate_types.append((nm, r.gate))
        T = len(gate_types)

        selector_values = np.zeros((n, T), dtype=np.uint64)
        constants_values = np.zeros((n, cfg.num_constants), dtype=np.uint64)
        for i, r in enumerate(rows):
            if r.gate.name in seen:
                selector_values[i, seen[r.gate.name]] = 1
            for j, c in enumerate(r.constants):
                constants_values[i, j] = c

        # sigma from copy classes.  Cell (r, c) has the id k_c * g^r; the
        # (n, W) table of ids is one field product on the CPU (a Python loop
        # over the n * W cells was most of a large circuit's compile).
        W = cfg.num_wires
        ks = _k_coeffs(W)
        g = ntt._root_of_unity(log_n)
        ids = gl.to_u64(gl.mul(gl.from_u64(ntt._power_table(g, n), "cpu")[:, None],
                               gl.from_u64(np.array(ks, dtype=np.uint64), "cpu")[None, :]))

        # each copy class is a cycle through its cells in (row, col) order:
        # a cell's sigma is the id of the next cell of its class.  Classes
        # are grouped by sorting cell codes r * W + c under their root.
        find = builder.dsu.find
        pairs = [(find(cell), cell) for cell in list(builder.dsu.parent.keys())]
        pairs += [(root, root) for root in {root for root, _ in pairs}]
        root_index: Dict = {}
        root_ids, codes = [], []
        for root, (r, c) in pairs:
            if r < n and c < W:
                root_ids.append(root_index.setdefault(root, len(root_index)))
                codes.append(r * W + c)
        sigma_values = ids.copy()
        if codes:
            root_ids, codes = np.array(root_ids), np.array(codes)
            order = np.lexsort((codes, root_ids))
            root_ids, codes = root_ids[order], codes[order]
            starts = np.flatnonzero(np.r_[True, root_ids[1:] != root_ids[:-1]])
            nxt = np.roll(codes, -1)
            nxt[np.r_[starts[1:], len(codes)] - 1] = codes[starts]
            sigma_values.reshape(-1)[codes] = ids.reshape(-1)[nxt]

        data = CircuitData(
            config=cfg,
            n=n,
            log_n=log_n,
            gate_types=gate_types,
            selector_values=selector_values,
            constants_values=constants_values,
            sigma_values=sigma_values,
            k_coeffs=ks,
            rows_meta=rows,
            dsu_parent=builder.dsu,
            generators=builder.generators,
            public_inputs=builder.public_inputs,
            device=torch.device(device),
        )
        data._build_fixed()
        return data

    def _build_fixed(self):
        """iNTT -> coset LDE -> Merkle cap of the fixed columns, and the
        circuit digest (hash of the cap and the shape).  When MP2_FIXED_CACHE
        names a directory, the u64 results are cached there, keyed by a hash
        of the fixed column values and the FRI shape, and a later compile of
        the same circuit loads them instead (the reference persists whole
        `PublicParameters` the same way, mp2-v1/src/api.rs:618-636).  The
        key, the file and its fields are mp2_tpu's, so either package reads
        a cache the other wrote.  The cache changes no output."""
        cfg = self.config
        cap_h = min(cfg.fri.cap_height, self.log_n)
        cols = np.concatenate(
            [self.selector_values, self.constants_values, self.sigma_values],
            axis=1,
        ).T  # (F, n)
        cache_dir = os.environ.get("MP2_FIXED_CACHE")
        cache_path = None
        if cache_dir:
            key = hashlib.sha256(
                cols.tobytes()
                + repr((cfg.fri.rate_bits, cap_h, cols.shape)).encode()
            ).hexdigest()[:32]
            cache_path = os.path.join(cache_dir, f"fixed_{key}.npz")
            if os.path.exists(cache_path):
                with np.load(cache_path) as z:
                    self.set_fixed(z["coeffs"], z["lde"],
                                   [z[f"level_{i}"] for i in range(int(z["n_levels"]))])
                return
        vals = gl.from_u64(cols, self.device)
        self.fixed_coeffs = ntt.intt(vals)
        self.fixed_lde = ntt.lde(self.fixed_coeffs, cfg.fri.rate_bits, SHIFT)
        self.fixed_tree = MerkleTree.from_lde(self.fixed_lde, cap_height=cap_h)
        self.set_digest()
        if cache_path:
            os.makedirs(cache_dir, exist_ok=True)
            levels = self.fixed_tree.digest_levels
            tmp = cache_path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(
                    f,
                    coeffs=gl.to_u64(self.fixed_coeffs),
                    lde=gl.to_u64(self.fixed_lde),
                    n_levels=len(levels),
                    **{f"level_{i}": gl.to_u64(l) for i, l in enumerate(levels)},
                )
            os.replace(tmp, cache_path)

    def set_fixed(self, coeffs: np.ndarray, lde: np.ndarray, levels: List[np.ndarray]):
        """The fixed data from canonical uint64 arrays, put on `device`:
        coefficients (F, n), the natural-order LDE (F, big) and the fixed
        tree's digest levels from the leaf digests (over bit-reversed
        leaves) to the cap; then the circuit digest."""
        def put(a):
            return gl.from_u64(np.asarray(a, dtype=np.uint64), self.device)

        self.fixed_coeffs = put(coeffs)
        self.fixed_lde = put(lde)
        cap_h = min(self.config.fri.cap_height, self.log_n)
        self.fixed_tree = MerkleTree.from_levels(self.fixed_lde, [put(l) for l in levels],
                                                 cap_h)
        self.set_digest()

    def set_digest(self):
        cap = gl.to_u64(self.fixed_tree.cap)
        flat = [int(v) for row in cap for v in row]
        self.circuit_digest = p2h.hash_no_pad(
            flat + [self.n, self.config.num_wires, self.config.num_challenges]
        )

    @property
    def num_gate_types(self) -> int:
        return len(self.gate_types)

    @property
    def fixed_cap_host(self):
        return [tuple(int(x) for x in r) for r in gl.to_u64(self.fixed_tree.cap)]

    # ------------------------------------------------------------ witness gen
    def _witness_layout(self):
        """(parent map, rows, cols, roots), built once per circuit: the copy
        constraints fully compressed, so parent.get(t, t) is t's class
        representative, and every wired cell of the trace with its
        representative.  The classes do not change after compile."""
        layout = self.__dict__.get("_layout")
        if layout is None:
            dsu = self.dsu_parent
            for t in list(dsu.parent):
                dsu.find(t)
            W = self.config.num_wires
            cells = [(t, root) for t, root in dsu.parent.items()
                     if t[0] < self.n and t[1] < W]
            rows = np.array([t[0] for t, _ in cells], dtype=np.int64)
            cols = np.array([t[1] for t, _ in cells], dtype=np.int64)
            layout = self._layout = (dsu.parent, rows, cols, [root for _, root in cells])
        return layout

    def generate_witness(self, inputs: Dict) -> np.ndarray:
        parent, rows, cols, roots = self._witness_layout()
        values: Dict = {}

        def read(t):
            return values.get(parent.get(t, t), 0)

        for t, v in inputs.items():
            root = parent.get(t, t)
            v = v % P
            prev = values.get(root)
            if prev is not None and prev != v:
                raise ValueError(
                    f"witness conflict at input {t}: {prev} vs {v} "
                    "(targets connected to the same wire disagree)"
                )
            values[root] = v
        for out, fn in self.generators:
            root = parent.get(out, out)
            v = fn(read) % P
            prev = values.get(root)
            if prev is not None and prev != v:
                raise ValueError(f"witness conflict at {out}: {prev} vs {v}")
            values[root] = v

        W = self.config.num_wires
        w = np.zeros((self.n, W), dtype=np.uint64)
        w[rows, cols] = np.fromiter((values.get(r, 0) for r in roots),
                                    dtype=np.uint64, count=len(roots))
        own = [(r, c, v) for (r, c), v in values.items() if r < self.n and c < W]
        if own:
            rr, cc, vv = zip(*own)
            w[list(rr), list(cc)] = np.array(vv, dtype=np.uint64)
        return w

    def check_witness(self, w: np.ndarray, public_inputs: List[int]) -> None:
        """Debug: evaluate every gate's constraints on the raw witness rows."""
        alg = HostExtAlgebra
        pi_hash = p2h.hash_no_pad(public_inputs)
        extras = {"pi_hash": [(h, 0) for h in pi_hash]}
        for i, row in enumerate(self.rows_meta):
            wires = [(int(w[i, j]), 0) for j in range(self.config.num_wires)]
            consts = [
                (int(self.constants_values[i, j]), 0)
                for j in range(self.config.num_constants)
            ]
            for k, c in enumerate(row.gate.constraints(alg, wires, consts, extras)):
                if c != (0, 0):
                    raise AssertionError(
                        f"constraint {k} of gate {row.gate.name} fails at row {i}"
                    )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _x_table(log_big: int) -> np.ndarray:
    return ntt._power_table(ntt._root_of_unity(log_big), 1 << log_big)


@lru_cache(maxsize=None)
def _lde_tables(log_n: int, rate_bits: int):
    """Host tables on the big coset: x, Z_H(x)^-1, L0(x) (python-int math).

    x = SHIFT * w^i with w the 2^(log_n + rate_bits)-th root, so x^n takes
    2^rate_bits values in turn, and the 8n inverses of L0's denominators
    are one inversion and three products each (Montgomery's trick): a
    modular power per point took 15 s at 2^15 rows."""
    n = 1 << log_n
    x = [SHIFT * int(v) % P for v in _x_table(log_n + rate_bits)]
    reps = len(x) >> rate_bits
    zh_period = [(pow(v, n, P) - 1) % P for v in x[: 1 << rate_bits]]
    zh = zh_period * reps
    zh_inv = [pow(v, P - 2, P) for v in zh_period] * reps
    # L0(x) = (x^n - 1) / (n (x - 1))
    den = [n * (v - 1) % P for v in x]
    prefix, acc = [], 1
    for d in den:
        prefix.append(acc)
        acc = acc * d % P
    if acc == 0:
        raise ValueError("x = 1 on the LDE coset")
    inv = pow(acc, P - 2, P)  # 1 / (den[0] ... den[i]) as i walks down
    l0 = [0] * len(x)
    for i in range(len(x) - 1, -1, -1):
        l0[i] = zh[i] * (inv * prefix[i] % P) % P
        inv = inv * den[i] % P
    return (
        np.array(x, dtype=np.uint64),
        np.array(zh_inv, dtype=np.uint64),
        np.array(l0, dtype=np.uint64),
    )


def _powers_device(a: torch.Tensor, count: int) -> torch.Tensor:
    """[1, a, a^2, ...] along a new leading axis (log-depth doubling);
    a may be batched: (count,) + a.shape."""
    pows = torch.ones((1,) + tuple(a.shape), dtype=torch.int64, device=a.device)
    step = a[None]
    while pows.shape[0] < count:
        pows = torch.cat([pows, gl.mul(pows, step)], dim=0)
        step = gl.mul(step, step)
    return pows[:count]


# ---------------------------------------------------------------------------
# proof object
# ---------------------------------------------------------------------------


@dataclass
class Openings:
    fixed: List[Tuple[int, int]]
    wires: List[Tuple[int, int]]
    zs_partials: List[Tuple[int, int]]
    quotient: List[Tuple[int, int]]
    zs_next: List[Tuple[int, int]]  # Z columns at g*zeta

    def batch1(self) -> List[Tuple[int, int]]:
        return self.fixed + self.wires + self.zs_partials + self.quotient

    def flat(self) -> List[Tuple[int, int]]:
        return self.batch1() + self.zs_next


@dataclass
class Proof:
    wires_cap: np.ndarray
    zs_cap: np.ndarray
    quotient_cap: np.ndarray
    openings: Openings
    fri: fri_mod.FriProof
    public_inputs: List[int]


def _gate_terms(data: CircuitData, alg, sel, consts, wires, extras) -> List:
    """All gate constraint terms x their selector, in canonical order."""
    terms = []
    for t, (name, gate) in enumerate(data.gate_types):
        for c in gate.constraints(alg, wires, consts, extras):
            terms.append(alg.mul(sel[t], c))
    return terms


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def prove(data: CircuitData, witness: np.ndarray, public_inputs: List[int]) -> Proof:
    """One proof: a batch of one through `prove_batch`, on `data.device`."""
    from mp2_tpu_torch.prover.batch import prove_batch  # batch imports this module

    return prove_batch(data, np.asarray(witness, dtype=np.uint64)[None],
                       [list(public_inputs)])[0]
