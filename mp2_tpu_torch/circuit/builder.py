"""CircuitBuilder: construct TP2 circuits (rows of wide gates + routed-wire
copy constraints), compile to prover-ready CircuitData.

A jax-free copy of `mp2_tpu/circuit/builder.py`: only the imports change,
and `build()` takes the device of the port's CircuitData.

Equivalent in role to plonky2's CircuitBuilder as used across the reference
(every gadget layer builds on it); the design is row-oriented so that all
per-row structures (selector/constant/sigma columns) become polynomial
columns evaluated by vectorized device code.

Key invariants:
  * a Target IS a concrete cell (row, col) of the routed trace;
  * copy constraints are a union-find over cells; witness values are stored
    per equivalence class, so connected cells can never disagree;
  * witness generation is an ordered list of (output cell, fn(read)) host
    closures recorded by the gadget helpers (vectorized witgen is a later
    optimization: SURVEY.md §7 hard part 4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.hash.constants import RATE, ROUNDS_F, ROUNDS_P, WIDTH, load_table
from mp2_tpu_torch.circuit import gates as G
from mp2_tpu_torch.prover.config import CircuitConfig

_EXT_RC, _INT_RC, _INT_DIAG = load_table()

Target = Tuple[int, int]  # (row, col)


class _DSU:
    def __init__(self):
        self.parent: Dict[Target, Target] = {}

    def find(self, x: Target) -> Target:
        # iterative with full path compression (chains can be deep)
        root = x
        while self.parent.get(root, root) != root:
            root = self.parent[root]
        while self.parent.get(x, x) != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: Target, b: Target):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


@dataclass
class Row:
    gate: G.Gate
    constants: List[int]


class CircuitBuilder:
    def __init__(self, config: Optional[CircuitConfig] = None):
        self.config = config or CircuitConfig()
        self.rows: List[Row] = []
        self.dsu = _DSU()
        self.generators: List[Tuple[Target, Callable]] = []
        self.public_inputs: List[Target] = []
        self._const_targets: Dict[int, Target] = {}
        self._const_row: Optional[int] = None
        self._const_slot = 0
        self._arith_rows: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._gadget_rows: Dict = {}
        self._input_row: Optional[int] = None
        self._input_slot = 0
        self._zero = None
        self._one = None

    # ------------------------------------------------------------ inputs
    def add_input(self) -> Target:
        """Allocate an unconstrained cell (prover-supplied value), like
        plonky2's add_virtual_target.  Cells come from noop rows."""
        if self._input_row is None or self._input_slot >= self.config.num_wires:
            self._input_row = self.add_row(G.NoopGate())
            self._input_slot = 0
        t = (self._input_row, self._input_slot)
        self._input_slot += 1
        return t

    def add_inputs(self, k: int) -> List[Target]:
        return [self.add_input() for _ in range(k)]

    # ------------------------------------------------------------------ rows
    def add_row(self, gate: G.Gate, constants: Sequence[int] = ()) -> int:
        assert len(constants) <= self.config.num_constants
        self.rows.append(Row(gate, [c % P for c in constants]))
        return len(self.rows) - 1

    def connect(self, a: Target, b: Target):
        self.dsu.union(a, b)

    def add_generator(self, out: Target, fn: Callable):
        """fn(read: Callable[[Target], int]) -> int"""
        self.generators.append((out, fn))

    # ------------------------------------------------------------- constants
    def constant(self, c: int) -> Target:
        c %= P
        if c in self._const_targets:
            return self._const_targets[c]
        num_ops = 8
        if self._const_row is None or self._const_slot >= num_ops:
            self._const_row = self.add_row(G.ConstantGate(num_ops), [0] * num_ops)
            self._const_slot = 0
        row, slot = self._const_row, self._const_slot
        self.rows[row].constants[slot] = c
        self._const_slot += 1
        t = (row, slot)
        self.add_generator(t, lambda read, c=c: c)
        self._const_targets[c] = t
        return t

    def zero(self) -> Target:
        if self._zero is None:
            self._zero = self.constant(0)
        return self._zero

    def one(self) -> Target:
        if self._one is None:
            self._one = self.constant(1)
        return self._one

    # ------------------------------------------------------ arithmetic layer
    def _arith_slot(self, c0: int, c1: int) -> Tuple[int, int]:
        """Allocate an op slot in an arithmetic row keyed by (c0, c1)."""
        num_ops = self.config.num_wires // 4
        key = (c0 % P, c1 % P)
        row, slot = self._arith_rows.get(key, (None, num_ops))
        if row is None or slot >= num_ops:
            row = self.add_row(G.ArithmeticGate(num_ops), [key[0], key[1]])
            slot = 0
        self._arith_rows[key] = (row, slot + 1)
        return row, slot

    def _arith_op(self, c0: int, c1: int, x: Target, y: Target, z: Target) -> Target:
        row, slot = self._arith_slot(c0, c1)
        gate: G.ArithmeticGate = self.rows[row].gate
        wx, wy, wz, wo = gate.wires_for_op(slot)
        self.connect((row, wx), x)
        self.connect((row, wy), y)
        self.connect((row, wz), z)
        out = (row, wo)

        def gen(read, x=x, y=y, z=z, c0=c0 % P, c1=c1 % P):
            return (c0 * read(x) * read(y) + c1 * read(z)) % P

        self.add_generator(out, gen)
        # mirror values onto the op's own cells (they are the same class as
        # x/y/z but the class representative needs a value; generators write
        # class-wide so nothing more to do)
        return out

    def add(self, a: Target, b: Target) -> Target:
        return self._arith_op(1, 1, a, self.one(), b)

    def sub(self, a: Target, b: Target) -> Target:
        return self._arith_op(1, P - 1, a, self.one(), b)

    def mul(self, a: Target, b: Target) -> Target:
        return self._arith_op(1, 0, a, b, self.zero())

    def mul_add(self, a: Target, b: Target, c: Target) -> Target:
        """a*b + c"""
        return self._arith_op(1, 1, a, b, c)

    def mul_const(self, c: int, a: Target) -> Target:
        return self._arith_op(c, 0, a, self.one(), self.zero())

    def add_const(self, a: Target, c: int) -> Target:
        return self._arith_op(1, c, a, self.one(), self.one())

    # ------------------------------------------------------- range/zero ops
    def decompose_bits(self, t: Target, bits: int) -> List[Target]:
        """Constrain t = sum b_i 2^i with boolean b_i; returns bit targets
        (LSB first).  This IS the range check: t < 2^bits."""
        key = ("decomp", bits)
        num_ops = self.config.num_wires // (bits + 1)
        assert num_ops >= 1, f"{bits}-bit decompose does not fit the row"
        row, slot = self._gadget_rows.get(key, (None, num_ops))
        if row is None or slot >= num_ops:
            row = self.add_row(G.BitDecomposeGate(num_ops, bits))
            slot = 0
        self._gadget_rows[key] = (row, slot + 1)
        gate: G.BitDecomposeGate = self.rows[row].gate
        vw, bit_ws = gate.wires_for_op(slot)
        self.connect((row, vw), t)
        bit_targets = [(row, bw) for bw in bit_ws]
        for k, bt in enumerate(bit_targets):
            self.add_generator(
                bt, lambda read, t=t, k=k: (read(t) >> k) & 1
            )
        return bit_targets

    def assert_u32(self, t: Target):
        self.decompose_bits(t, 32)

    def is_zero(self, t: Target) -> Target:
        """Returns a boolean target: 1 iff t == 0."""
        key = ("is_zero",)
        num_ops = self.config.num_wires // 3
        row, slot = self._gadget_rows.get(key, (None, num_ops))
        if row is None or slot >= num_ops:
            row = self.add_row(G.IsZeroGate(num_ops))
            slot = 0
        self._gadget_rows[key] = (row, slot + 1)
        gate: G.IsZeroGate = self.rows[row].gate
        xw, invw, ow = gate.wires_for_op(slot)
        self.connect((row, xw), t)
        self.add_generator(
            (row, invw), lambda read, t=t: pow(read(t), P - 2, P) if read(t) else 0
        )
        self.add_generator(
            (row, ow), lambda read, t=t: 1 if read(t) == 0 else 0
        )
        return (row, ow)

    def is_equal(self, a: Target, b: Target) -> Target:
        return self.is_zero(self.sub(a, b))

    def logic_and(self, a: Target, b: Target) -> Target:
        return self.mul(a, b)

    def logic_not(self, a: Target) -> Target:
        """For boolean a."""
        return self._arith_op(P - 1, 1, a, self.one(), self.one())

    def logic_or(self, a: Target, b: Target) -> Target:
        """a + b - a*b (booleans)."""
        return self.sub(self.add(a, b), self.mul(a, b))

    def logic_xor(self, a: Target, b: Target) -> Target:
        """a + b - 2ab (booleans)."""
        ab2 = self._arith_op(2, 0, a, b, self.zero())
        return self.sub(self.add(a, b), ab2)

    def select(self, bit: Target, x: Target, y: Target) -> Target:
        """bit ? x : y  =  bit*(x - y) + y  (bit boolean)."""
        return self.mul_add(bit, self.sub(x, y), y)

    # ------------------------------------------------------------- poseidon2
    def poseidon2_permute(self, state: Sequence[Target]) -> List[Target]:
        """Full permutation in ONE row (gates.Poseidon2Gate); falls back to
        the 30-row per-round gates on narrow configs."""
        assert len(state) == WIDTH
        if self.config.num_wires >= G.Poseidon2Gate.NUM_WIRES:
            return self._p2_single_row(state)
        return self._p2_per_round(state)

    def _p2_single_row(self, state: Sequence[Target]) -> List[Target]:
        gate = G.Poseidon2Gate()
        row = self.add_row(gate)
        for i, t in enumerate(state):
            self.connect((row, gate._IN + i), t)

        def compute(read, state=tuple(state)):
            vals = [read(t) for t in state]
            sf, ps, sl, out = p2h.permute_trace(vals)
            cells = {}
            for r in range(4):
                for i in range(WIDTH):
                    cells[gate._SF + r * WIDTH + i] = sf[r][i]
            for j, v in enumerate(ps):
                cells[gate._P + j] = v
            for r in range(3):
                for i in range(WIDTH):
                    cells[gate._SL + r * WIDTH + i] = sl[r][i]
            for i in range(WIDTH):
                cells[gate._OUT + i] = out[i]
            return cells

        def lane(col):
            def g(read, col=col, rowkey=row):
                cache = getattr(read, "_p2cache", None)
                if cache is None:
                    cache = {}
                    read._p2cache = cache
                if rowkey not in cache:
                    cache[rowkey] = compute(read)
                return cache[rowkey][col]

            return g

        wire_cols = (
            [gate._SF + k for k in range(4 * WIDTH)]
            + [gate._P + j for j in range(G.ROUNDS_P)]
            + [gate._SL + k for k in range(3 * WIDTH)]
            + [gate._OUT + i for i in range(WIDTH)]
        )
        for col in wire_cols:
            self.add_generator((row, col), lane(col))
        return [(row, gate._OUT + i) for i in range(WIDTH)]

    def _p2_per_round(self, state: Sequence[Target]) -> List[Target]:
        cur = list(state)
        half = G.ROUNDS_F // 2
        for r in range(half):
            cur = self._p2_round(
                G.Poseidon2FullRoundGate(first=(r == 0)), cur, _EXT_RC[r], full=True,
                first=(r == 0),
            )
        for r in range(G.ROUNDS_P):
            cur = self._p2_round(
                G.Poseidon2PartialRoundGate(), cur, [_INT_RC[r]], full=False,
                first=False,
            )
        for r in range(half, G.ROUNDS_F):
            cur = self._p2_round(
                G.Poseidon2FullRoundGate(first=False), cur, _EXT_RC[r], full=True,
                first=False,
            )
        return cur

    def _p2_round(self, gate, state, rc, full: bool, first: bool) -> List[Target]:
        row = self.add_row(gate, rc)
        for i, t in enumerate(state):
            self.connect((row, i), t)
        outs = [(row, WIDTH + i) for i in range(WIDTH)]

        def gen_round(read, state=tuple(state), rc=tuple(rc), full=full, first=first):
            vals = [read(t) for t in state]
            if full:
                if first:
                    vals = p2h._external_linear(vals)
                vals = [p2h._sbox((v + c) % P) for v, c in zip(vals, rc)]
                return p2h._external_linear(vals)
            vals[0] = p2h._sbox((vals[0] + rc[0]) % P)
            return p2h._internal_linear(vals)

        # One generator per output lane.  The round is computed once per
        # witness generation, memoized on the per-generation `read` closure
        # (a fresh object each generate_witness call, so circuits stay
        # reusable across proofs).
        def lane(i):
            def g(read, i=i, rowkey=row):
                cache = getattr(read, "_p2cache", None)
                if cache is None:
                    cache = {}
                    read._p2cache = cache
                if rowkey not in cache:
                    cache[rowkey] = gen_round(read)
                return cache[rowkey][i]

            return g

        for i, o in enumerate(outs):
            self.add_generator(o, lane(i))
        return outs

    def hash_n_to_m_no_pad(self, inputs: Sequence[Target], m: int) -> List[Target]:
        state = [self.zero()] * WIDTH
        for i in range(0, len(inputs), RATE):
            chunk = list(inputs[i : i + RATE])
            state = chunk + state[len(chunk) :]
            state = self.poseidon2_permute(state)
        out: List[Target] = []
        while True:
            for t in state[:RATE]:
                out.append(t)
                if len(out) == m:
                    return out
            state = self.poseidon2_permute(state)

    def hash_no_pad(self, inputs: Sequence[Target]) -> List[Target]:
        return self.hash_n_to_m_no_pad(inputs, 4)

    def two_to_one(self, left: Sequence[Target], right: Sequence[Target]):
        return self.hash_no_pad(list(left) + list(right))

    # --------------------------------------------------------- public inputs
    def register_public_input(self, t: Target):
        self.public_inputs.append(t)

    def register_public_inputs(self, ts: Sequence[Target]):
        for t in ts:
            self.register_public_input(t)

    # ------------------------------------------------------------- finalize
    def build(self, device, min_rows: int = 0) -> "CircuitData":
        """Compile to the port's CircuitData, fixed data on `device`."""
        from mp2_tpu_torch.prover.prove import CircuitData  # cycle-free import

        self._min_rows = min_rows

        # pad unused is_zero slots: their constraint needs out = 1 when the
        # (defaulted-to-zero) input is zero
        key = ("is_zero",)
        if key in self._gadget_rows:
            row, slot = self._gadget_rows[key]
            gate = self.rows[row].gate
            for s in range(slot, gate.num_ops):
                _, _, ow = gate.wires_for_op(s)
                self.add_generator((row, ow), lambda read: 1)

        # in-circuit hash of public inputs, routed into the PI gate
        pi_hash_targets = self.hash_no_pad(self.public_inputs)
        pi_row = self.add_row(G.PublicInputGate())
        for i in range(4):
            self.connect((pi_row, i), pi_hash_targets[i])

        return CircuitData.compile(self, device)
