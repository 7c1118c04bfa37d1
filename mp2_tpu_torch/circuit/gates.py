"""Gate library: each row of the trace carries one gate instance.

A jax-free copy of `mp2_tpu/circuit/gates.py` (only the imports change).

Wide single-row gates in the plonky2 style (no next-row references — chained
structures like Poseidon permutations connect consecutive rows through the
routed-wire copy permutation).  Every gate implements `constraints(alg, ...)`
over the algebra abstraction so the same definition serves the device quotient
evaluation, the host verifier, and (later) the in-circuit verifier gadget.

Constraint degree budget: selector (1) x constraint (<= 7+1) must stay within
the quotient factor 8 (composition degree <= 9 with the permutation chunks).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash.constants import ROUNDS_F, ROUNDS_P, WIDTH, load_table
from mp2_tpu_torch.hash.constants import M4

_EXT_RC, _INT_RC, _INT_DIAG = load_table()


class Gate:
    """Base gate: `name` keys the selector group."""

    name: str = "gate"
    degree: int = 1

    def num_constraints(self) -> int:
        raise NotImplementedError

    def constraints(self, alg, wires: Sequence, constants: Sequence, extras: Dict):
        """Return the list of constraint values (must vanish on gate rows)."""
        raise NotImplementedError


class NoopGate(Gate):
    name = "noop"

    def num_constraints(self):
        return 0

    def constraints(self, alg, wires, constants, extras):
        return []


class ArithmeticGate(Gate):
    """num_ops independent ops: out = c0 * x * y + c1 * z.

    Wires per op: [x, y, z, out]; shares the row's two constants (c0, c1)
    like plonky2's ArithmeticGate.
    """

    name = "arithmetic"
    degree = 3

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    def num_constraints(self):
        return self.num_ops

    def wires_for_op(self, i: int):
        base = 4 * i
        return base, base + 1, base + 2, base + 3

    def constraints(self, alg, wires, constants, extras):
        c0, c1 = constants[0], constants[1]
        if getattr(alg, "vectorized", False) and self.num_ops > 1:
            x = alg.stack([wires[4 * i] for i in range(self.num_ops)])
            y = alg.stack([wires[4 * i + 1] for i in range(self.num_ops)])
            z = alg.stack([wires[4 * i + 2] for i in range(self.num_ops)])
            o = alg.stack([wires[4 * i + 3] for i in range(self.num_ops)])
            t = alg.add(alg.mul(alg.mul(x, y), c0), alg.mul(z, c1))
            return alg.unstack(alg.sub(o, t))
        out = []
        for i in range(self.num_ops):
            x, y, z, o = (wires[j] for j in self.wires_for_op(i))
            t = alg.mul(alg.mul(x, y), c0)
            t = alg.add(t, alg.mul(z, c1))
            out.append(alg.sub(o, t))
        return out


class ConstantGate(Gate):
    """num_ops wires pinned to per-row constants: w_i == const_i."""

    name = "constant"
    degree = 1

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    def num_constraints(self):
        return self.num_ops

    def constraints(self, alg, wires, constants, extras):
        return [alg.sub(wires[i], constants[i]) for i in range(self.num_ops)]


class PublicInputGate(Gate):
    """Wires 0..3 must equal the public-input hash (supplied at proving/
    verification time, not baked into the circuit)."""

    name = "public_input"
    degree = 1

    def num_constraints(self):
        return 4

    def constraints(self, alg, wires, constants, extras):
        pi_hash = extras["pi_hash"]  # 4 algebra values
        return [alg.sub(wires[i], pi_hash[i]) for i in range(4)]


def _m4_rows(alg, vals):
    return [
        _lin_comb(alg, [(M4[i][j], vals[j]) for j in range(4)]) for i in range(4)
    ]


def _lin_comb(alg, terms):
    acc = None
    for c, v in terms:
        t = v if c == 1 else alg.mul_const(v, c % P)
        acc = t if acc is None else alg.add(acc, t)
    return acc


def _external_linear_alg(alg, st):
    chunks = [_m4_rows(alg, st[i : i + 4]) for i in range(0, WIDTH, 4)]
    total = [
        alg.add(alg.add(chunks[0][i], chunks[1][i]), chunks[2][i]) for i in range(4)
    ]
    out = []
    for ch in chunks:
        out.extend(alg.add(ch[i], total[i]) for i in range(4))
    return out


def _internal_linear_alg(alg, st):
    s = st[0]
    for v in st[1:]:
        s = alg.add(s, v)
    return [
        alg.add(s, alg.mul_const(st[i], (_INT_DIAG[i] - 1) % P))
        for i in range(WIDTH)
    ]


class BitDecomposeGate(Gate):
    """num_ops values decomposed into `bits` boolean wires each (the range
    check primitive; role of the reference's U32RangeCheckGate).

    Wires per op: [value, b_0, ..., b_{bits-1}] (b_0 = LSB).
    Constraints: each bit boolean (b^2 - b), value = sum b_i 2^i.
    """

    name_prefix = "bit_decompose"
    degree = 2

    def __init__(self, num_ops: int, bits: int):
        self.num_ops = num_ops
        self.bits = bits
        self.name = f"{self.name_prefix}{bits}"

    def wires_for_op(self, i: int):
        base = (self.bits + 1) * i
        return base, list(range(base + 1, base + 1 + self.bits))

    def num_constraints(self):
        return self.num_ops * (self.bits + 1)

    def constraints(self, alg, wires, constants, extras):
        if getattr(alg, "vectorized", False):
            ops, bits = self.num_ops, self.bits
            vals = alg.stack(
                [wires[self.wires_for_op(i)[0]] for i in range(ops)]
            )
            bws = alg.stack(
                [wires[k] for i in range(ops) for k in self.wires_for_op(i)[1]]
            )  # (ops*bits, ...)
            boo = alg.unstack(alg.sub(alg.mul(bws, bws), bws))
            wt = [
                [
                    (1 << (j % bits)) if j // bits == i else 0
                    for j in range(ops * bits)
                ]
                for i in range(ops)
            ]
            sums = alg.matmul_const(wt, bws)
            sumc = alg.unstack(alg.sub(vals, sums))
            out = []
            for i in range(ops):
                out.extend(boo[i * bits : (i + 1) * bits])
                out.append(sumc[i])
            return out
        out = []
        for i in range(self.num_ops):
            v, bit_idx = self.wires_for_op(i)
            acc = None
            for k, bi in enumerate(bit_idx):
                b = wires[bi]
                out.append(alg.sub(alg.mul(b, b), b))  # booleanity
                term = alg.mul_const(b, 1 << k)
                acc = term if acc is None else alg.add(acc, term)
            out.append(alg.sub(wires[v], acc))
        return out


class IsZeroGate(Gate):
    """num_ops of: out = (x == 0), using a witness pseudo-inverse.

    Wires per op: [x, inv, out]; constraints: x*inv + out - 1 = 0 and
    x*out = 0 (so out=1 iff x=0, out=0 with inv=x^-1 otherwise).
    """

    name = "is_zero"
    degree = 2

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    def wires_for_op(self, i: int):
        return 3 * i, 3 * i + 1, 3 * i + 2

    def num_constraints(self):
        return 2 * self.num_ops

    def constraints(self, alg, wires, constants, extras):
        if getattr(alg, "vectorized", False) and self.num_ops > 1:
            x = alg.stack([wires[3 * i] for i in range(self.num_ops)])
            inv = alg.stack([wires[3 * i + 1] for i in range(self.num_ops)])
            o = alg.stack([wires[3 * i + 2] for i in range(self.num_ops)])
            t1 = alg.unstack(
                alg.add_const(alg.add(alg.mul(x, inv), o), P - 1)
            )
            t2 = alg.unstack(alg.mul(x, o))
            out = []
            for i in range(self.num_ops):
                out.append(t1[i])
                out.append(t2[i])
            return out
        out = []
        for i in range(self.num_ops):
            x, inv, o = (wires[j] for j in self.wires_for_op(i))
            t = alg.add(alg.mul(x, inv), o)
            out.append(alg.sub(t, alg.constant(1)))
            out.append(alg.mul(x, o))
        return out


class Poseidon2Gate(Gate):
    """One FULL Poseidon2 permutation in a single row (the recursion
    enabler: plonky2's PoseidonGate plays the same role, 135 wires/row).

    Wire layout (130 wires):
      in[12]                    0..11    (routed)
      out[12]                   12..23   (routed)
      sf[r][12], r=0..3         24..71   state after each first-half full round
      p[j], j=0..21             72..93   partial-round s-box OUTPUTS
      sl[r][12], r=0..2         94..129  state after full rounds 4..6
    The state inside the partial-round span is an AFFINE function of
    (sf[3], p[0..j]); constraints materialize it only at each s-box input and
    at the re-entry to the full rounds, so every constraint stays degree 7.
    Round constants are baked into the gate (not row constants).
    """

    name = "poseidon2"
    degree = 7
    NUM_WIRES = 130
    _IN = 0
    _OUT = 12
    _SF = 24
    _P = 72
    _SL = 94

    def num_constraints(self):
        return ROUNDS_F * WIDTH + ROUNDS_P  # 118

    # -- compile-time linear-algebra tables ---------------------------------
    @staticmethod
    def _me_matrix():
        """External linear layer as an explicit 12x12 int matrix."""
        # apply the layer to unit vectors (columns), transpose into rows
        cols = []
        for i in range(WIDTH):
            v = [0] * WIDTH
            v[i] = 1
            chunks = [
                [
                    sum(M4[a][b] * v[c + b] for b in range(4)) % P
                    for a in range(4)
                ]
                for c in range(0, WIDTH, 4)
            ]
            total = [sum(ch[a] for ch in chunks) % P for a in range(4)]
            out = []
            for ch in chunks:
                out.extend((ch[a] + total[a]) % P for a in range(4))
            cols.append(out)
        return [[cols[j][i] for j in range(WIDTH)] for i in range(WIDTH)]

    @staticmethod
    def _partial_affine():
        """Affine coefficient rows over the basis [sf3(12) | p(22)]:
        A_sb (22 rows): s-box input of each partial round;
        A_fin (12 rows): state lanes at re-entry to the full rounds."""
        k = WIDTH + ROUNDS_P
        state = [[1 if j == i else 0 for j in range(k)] for i in range(WIDTH)]
        a_sb = []
        for j in range(ROUNDS_P):
            a_sb.append(list(state[0]))
            state[0] = [1 if c == WIDTH + j else 0 for c in range(k)]
            s = [sum(state[i][c] for i in range(WIDTH)) % P for c in range(k)]
            state = [
                [
                    (s[c] + (_INT_DIAG[i] - 1) * state[i][c]) % P
                    for c in range(k)
                ]
                for i in range(WIDTH)
            ]
        return a_sb, state

    _TABLES = None

    @classmethod
    def _tables(cls):
        if cls._TABLES is None:
            cls._TABLES = (cls._me_matrix(), *cls._partial_affine())
        return cls._TABLES

    def constraints(self, alg, wires, constants, extras):
        if getattr(alg, "vectorized", False):
            return self._constraints_vectorized(alg, wires)
        return self._constraints_scalar(alg, wires)

    def _constraints_vectorized(self, alg, wires):
        """Stacked-lane evaluation (device quotient path): same constraint
        list, same order, ~30x smaller traced graph."""
        me, a_sb, a_fin = self._tables()
        half = ROUNDS_F // 2
        out = []
        inp = alg.stack([wires[self._IN + i] for i in range(WIDTH)])
        cur = alg.matmul_const(me, inp)
        for r in range(half):
            sb = alg.exp7(alg.add_col_const(cur, _EXT_RC[r]))
            mixed = alg.matmul_const(me, sb)
            stored = alg.stack(
                [wires[self._SF + r * WIDTH + i] for i in range(WIDTH)]
            )
            out.append(alg.sub(stored, mixed))
            cur = stored
        sfp = alg.stack(
            [wires[self._SF + 3 * WIDTH + i] for i in range(WIDTH)]
            + [wires[self._P + j] for j in range(ROUNDS_P)]
        )
        v0 = alg.matmul_const(a_sb, sfp)
        sb_out = alg.exp7(alg.add_col_const(v0, _INT_RC))
        p_stack = alg.stack([wires[self._P + j] for j in range(ROUNDS_P)])
        partial_cons = alg.sub(p_stack, sb_out)
        cur = alg.matmul_const(a_fin, sfp)
        out2 = []
        for r in range(half, ROUNDS_F):
            sb = alg.exp7(alg.add_col_const(cur, _EXT_RC[r]))
            mixed = alg.matmul_const(me, sb)
            if r < ROUNDS_F - 1:
                stored = alg.stack(
                    [wires[self._SL + (r - half) * WIDTH + i] for i in range(WIDTH)]
                )
            else:
                stored = alg.stack(
                    [wires[self._OUT + i] for i in range(WIDTH)]
                )
            out2.append(alg.sub(stored, mixed))
            cur = stored
        cons = []
        for blk in out:
            cons.extend(alg.unstack(blk))
        cons.extend(alg.unstack(partial_cons))
        for blk in out2:
            cons.extend(alg.unstack(blk))
        return cons

    def _constraints_scalar(self, alg, wires):
        half = ROUNDS_F // 2
        out = []
        cur = _external_linear_alg(alg, [wires[self._IN + i] for i in range(WIDTH)])
        # first-half full rounds -> stored states
        for r in range(half):
            sb = [
                alg.exp7(alg.add_const(cur[i], _EXT_RC[r][i]))
                for i in range(WIDTH)
            ]
            mixed = _external_linear_alg(alg, sb)
            stored = [wires[self._SF + r * WIDTH + i] for i in range(WIDTH)]
            out.extend(alg.sub(stored[i], mixed[i]) for i in range(WIDTH))
            cur = stored

        # partial rounds: symbolic affine state over stored wires
        #   each lane: (const, {wire_index: coeff})
        state = [(0, {self._SF + 3 * WIDTH + i: 1}) for i in range(WIDTH)]

        def mat(expr):
            const, terms = expr
            acc = None
            for w, c in terms.items():
                c %= P
                if c == 0:
                    continue
                t = wires[w] if c == 1 else alg.mul_const(wires[w], c)
                acc = t if acc is None else alg.add(acc, t)
            if const % P:
                acc = alg.add_const(acc, const % P)
            return acc

        def lin(exprs_coeffs):
            """Sum of (coeff, expr) pairs as a new affine expr."""
            const = 0
            terms: Dict[int, int] = {}
            for coeff, (c0, t0) in exprs_coeffs:
                const = (const + coeff * c0) % P
                for w, c in t0.items():
                    terms[w] = (terms.get(w, 0) + coeff * c) % P
            return (const, terms)

        for j in range(ROUNDS_P):
            v0 = mat(state[0])
            pj = wires[self._P + j]
            out.append(alg.sub(pj, alg.exp7(alg.add_const(v0, _INT_RC[j]))))
            state[0] = (0, {self._P + j: 1})
            s = lin([(1, e) for e in state])
            state = [
                lin([(1, s), ((_INT_DIAG[i] - 1) % P, state[i])])
                for i in range(WIDTH)
            ]

        cur = [mat(state[i]) for i in range(WIDTH)]
        # second-half full rounds; the last one binds the out wires
        for r in range(half, ROUNDS_F):
            sb = [
                alg.exp7(alg.add_const(cur[i], _EXT_RC[r][i]))
                for i in range(WIDTH)
            ]
            mixed = _external_linear_alg(alg, sb)
            if r < ROUNDS_F - 1:
                stored = [
                    wires[self._SL + (r - half) * WIDTH + i] for i in range(WIDTH)
                ]
            else:
                stored = [wires[self._OUT + i] for i in range(WIDTH)]
            out.extend(alg.sub(stored[i], mixed[i]) for i in range(WIDTH))
            cur = stored
        return out


class Poseidon2FullRoundGate(Gate):
    """One external Poseidon2 round: out = M_E((in + rc)^7).

    Wires: [in_0..in_11, out_0..out_11]; rc from the row's 12 constants.
    `first` additionally applies the initial M_E to the raw inputs.
    """

    name_first = "p2_full_first"
    name_rest = "p2_full"
    degree = 7

    def __init__(self, first: bool):
        self.first = first
        self.name = self.name_first if first else self.name_rest

    def num_constraints(self):
        return WIDTH

    def constraints(self, alg, wires, constants, extras):
        inp = list(wires[:WIDTH])
        out = list(wires[WIDTH : 2 * WIDTH])
        if self.first:
            inp = _external_linear_alg(alg, inp)
        sboxed = [alg.exp7(alg.add(inp[i], constants[i])) for i in range(WIDTH)]
        mixed = _external_linear_alg(alg, sboxed)
        return [alg.sub(out[i], mixed[i]) for i in range(WIDTH)]


class Poseidon2PartialRoundGate(Gate):
    """One internal round: out = M_I(state with lane0 -> (lane0 + rc)^7)."""

    name = "p2_partial"
    degree = 7

    def num_constraints(self):
        return WIDTH

    def constraints(self, alg, wires, constants, extras):
        inp = list(wires[:WIDTH])
        out = list(wires[WIDTH : 2 * WIDTH])
        st = [alg.exp7(alg.add(inp[0], constants[0]))] + inp[1:]
        mixed = _internal_linear_alg(alg, st)
        return [alg.sub(out[i], mixed[i]) for i in range(WIDTH)]
