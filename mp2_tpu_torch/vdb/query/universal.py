"""The WITNESS-DRIVEN universal query circuit: one circuit (one VK) for
every supported SELECT/WHERE query.

Role of the reference's universal_query_circuit
(verifiable-db/src/query/universal_circuit/{universal_query_circuit.rs,
basic_operation.rs, universal_circuit_inputs.rs}): the operation lists
arrive as WITNESSES into fixed op-slot banks; every slot evaluates the full
U256 operation battery and one-hot-selects the result; the circuit exposes

  computational_hash  — in-circuit Poseidon commitment to the witnessed
                        query structure (ops, operands, outputs, distinct),
                        byte-identical to the host `ops.computational_hash`
                        padded to the circuit bounds — the verifier derives
                        the same hash from the SQL text and needs no
                        per-query VK;
  placeholder_hash    — commitment to (min, max, (name_hash, value)*) slots
                        (api.placeholder_hash padded);
  column_commitment   — Poseidon hash of the row's column values, binding
                        the row to the committed tree for the aggregation
                        layer;
  predicate_bit, overflow, output values.

Compile-time bounds (op-slot counts, columns, placeholders, outputs) are
the const generics of QueryParameters (api.rs:217-267).

A jax-free copy of `mp2_tpu/vdb/query/universal.py`: only the imports
change. `build_universal_query_circuit` takes the device a standalone
circuit is compiled for (`device="cuda"` unless the caller asks for the
CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.u256 import (
    U256Target,
    add_virtual_u256,
    set_u256,
    u256_add,
    u256_div_mod,
    u256_equal,
    u256_from_bool,
    u256_is_zero,
    u256_less_than,
    u256_mul,
    u256_sub,
)
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.prover.config import CircuitConfig, test_config
from mp2_tpu_torch.prover.prove import CircuitData, prove
from mp2_tpu_torch.utils.u256 import u256_to_fields
from mp2_tpu_torch.vdb.query.ops import (
    BasicOperation,
    Operand,
    Operation,
    Placeholders,
    QueryBounds,
    ResultStructure,
    computational_hash,
)

NUM_OPS = 15  # Operation enum size


@dataclass(frozen=True)
class UniversalQueryParams:
    """Compile-time bounds (the reference's QueryParameters const generics,
    reduced defaults for CPU-testable circuit sizes)."""

    num_columns: int = 3
    num_placeholders: int = 4
    num_predicate_ops: int = 6
    num_result_ops: int = 4
    num_outputs: int = 2


def _bool_input(b: CircuitBuilder) -> Target:
    t = b.add_input()
    b.connect(b.mul(t, t), t)
    return t


def _one_hot(b: CircuitBuilder, n: int, total_is_one: bool) -> List[Target]:
    bits = [_bool_input(b) for _ in range(n)]
    acc = bits[0]
    for t in bits[1:]:
        acc = b.add(acc, t)
    if total_is_one:
        b.connect(acc, b.one())
    return bits


def _mux_scalar(b, bits, values) -> Target:
    acc = b.zero()
    for bit, v in zip(bits, values):
        acc = b.mul_add(bit, v, acc)
    return acc


def _mux_u256(b, bits, values: Sequence[U256Target]) -> U256Target:
    limbs = []
    for i in range(8):
        acc = b.zero()
        for bit, v in zip(bits, values):
            acc = b.mul_add(bit, v.limbs[i], acc)
        limbs.append(acc)
    return U256Target(tuple(limbs))


def _truthy(b, v: U256Target) -> Target:
    return b.logic_not(u256_is_zero(b, v))


@dataclass
class _OperandSlot:
    """STRUCTURE of one operand selection (shared across all rows of a
    chunk circuit — the reference's UniversalQueryHashInputWires split,
    universal_query_gadget.rs:497-560): the one-hot selector, constant
    value, and computational-hash encoding.  Per-row VALUES are produced
    by `_operand_value`."""

    onehot: List[Target]  # over [columns | placeholders | const | previous | none?]
    const_value: U256Target
    kind_field: Target
    payload_field: Target
    allow_none: bool


def _operand_slot(
    b: CircuitBuilder,
    nc: int,
    ph_name_hs: List[Target],
    npr: int,
    allow_none: bool,
) -> _OperandSlot:
    np_ = len(ph_name_hs)
    total = nc + np_ + 1 + npr + (1 if allow_none else 0)
    oh = _one_hot(b, total, total_is_one=True)
    const_value = add_virtual_u256(b)

    # encoded (kind, payload) mirroring ops._operand_fields
    oh_col = oh[:nc]
    oh_ph = oh[nc : nc + np_]
    oh_const = oh[nc + np_]
    oh_prev = oh[nc + np_ + 1 : nc + np_ + 1 + npr]
    is_col = _mux_scalar(b, oh_col, [b.one()] * nc) if nc else b.zero()
    is_ph = _mux_scalar(b, oh_ph, [b.one()] * np_) if np_ else b.zero()
    is_prev = _mux_scalar(b, oh_prev, [b.one()] * npr) if npr else b.zero()
    kind = b.add(
        b.add(b.mul_const(3, is_col), is_ph),
        b.add(b.mul_const(2, oh_const), b.mul_const(4, is_prev)),
    )
    const_h = b.hash_no_pad(list(const_value.limbs))
    payload = b.zero()
    for j, bit in enumerate(oh_col):
        payload = b.mul_add(bit, b.constant(j), payload)
    for bit, nh in zip(oh_ph, ph_name_hs):
        payload = b.mul_add(bit, nh, payload)
    payload = b.mul_add(oh_const, const_h[0], payload)
    for j, bit in enumerate(oh_prev):
        payload = b.mul_add(bit, b.constant(j), payload)
    return _OperandSlot(oh, const_value, kind, payload, allow_none)


def _operand_value(
    b, slot: _OperandSlot, columns, ph_values, previous
) -> U256Target:
    candidates = list(columns) + list(ph_values) + [slot.const_value]
    candidates += list(previous)
    if slot.allow_none:
        candidates.append(U256Target(tuple([b.zero()] * 8)))
    return _mux_u256(b, slot.onehot, candidates)


@dataclass
class _OpSlot:
    """Structure of one basic-operation slot (shared across rows)."""

    active: Target
    op_onehot: List[Target]
    first: _OperandSlot
    second: _OperandSlot
    encoded: List[Target]  # 7 fields (zeroed when inactive)


@dataclass
class _OpValue:
    """Per-row evaluation of one op slot."""

    value: U256Target
    truthy: Target
    overflow: Target


def _op_slot(
    b: CircuitBuilder, nc: int, ph_name_hs, npr: int
) -> _OpSlot:
    active = _bool_input(b)
    oh = _one_hot(b, NUM_OPS, total_is_one=True)
    first = _operand_slot(b, nc, ph_name_hs, npr, False)
    second = _operand_slot(b, nc, ph_name_hs, npr, True)

    op_id = b.zero()
    for k, bit in enumerate(oh):
        op_id = b.mul_add(bit, b.constant(k), op_id)
    enc = [
        op_id,
        first.kind_field, first.payload_field, b.zero(),
        second.kind_field, second.payload_field, b.zero(),
    ]
    encoded = [b.mul(active, t) for t in enc]
    return _OpSlot(active=active, op_onehot=oh, first=first, second=second,
                   encoded=encoded)


def _op_slot_value(
    b, slot: _OpSlot, columns, ph_values, previous: List[U256Target]
) -> _OpValue:
    """Evaluate one op slot on a row's values: the full U256 operation
    battery, one-hot-selected by the SHARED op selector."""
    x = _operand_value(b, slot.first, columns, ph_values, previous)
    y = _operand_value(b, slot.second, columns, ph_values, previous)
    oh = slot.op_onehot

    add_v, add_ov = u256_add(b, x, y)
    sub_v, sub_ov = u256_sub(b, x, y)
    mul_v, mul_ov = u256_mul(b, x, y)
    div_v, mod_v = u256_div_mod(b, x, y)
    eq = u256_equal(b, x, y)
    lt = u256_less_than(b, x, y)
    gt = u256_less_than(b, y, x)
    xb = _truthy(b, x)
    yb = _truthy(b, y)
    results = {
        Operation.ADD: add_v,
        Operation.SUB: sub_v,
        Operation.MUL: mul_v,
        Operation.DIV: div_v,
        Operation.MOD: mod_v,
        Operation.EQ: u256_from_bool(b, eq),
        Operation.NE: u256_from_bool(b, b.logic_not(eq)),
        Operation.LT: u256_from_bool(b, lt),
        Operation.GT: u256_from_bool(b, gt),
        Operation.LE: u256_from_bool(b, b.logic_not(gt)),
        Operation.GE: u256_from_bool(b, b.logic_not(lt)),
        Operation.AND: u256_from_bool(b, b.logic_and(xb, yb)),
        Operation.OR: u256_from_bool(b, b.logic_or(xb, yb)),
        Operation.NOT: u256_from_bool(b, b.logic_not(xb)),
        Operation.XOR: u256_from_bool(b, b.logic_xor(xb, yb)),
    }
    value = _mux_u256(b, oh, [results[Operation(k)] for k in range(NUM_OPS)])
    ovs = [b.zero()] * NUM_OPS
    ovs[int(Operation.ADD)] = add_ov
    ovs[int(Operation.SUB)] = sub_ov
    ovs[int(Operation.MUL)] = mul_ov
    overflow = b.mul(slot.active, _mux_scalar(b, oh, ovs))
    return _OpValue(value=value, truthy=_truthy(b, value), overflow=overflow)


def _op_bank(b, n_slots, nc, ph_name_hs):
    slots: List[_OpSlot] = []
    for i in range(n_slots):
        slots.append(_op_slot(b, nc, ph_name_hs, npr=i))
    # actives must form a prefix (evaluation order semantics)
    for i in range(1, n_slots):
        b.connect(
            b.mul(slots[i].active, b.logic_not(slots[i - 1].active)), b.zero()
        )
    return slots


def _op_bank_values(b, slots, columns, ph_values) -> List[_OpValue]:
    vals: List[_OpValue] = []
    for s in slots:
        prev = [v.value for v in vals]
        vals.append(_op_slot_value(b, s, columns, ph_values, prev))
    return vals


def _last_active_truthy(b, slots: List[_OpSlot], vals: List[_OpValue]) -> Target:
    """Value of the LAST active slot's truthiness; 1 when no slot active
    (empty predicate = true)."""
    if not slots:
        return b.one()
    acc = b.zero()
    for i, (s, v) in enumerate(zip(slots, vals)):
        nxt_active = slots[i + 1].active if i + 1 < len(slots) else b.zero()
        is_last = b.mul(s.active, b.logic_not(nxt_active))
        acc = b.mul_add(is_last, v.truthy, acc)
    none_active = b.logic_not(slots[0].active)
    return b.add(acc, none_active)


def _count_active(b, slots) -> Target:
    acc = b.zero()
    for s in slots:
        acc = b.add(acc, s.active)
    return acc


@dataclass
class _OutputSlot:
    active: Target
    onehot: List[Target]  # over [columns | result slots]
    out_id: Target
    agg_id: Target
    encoded: List[Target]  # 4 fields


def _output_slot(b, nc: int, n_results: int) -> _OutputSlot:
    oh = _one_hot(b, nc + n_results, total_is_one=True)
    active = _bool_input(b)
    out_id = b.add_input()
    agg_id = b.add_input()
    is_computed = (
        _mux_scalar(b, oh[nc:], [b.one()] * n_results)
        if n_results else b.zero()
    )
    idx = b.zero()
    for j, bit in enumerate(oh[:nc]):
        idx = b.mul_add(bit, b.constant(j), idx)
    for j, bit in enumerate(oh[nc:]):
        idx = b.mul_add(bit, b.constant(j), idx)
    encoded = [b.mul(active, t) for t in (is_computed, idx, out_id, agg_id)]
    return _OutputSlot(active, oh, out_id, agg_id, encoded)


def _output_value(b, slot: _OutputSlot, columns, result_values) -> U256Target:
    return _mux_u256(b, slot.onehot, list(columns) + list(result_values))


@dataclass
class UniversalQueryCircuit:
    params: UniversalQueryParams
    data: CircuitData
    assign: callable
    # key wires for callers embedding this circuit (tree-binding layers):
    # {columns: [U256Target], column_ids: [Target]} — None on host-only use
    wires: Optional[Dict] = None

    def prove_row(self, pis, column_ids, row, placeholders, bounds):
        inputs: Dict = {}
        self.assign(inputs, pis, column_ids, row, placeholders, bounds)
        expected = self.expected_public_inputs(
            pis, column_ids, row, placeholders, bounds
        )
        w = self.data.generate_witness(inputs)
        return prove(self.data, w, expected)

    def expected_public_inputs(self, pis, column_ids, row, placeholders, bounds):
        from mp2_tpu_torch.vdb.query.api import placeholder_hash
        from mp2_tpu_torch.vdb.query.ops import eval_predicate, eval_result_row

        p = self.params
        ch = computational_hash(
            pis.predicate_ops, pis.result, column_ids,
            p.num_predicate_ops, p.num_result_ops, p.num_outputs,
        )
        ph_h = placeholder_hash(
            pis.placeholder_names, placeholders, bounds, p.num_placeholders
        )
        cc = p2h.hash_no_pad([f for v in row for f in u256_to_fields(v)])
        pred, ov1 = eval_predicate(pis.predicate_ops, row, placeholders)
        if p.num_columns >= 2:
            # mirror of the circuit's soft secondary-range gating
            pred = pred and (
                getattr(bounds, "min_secondary", 0) <= row[1]
                <= getattr(bounds, "max_secondary", (1 << 256) - 1)
            )
        outs, ov2 = eval_result_row(pis.result, row, placeholders)
        aggs = [
            int(pis.result.aggregations[j])
            if j < len(pis.result.aggregations) else 0
            for j in range(p.num_outputs)
        ]
        out_vals = []
        for j in range(p.num_outputs):
            out_vals.extend(
                u256_to_fields(outs[j] if j < len(outs) else 0)
            )
        return (
            list(ch) + list(ph_h) + list(cc)
            + [1 if pred else 0, 1 if (ov1 or ov2) else 0]
            + aggs + out_vals
        )


@dataclass
class QueryStructure:
    """The SHARED (per-query, row-independent) wires of the universal
    query circuit — the reference's UniversalQueryHashInputWires
    (universal_query_gadget.rs:490-560): selectors, placeholder bank,
    all four query bounds, and the computational/placeholder hashes.
    A chunk circuit builds this ONCE and evaluates `eval_row` per row."""

    params: UniversalQueryParams
    column_ids: List[Target]
    ph_name_hs: List[Target]
    ph_values: List[U256Target]
    ph_active: List[Target]
    bound_min: U256Target       # primary
    bound_max: U256Target
    bound_min_s: U256Target     # secondary
    bound_max_s: U256Target
    pred_slots: List[_OpSlot]
    res_slots: List[_OpSlot]
    out_slots: List[_OutputSlot]
    distinct: Target
    comp_hash: List[Target]
    ph_hash: List[Target]
    assign: callable  # assign(inputs, pis, column_ids_v, placeholders, bounds)

    def agg_ids(self, b) -> List[Target]:
        return [b.mul(s.active, s.agg_id) for s in self.out_slots]


@dataclass
class RowEval:
    """Per-row evaluation outputs (the reference's
    UniversalQueryValueWires)."""

    columns: List[U256Target]
    non_dummy: Target
    pred: Target          # predicate AND secondary-in-range AND non_dummy
    overflow: Target
    out_values: List[U256Target]  # gated by output-slot activity


def build_query_structure(
    b: CircuitBuilder, p: UniversalQueryParams
) -> QueryStructure:
    column_ids = b.add_inputs(p.num_columns)
    ph_name_hs = b.add_inputs(p.num_placeholders)
    ph_values = [add_virtual_u256(b) for _ in range(p.num_placeholders)]
    ph_active = [_bool_input(b) for _ in range(p.num_placeholders)]
    bound_min = add_virtual_u256(b)
    bound_max = add_virtual_u256(b)
    bound_min_s = add_virtual_u256(b)
    bound_max_s = add_virtual_u256(b)

    nc = p.num_columns
    pred_slots = _op_bank(b, p.num_predicate_ops, nc, ph_name_hs)
    res_slots = _op_bank(b, p.num_result_ops, nc, ph_name_hs)
    out_slots = [
        _output_slot(b, nc, p.num_result_ops) for _ in range(p.num_outputs)
    ]
    distinct = _bool_input(b)

    # ---- computational hash (ops.computational_hash, padded encoding) ----
    ch_inputs: List[Target] = [b.constant(p.num_columns)] + list(column_ids)
    for tag, slots in ((1, pred_slots), (2, res_slots)):
        ch_inputs.append(b.constant(tag))
        ch_inputs.append(_count_active(b, slots))
        for s in slots:
            ch_inputs.extend(s.encoded)
    ch_inputs.append(b.constant(3))
    for s in out_slots:
        ch_inputs.extend(s.encoded)
    # 4 if distinct else 5
    ch_inputs.append(b.select(distinct, b.constant(4), b.constant(5)))
    comp_hash = b.hash_no_pad(ch_inputs)

    # ---- placeholder hash (commits ALL FOUR query bounds) ----
    ph_inputs: List[Target] = (
        list(bound_min.limbs) + list(bound_max.limbs)
        + list(bound_min_s.limbs) + list(bound_max_s.limbs)
    )
    for nh, pv, act in zip(ph_name_hs, ph_values, ph_active):
        ph_inputs.append(b.mul(act, nh))
        ph_inputs.extend(b.mul(act, l) for l in pv.limbs)
    ph_hash = b.hash_no_pad(ph_inputs)

    def assign(inputs, pis, column_ids_v, placeholders, bounds):
        for t, v in zip(column_ids, column_ids_v):
            inputs[t] = int(v)
        names = list(pis.placeholder_names)
        assert len(names) <= p.num_placeholders
        name_h = {n: p2h.hash_no_pad([ord(c) for c in n])[0] for n in names}
        for k in range(p.num_placeholders):
            if k < len(names):
                inputs[ph_name_hs[k]] = name_h[names[k]]
                set_u256(inputs, ph_values[k], placeholders.get(names[k]))
                inputs[ph_active[k]] = 1
            else:
                inputs[ph_name_hs[k]] = 0
                set_u256(inputs, ph_values[k], 0)
                inputs[ph_active[k]] = 0
        set_u256(inputs, bound_min, bounds.min_block)
        set_u256(inputs, bound_max, bounds.max_block)
        set_u256(inputs, bound_min_s, getattr(bounds, "min_secondary", 0))
        set_u256(
            inputs, bound_max_s,
            getattr(bounds, "max_secondary", U256_MAX_CONST),
        )
        inputs[distinct] = 1 if pis.result.distinct else 0

        def assign_operand(slot: _OperandSlot, o: Optional[Operand]):
            np_ = p.num_placeholders
            sel = len(slot.onehot) - 1  # default: none (last) when allowed
            cval = 0
            if o is not None:
                if o.kind == "column":
                    sel = o.value
                elif o.kind == "placeholder":
                    sel = nc + names.index(o.value)
                elif o.kind == "constant":
                    sel = nc + np_
                    cval = o.value
                else:  # previous
                    sel = nc + np_ + 1 + o.value
            for j, t in enumerate(slot.onehot):
                inputs[t] = 1 if j == sel else 0
            set_u256(inputs, slot.const_value, cval)

        def assign_bank(slots: List[_OpSlot], ops: Sequence[BasicOperation]):
            assert len(ops) <= len(slots)
            for i, s in enumerate(slots):
                if i < len(ops):
                    op = ops[i]
                    inputs[s.active] = 1
                    for k, t in enumerate(s.op_onehot):
                        inputs[t] = 1 if k == int(op.op) else 0
                    assign_operand(s.first, op.first)
                    assign_operand(s.second, op.second)
                else:
                    inputs[s.active] = 0
                    for k, t in enumerate(s.op_onehot):
                        inputs[t] = 1 if k == 0 else 0
                    assign_operand(s.first, Operand.column(0))
                    assign_operand(s.second, None)

        assign_bank(pred_slots, pis.predicate_ops)
        assign_bank(res_slots, pis.result.result_operations)

        items = pis.result.output_items
        for j, s in enumerate(out_slots):
            if j < len(items):
                item = items[j]
                inputs[s.active] = 1
                sel = (
                    item.index if item.kind == "column"
                    else p.num_columns + item.index
                )
                inputs[s.out_id] = pis.result.output_ids[j]
                inputs[s.agg_id] = int(pis.result.aggregations[j])
            else:
                inputs[s.active] = 0
                sel = 0
                inputs[s.out_id] = 0
                inputs[s.agg_id] = 0
            for k, t in enumerate(s.onehot):
                inputs[t] = 1 if k == sel else 0

    return QueryStructure(
        params=p, column_ids=column_ids, ph_name_hs=ph_name_hs,
        ph_values=ph_values, ph_active=ph_active,
        bound_min=bound_min, bound_max=bound_max,
        bound_min_s=bound_min_s, bound_max_s=bound_max_s,
        pred_slots=pred_slots, res_slots=res_slots, out_slots=out_slots,
        distinct=distinct, comp_hash=comp_hash, ph_hash=ph_hash,
        assign=assign,
    )


U256_MAX_CONST = (1 << 256) - 1


def eval_row(
    b: CircuitBuilder,
    st: QueryStructure,
    columns: List[U256Target],
    non_dummy: Optional[Target] = None,
) -> RowEval:
    """Evaluate the shared query structure on one row's column values
    (UniversalQueryValueInputs::build, universal_query_gadget.rs:1307-1440):
    predicate AND secondary-in-range AND non-dummy, result outputs, and
    the overflow flag (zeroed for dummy rows)."""
    from mp2_tpu_torch.circuit.gadgets.u256 import u256_lte

    p = st.params
    if non_dummy is None:
        non_dummy = b.one()
    pred_vals = _op_bank_values(b, st.pred_slots, columns, st.ph_values)
    res_vals = _op_bank_values(b, st.res_slots, columns, st.ph_values)
    pred_bit = _last_active_truthy(b, st.pred_slots, pred_vals)
    # secondary-index range membership is SOFT: out-of-range rows may be
    # proven (to keep row chains contiguous) but never match
    if p.num_columns >= 2:
        in_range = b.logic_and(
            u256_lte(b, st.bound_min_s, columns[1]),
            u256_lte(b, columns[1], st.bound_max_s),
        )
        pred_bit = b.logic_and(pred_bit, in_range)
    pred_bit = b.mul(pred_bit, non_dummy)
    overflow = b.zero()
    for v in pred_vals + res_vals:
        overflow = b.logic_or(overflow, v.overflow)
    overflow = b.mul(overflow, non_dummy)
    out_values = []
    for s in st.out_slots:
        val = _output_value(b, s, columns, [v.value for v in res_vals])
        out_values.append(
            U256Target(tuple(b.mul(s.active, l) for l in val.limbs))
        )
    return RowEval(
        columns=columns, non_dummy=non_dummy, pred=pred_bit,
        overflow=overflow, out_values=out_values,
    )


def build_universal_query_circuit(
    params: UniversalQueryParams = UniversalQueryParams(),
    config: Optional[CircuitConfig] = None,
    builder: Optional[CircuitBuilder] = None,
    device="cuda",
) -> UniversalQueryCircuit:
    p = params
    b = builder if builder is not None else CircuitBuilder(config or test_config())

    columns = [add_virtual_u256(b) for _ in range(p.num_columns)]
    st = build_query_structure(b, p)
    ev = eval_row(b, st, columns)  # non_dummy pinned to 1

    # ---- column commitment ----
    col_comm = b.hash_no_pad([l for c in columns for l in c.limbs])

    b.register_public_inputs(st.comp_hash)
    b.register_public_inputs(st.ph_hash)
    b.register_public_inputs(col_comm)
    b.register_public_input(ev.pred)
    b.register_public_input(ev.overflow)
    for t in st.agg_ids(b):
        # aggregation id per output (already committed in the computational
        # hash; exposed so chunk circuits can aggregate without re-deriving)
        b.register_public_input(t)
    for val in ev.out_values:
        # inactive slots expose zeros (host pads absent outputs with 0)
        b.register_public_inputs(list(val.limbs))

    # ------------------------------------------------------------- assign
    def assign(inputs, pis, column_ids_v, row, placeholders, bounds):
        assert len(row) == p.num_columns
        for t, v in zip(columns, row):
            set_u256(inputs, t, v)
        st.assign(inputs, pis, column_ids_v, placeholders, bounds)

    data = b.build(device) if builder is None else None
    return UniversalQueryCircuit(
        params=p, data=data, assign=assign,
        wires=dict(columns=columns, column_ids=st.column_ids, structure=st),
    )
