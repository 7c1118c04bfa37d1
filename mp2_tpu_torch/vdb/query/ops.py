"""Universal query circuit input structures + host evaluation semantics.

Python counterparts of the reference's
verifiable-db/src/query/universal_circuit/universal_circuit_inputs.rs
(BasicOperation / InputOperand / OutputItem / ResultStructure / Placeholders)
and computational_hash_ids.rs (operation identifiers).  The host evaluation
here is the golden model of the universal query gadget: U256 arithmetic with
wrap-around + overflow tracking, comparisons/booleans producing 0/1.

A jax-free copy of `mp2_tpu/vdb/query/ops.py`: only the imports change.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.utils.u256 import U256_MAX, u256_to_fields

U256_MOD = 1 << 256


class Operation(enum.IntEnum):
    ADD = 0
    SUB = 1
    MUL = 2
    DIV = 3
    MOD = 4
    EQ = 5
    NE = 6
    LT = 7
    GT = 8
    LE = 9
    GE = 10
    AND = 11
    OR = 12
    NOT = 13
    XOR = 14


class AggregationOperation(enum.IntEnum):
    SUM = 0
    MIN = 1
    MAX = 2
    AVG = 3
    COUNT = 4
    ID = 5  # no aggregation: tabular output


@dataclass(frozen=True)
class Operand:
    kind: str  # "placeholder" | "constant" | "column" | "previous"
    value: Union[str, int]

    @staticmethod
    def placeholder(name: str) -> "Operand":
        return Operand("placeholder", name)

    @staticmethod
    def constant(v: int) -> "Operand":
        return Operand("constant", v)

    @staticmethod
    def column(index: int) -> "Operand":
        return Operand("column", index)

    @staticmethod
    def previous(index: int) -> "Operand":
        return Operand("previous", index)


@dataclass(frozen=True)
class BasicOperation:
    op: Operation
    first: Operand
    second: Optional[Operand] = None


@dataclass(frozen=True)
class OutputItem:
    kind: str  # "column" | "computed"
    index: int


@dataclass
class ResultStructure:
    result_operations: List[BasicOperation]
    output_items: List[OutputItem]
    output_ids: List[int]
    aggregations: List[AggregationOperation]
    distinct: bool = False


@dataclass
class Placeholders:
    values: Dict[str, int]  # "$1" -> value; "$MIN_BLOCK"/"$MAX_BLOCK" included

    def get(self, name: str) -> int:
        if name not in self.values:
            raise KeyError(f"unbound placeholder {name}")
        return self.values[name]


@dataclass(frozen=True)
class QueryBounds:
    """Primary (block) range plus OPTIONAL secondary-index range (the
    reference's QueryBounds, verifiable-db/src/query/utils.rs:131-199:
    min/max secondary from constants or placeholders; defaults = the full
    range, i.e. an unbounded secondary index)."""

    min_block: int
    max_block: int
    min_secondary: int = 0
    max_secondary: int = U256_MAX


# ---------------------------------------------------------------------------
# host evaluation (the universal query gadget's semantics)
# ---------------------------------------------------------------------------


def _as_bool(v: int) -> int:
    return 1 if v != 0 else 0


def eval_operation(
    op: BasicOperation,
    column_values: Sequence[int],
    placeholders: Placeholders,
    previous: Sequence[int],
) -> Tuple[int, bool]:
    """Returns (value, overflow)."""

    def operand(o: Operand) -> int:
        if o.kind == "placeholder":
            return placeholders.get(o.value)
        if o.kind == "constant":
            return o.value % U256_MOD
        if o.kind == "column":
            return column_values[o.value]
        return previous[o.value]

    a = operand(op.first)
    b = operand(op.second) if op.second is not None else 0
    o = op.op
    overflow = False
    if o == Operation.ADD:
        r = a + b
        overflow = r >= U256_MOD
        r %= U256_MOD
    elif o == Operation.SUB:
        r = a - b
        overflow = r < 0
        r %= U256_MOD
    elif o == Operation.MUL:
        r = a * b
        overflow = r >= U256_MOD
        r %= U256_MOD
    elif o == Operation.DIV:
        r = a // b if b else 0
    elif o == Operation.MOD:
        r = a % b if b else 0
    elif o == Operation.EQ:
        r = 1 if a == b else 0
    elif o == Operation.NE:
        r = 1 if a != b else 0
    elif o == Operation.LT:
        r = 1 if a < b else 0
    elif o == Operation.GT:
        r = 1 if a > b else 0
    elif o == Operation.LE:
        r = 1 if a <= b else 0
    elif o == Operation.GE:
        r = 1 if a >= b else 0
    elif o == Operation.AND:
        r = _as_bool(a) & _as_bool(b)
    elif o == Operation.OR:
        r = _as_bool(a) | _as_bool(b)
    elif o == Operation.NOT:
        r = 1 - _as_bool(a)
    elif o == Operation.XOR:
        r = _as_bool(a) ^ _as_bool(b)
    else:  # pragma: no cover
        raise ValueError(o)
    return r, overflow


def eval_operations(
    ops: Sequence[BasicOperation],
    column_values: Sequence[int],
    placeholders: Placeholders,
) -> Tuple[List[int], bool]:
    prev: List[int] = []
    any_overflow = False
    for op in ops:
        v, ov = eval_operation(op, column_values, placeholders, prev)
        prev.append(v)
        any_overflow |= ov
    return prev, any_overflow


def eval_predicate(
    ops: Sequence[BasicOperation],
    column_values: Sequence[int],
    placeholders: Placeholders,
) -> Tuple[bool, bool]:
    """Predicate = boolean value of the LAST operation (empty = true)."""
    if not ops:
        return True, False
    vals, ov = eval_operations(ops, column_values, placeholders)
    return bool(vals[-1]), ov


def eval_result_row(
    rs: ResultStructure,
    column_values: Sequence[int],
    placeholders: Placeholders,
) -> Tuple[List[int], bool]:
    vals, ov = eval_operations(rs.result_operations, column_values, placeholders)
    out = []
    for item in rs.output_items:
        if item.kind == "column":
            out.append(column_values[item.index])
        else:
            out.append(vals[item.index])
    return out, ov


# ---------------------------------------------------------------------------
# computational hash: commits to the query structure
# (role of computational_hash_ids.rs — identifiers hashed in evaluation order)
# ---------------------------------------------------------------------------


def _operand_fields(o: Optional[Operand]) -> List[int]:
    if o is None:
        return [0, 0, 0]
    kind_id = {"placeholder": 1, "constant": 2, "column": 3, "previous": 4}[o.kind]
    if o.kind == "placeholder":
        h = p2h.hash_no_pad([ord(c) for c in o.value])
        return [kind_id, h[0], 0]
    if o.kind == "constant":
        h = p2h.hash_no_pad(u256_to_fields(o.value))
        return [kind_id, h[0], 0]
    return [kind_id, int(o.value), 0]


def computational_hash(
    predicate_ops: Sequence[BasicOperation],
    rs: ResultStructure,
    column_ids: Sequence[int],
    num_predicate_slots: int = None,
    num_result_slots: int = None,
    num_output_slots: int = None,
) -> Tuple[int, int, int, int]:
    """Poseidon commitment to (column ids, predicate structure, result
    structure, aggregations, distinct).

    The slot counts pad the encoding to the universal circuit's fixed
    bounds (inactive slots contribute zeros), so the in-circuit hash over
    MAX slots reproduces this value exactly; without them the encoding is
    exact-length (the per-query compiled path)."""
    pslots = len(predicate_ops) if num_predicate_slots is None else num_predicate_slots
    rslots = (
        len(rs.result_operations) if num_result_slots is None else num_result_slots
    )
    oslots = len(rs.output_items) if num_output_slots is None else num_output_slots
    inputs: List[int] = [len(column_ids)] + list(column_ids)
    for tag, ops, slots in (
        (1, predicate_ops, pslots),
        (2, rs.result_operations, rslots),
    ):
        inputs.append(tag)
        inputs.append(len(ops))
        for op in ops:
            inputs.append(int(op.op))
            inputs.extend(_operand_fields(op.first))
            inputs.extend(_operand_fields(op.second))
        inputs.extend([0] * (7 * (slots - len(ops))))
    inputs.append(3)
    for item, out_id, agg in zip(rs.output_items, rs.output_ids, rs.aggregations):
        inputs.extend(
            [0 if item.kind == "column" else 1, item.index, out_id, int(agg)]
        )
    inputs.extend([0] * (4 * (oslots - len(rs.output_items))))
    inputs.append(4 if rs.distinct else 5)
    return p2h.hash_no_pad(inputs)


# ---------------------------------------------------------------------------
# aggregation across rows
# ---------------------------------------------------------------------------


def aggregate_rows(
    rs: ResultStructure, rows: Sequence[Sequence[int]]
) -> List[int]:
    """Apply the per-output aggregation over the selected rows' outputs."""
    out = []
    for j, agg in enumerate(rs.aggregations):
        col = [r[j] for r in rows]
        if agg == AggregationOperation.SUM:
            out.append(sum(col) % U256_MOD)
        elif agg == AggregationOperation.MIN:
            out.append(min(col) if col else U256_MAX)
        elif agg == AggregationOperation.MAX:
            out.append(max(col) if col else 0)
        elif agg == AggregationOperation.COUNT:
            out.append(len(col))
        elif agg == AggregationOperation.AVG:
            out.append((sum(col) // len(col)) if col else 0)
        else:
            raise ValueError("ID aggregation has no cross-row fold")
    return out
