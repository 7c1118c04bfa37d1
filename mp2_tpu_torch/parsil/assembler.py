"""Compile validated SQL ASTs to universal-circuit inputs.

Role of parsil/src/{validate,assembler}.rs: enforce the supported subset,
then lower the WHERE clause and SELECT items to `BasicOperation` lists with
common-subexpression reuse, extract the primary-index block range into
`QueryBounds`, and emit the `ResultStructure` + placeholder set consumed by
the universal query circuit (assembler.rs:1131-1160).

A jax-free copy of `mp2_tpu/parsil/assembler.py`: only the imports change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from mp2_tpu_torch.parsil import ast
from mp2_tpu_torch.parsil.symbols import ZkTable
from mp2_tpu_torch.vdb.query.ops import (
    AggregationOperation,
    BasicOperation,
    Operand,
    Operation,
    OutputItem,
    Placeholders,
    QueryBounds,
    ResultStructure,
)

_BIN_OPS = {
    "+": Operation.ADD,
    "-": Operation.SUB,
    "*": Operation.MUL,
    "/": Operation.DIV,
    "%": Operation.MOD,
    "=": Operation.EQ,
    "!=": Operation.NE,
    "<": Operation.LT,
    ">": Operation.GT,
    "<=": Operation.LE,
    ">=": Operation.GE,
    "AND": Operation.AND,
    "OR": Operation.OR,
    "XOR": Operation.XOR,
}

_AGG = {
    "SUM": AggregationOperation.SUM,
    "MIN": AggregationOperation.MIN,
    "MAX": AggregationOperation.MAX,
    "AVG": AggregationOperation.AVG,
    "COUNT": AggregationOperation.COUNT,
}

MIN_BLOCK_PLACEHOLDER = "$MIN_BLOCK"
MAX_BLOCK_PLACEHOLDER = "$MAX_BLOCK"

# typed error surface lives in errors.py (round 4); keep the legacy name
from mp2_tpu_torch.parsil.errors import ValidationError  # noqa: E402


@dataclass(frozen=True)
class BoundSpec:
    """Block-range bounds as raw specs (placeholder name or decimal const),
    resolved against the placeholder bindings at proving time."""

    min_spec: str
    max_spec: str

    @staticmethod
    def _resolve_one(spec: str, ph: Placeholders) -> int:
        if spec.startswith("$"):
            return ph.get(spec)
        return int(spec, 0)

    def resolve(self, ph: Placeholders) -> QueryBounds:
        return QueryBounds(
            min_block=self._resolve_one(self.min_spec, ph),
            max_block=self._resolve_one(self.max_spec, ph),
        )


@dataclass
class CircuitPis:
    """The assembled circuit inputs (DynamicCircuitPis equivalent)."""

    predicate_ops: List[BasicOperation]
    result: ResultStructure
    bounds: BoundSpec
    placeholder_names: List[str]
    is_aggregation: bool
    limit: Optional[int]
    offset: Optional[int]
    order_by: Optional[tuple] = None  # (output_index, "ASC"|"DESC")


class _OpBuilder:
    """Lowers expressions to a deduplicated BasicOperation list."""

    def __init__(self, table: ZkTable):
        self.table = table
        self.ops: List[BasicOperation] = []
        self._cache: Dict = {}
        self.placeholders: List[str] = []

    def _push(self, op: BasicOperation) -> Operand:
        key = (op.op, op.first, op.second)
        if key in self._cache:
            return self._cache[key]
        self.ops.append(op)
        res = Operand.previous(len(self.ops) - 1)
        self._cache[key] = res
        return res

    def operand(self, e: ast.Expr) -> Operand:
        if isinstance(e, ast.Const):
            return Operand.constant(e.value)
        if isinstance(e, ast.Placeholder):
            if e.name not in self.placeholders:
                self.placeholders.append(e.name)
            return Operand.placeholder(e.name)
        if isinstance(e, ast.Column):
            return Operand.column(self.table.column_index(e.name))
        if isinstance(e, ast.UnOp):
            assert e.op == "NOT"
            return self._push(
                BasicOperation(Operation.NOT, self.operand(e.operand))
            )
        if isinstance(e, ast.BinOp):
            op = _BIN_OPS.get(e.op)
            if op is None:
                raise ValidationError(f"unsupported operator {e.op!r}")
            return self._push(
                BasicOperation(op, self.operand(e.left), self.operand(e.right))
            )
        raise ValidationError(f"unsupported expression {e!r}")

    def lower_root(self, e: ast.Expr) -> Operand:
        """Lower and force the result to be an operation output (the circuit
        exposes the last predicate operation's value)."""
        res = self.operand(e)
        if res.kind != "previous" or res.value != len(self.ops) - 1:
            # materialize via an identity-ish op: res = res AND res for bools,
            # res + 0 otherwise; use EQ-style materialization: op OR with self
            # would change semantics for non-bools, so use ADD 0.
            res = self._push(BasicOperation(Operation.ADD, res, Operand.constant(0)))
        return res


def _extract_block_range(
    where: Optional[ast.Expr], table: ZkTable
) -> Tuple[Optional[ast.Expr], List[Tuple[str, str]]]:
    """Split top-level AND conjuncts touching the primary index column into
    (residual_predicate, [(op, placeholder_or_const)]).

    Recognized shapes: `block >= X`, `block <= X`, `block = X` with X a
    placeholder or constant (isolator-style rewrite, parsil/src/isolator.rs).
    """
    primary = table.primary_index.name
    bounds: List[Tuple[str, str]] = []

    def is_primary(e) -> bool:
        return isinstance(e, ast.Column) and e.name == primary

    def walk(e: Optional[ast.Expr]) -> Optional[ast.Expr]:
        if e is None:
            return None
        if isinstance(e, ast.BinOp) and e.op == "AND":
            l = walk(e.left)
            r = walk(e.right)
            if l is None:
                return r
            if r is None:
                return l
            return ast.BinOp("AND", l, r)
        if (
            isinstance(e, ast.BinOp)
            and e.op in (">=", "<=", "=", ">", "<")
            and (is_primary(e.left) or is_primary(e.right))
        ):
            if is_primary(e.left):
                op, other = e.op, e.right
            else:
                flip = {">=": "<=", "<=": ">=", ">": "<", "<": ">", "=": "="}
                op, other = flip[e.op], e.left
            if isinstance(other, (ast.Placeholder, ast.Const)):
                val = other.name if isinstance(other, ast.Placeholder) else str(other.value)
                bounds.append((op, val))
                return None
        return e

    residual = walk(where)
    return residual, bounds


def assemble(query: ast.Select, table: ZkTable) -> CircuitPis:
    # ---- validation: no mixing of aggregations and scalar outputs
    aggs = [i for i in query.items if isinstance(i, ast.Aggregation)]
    if aggs and len(aggs) != len(query.items):
        raise ValidationError(
            "SELECT must be all aggregations or all scalar expressions"
        )
    is_aggregation = bool(aggs)
    if query.distinct and is_aggregation:
        raise ValidationError("DISTINCT is only supported for tabular SELECT")
    if query.limit is not None and is_aggregation:
        raise ValidationError("LIMIT applies only to tabular SELECT")

    # ---- block range extraction from WHERE
    residual, range_preds = _extract_block_range(query.where, table)
    min_b, max_b = MIN_BLOCK_PLACEHOLDER, MAX_BLOCK_PLACEHOLDER
    bound_exprs: Dict[str, str] = {}
    for op, val in range_preds:
        if op in (">=", ">"):
            bound_exprs["min"] = val
        elif op in ("<=", "<"):
            bound_exprs["max"] = val
        else:  # "="
            bound_exprs["min"] = bound_exprs["max"] = val

    # ---- lower predicate
    b = _OpBuilder(table)
    if residual is not None:
        b.lower_root(residual)
    predicate_ops = b.ops

    # ---- lower result items
    rb = _OpBuilder(table)
    rb.placeholders = b.placeholders  # shared placeholder registry
    output_items: List[OutputItem] = []
    output_ids: List[int] = []
    aggregations: List[AggregationOperation] = []
    for idx, item in enumerate(query.items):
        if isinstance(item, ast.Aggregation):
            agg = _AGG[item.func]
            expr = item.expr
            if expr is None:  # COUNT(*)
                expr = ast.Const(1)
                agg = AggregationOperation.COUNT
        else:
            agg = AggregationOperation.ID
            expr = item
        if isinstance(expr, ast.Column):
            ci = table.column_index(expr.name)
            output_items.append(OutputItem("column", ci))
            output_ids.append(table.columns[ci].identifier)
        else:
            res = rb.operand(expr)
            if res.kind != "previous":
                res = rb._push(
                    BasicOperation(Operation.ADD, res, Operand.constant(0))
                )
            output_items.append(OutputItem("computed", res.value))
            output_ids.append(idx)
        aggregations.append(agg)

    result = ResultStructure(
        result_operations=rb.ops,
        output_items=output_items,
        output_ids=output_ids,
        aggregations=aggregations,
        distinct=query.distinct,
    )
    bounds = BoundSpec(
        min_spec=bound_exprs.get("min", MIN_BLOCK_PLACEHOLDER),
        max_spec=bound_exprs.get("max", MAX_BLOCK_PLACEHOLDER),
    )
    order_by = None
    if query.order_by is not None:
        if is_aggregation:
            raise ValidationError("ORDER BY applies only to tabular SELECT")
        ob_expr, direction = query.order_by
        # ORDER BY must reference a selected output item
        for j, item in enumerate(query.items):
            if item == ob_expr:
                order_by = (j, direction)
                break
        else:
            raise ValidationError("ORDER BY must match a selected expression")
    names = list(dict.fromkeys(rb.placeholders))
    return CircuitPis(
        predicate_ops=predicate_ops,
        result=result,
        bounds=bounds,
        placeholder_names=names,
        is_aggregation=is_aggregation,
        limit=query.limit,
        offset=query.offset,
        order_by=order_by,
    )


def parse_and_assemble(sql: str, table: ZkTable) -> CircuitPis:
    """Legacy permissive entry (parse -> desugar -> assemble, inline
    LIMIT/OFFSET allowed, no resource accounting).  New code should use
    parsil.validate.parse_and_validate with ParsilSettings."""
    from mp2_tpu_torch.parsil.expand import expand

    return assemble(expand(ast.parse(sql), table), table)
