"""Subset validation over the parsed AST (role of parsil/src/validate.rs +
placeholders.rs): every construct outside the provable subset is rejected
with its typed error from errors.py.

Entry point `parse_and_validate(sql, settings)` mirrors
utils.rs:202-213: parse -> validate -> expand (desugar + aliases) ->
resource-checked assembly; returns the assembled CircuitPis.

A jax-free copy of `mp2_tpu/parsil/validate.py`: only the imports change.
"""

from __future__ import annotations

from typing import List, Optional, Union

from mp2_tpu_torch.parsil import ast
from mp2_tpu_torch.parsil import errors as E
from mp2_tpu_torch.parsil.symbols import ParsilSettings, ZkTable

_ALLOWED_BINOPS = {
    "=", "!=", "+", "-", "*", "/", "%", ">", "<", ">=", "<=",
    "AND", "OR", "XOR",
}
_ALLOWED_UNOPS = {"NOT", "+"}
_MAX_ORDER_BY = 2


def _walk_expr(e, settings: ParsilSettings, table: Optional[ZkTable]):
    """Pre-order rejection walk (SqlValidator::pre_expr and friends)."""
    if e is None or isinstance(e, (ast.Const, ast.Wildcard)):
        return
    if isinstance(e, ast.NullLit):
        raise E.UnsupportedImmediateValue("NULL")
    if isinstance(e, ast.StringLit):
        from mp2_tpu_torch.parsil.expand import str_to_u256

        str_to_u256(e.text)  # InvalidInteger on failure
        return
    if isinstance(e, ast.Placeholder):
        settings.placeholders.validate_name(e.name)
        return
    if isinstance(e, ast.Column):
        if e.name.startswith("__") or (e.table or "").startswith("__"):
            raise E.ReservedIdentifier(e.name)
        return
    if isinstance(e, ast.UnOp):
        if e.op not in _ALLOWED_UNOPS:
            raise E.UnsupportedUnaryOperator(e.op)
        _walk_expr(e.operand, settings, table)
        return
    if isinstance(e, ast.BinOp):
        if e.op not in _ALLOWED_BINOPS:
            raise E.UnsupportedBinaryOperator(e.op)
        _walk_expr(e.left, settings, table)
        _walk_expr(e.right, settings, table)
        return
    if isinstance(e, ast.Between):
        for sub in (e.expr, e.lo, e.hi):
            _walk_expr(sub, settings, table)
        return
    if isinstance(e, ast.InList):
        _walk_expr(e.expr, settings, table)
        for sub in e.items:
            _walk_expr(sub, settings, table)
        return
    if isinstance(e, ast.Is):
        if e.what in ("NULL", "UNKNOWN"):
            raise E.UnsupportedFeature(f"IS {e.what}")
        _walk_expr(e.expr, settings, table)
        return
    if isinstance(e, ast.Like):
        raise E.UnsupportedFeature("ILIKE" if e.ilike else "LIKE")
    raise E.UnsupportedFeature(repr(e))


def validate(query: ast.Select, settings: ParsilSettings) -> None:
    """AST-level subset checks (validate.rs::validate): projection purity,
    operator allow-list, placeholder policy, ORDER BY rules,
    LIMIT/OFFSET policy.  Raises a typed ValidationError."""
    aggs = [i for i in query.items if isinstance(i, ast.Aggregation)]
    scalars = [
        i for i in query.items
        if not isinstance(i, (ast.Aggregation, ast.Wildcard))
    ]
    if aggs and scalars:
        raise E.MixedQuery()

    for item in query.items:
        if isinstance(item, ast.Aggregation):
            _walk_expr(item.expr, settings, None)
        else:
            _walk_expr(item, settings, None)
    _walk_expr(query.where, settings, None)

    if len(query.order_by_items) > _MAX_ORDER_BY:
        raise E.OrderByArity(
            ", ".join(str(o.expr) for o in query.order_by_items),
            _MAX_ORDER_BY,
        )
    for o in query.order_by_items:
        if o.nulls_first is not None:
            raise E.NullRelatedOrdering()
        _walk_expr(o.expr, settings, None)
        if aggs:
            raise E.UnsupportedFeature("ORDER BY on aggregation queries")
        if not any(o.expr == it for it in query.items):
            raise E.SpecialOrderBy(str(o.expr))

    if not settings.allow_inline_limit:
        if query.limit is not None:
            raise E.UseInvocationParameter("LIMIT")
        if query.offset is not None:
            raise E.UseInvocationParameter("OFFSET")

    if query.distinct and aggs:
        raise E.UnsupportedFeature("DISTINCT on aggregation queries")


def _check_secure_bounds(query: ast.Select, table: ZkTable) -> None:
    """The primary index must be pinned to [$MIN_BLOCK, $MAX_BLOCK] by
    top-level AND conjuncts (>=/<= or the BETWEEN desugaring) — the
    reference's prim_index_bounds golden semantics (parsil/src/tests.rs:
    37-85; enforced by assembler.rs).  Constants or free placeholders do
    NOT count, nor do bounds under OR/NOT, nor strict inequalities."""
    primary = table.primary_index.name
    found = {"min": False, "max": False}

    def conjuncts(e):
        if isinstance(e, ast.BinOp) and e.op == "AND":
            yield from conjuncts(e.left)
            yield from conjuncts(e.right)
        else:
            yield e

    if query.where is not None:
        for c in conjuncts(query.where):
            if not isinstance(c, ast.BinOp):
                continue
            l, op, r = c.left, c.op, c.right
            if isinstance(r, ast.Column) and r.name == primary:
                flip = {">=": "<=", "<=": ">=", ">": "<", "<": ">", "=": "="}
                l, op, r = r, flip.get(op, op), l
            if not (isinstance(l, ast.Column) and l.name == primary):
                continue
            if isinstance(r, ast.Placeholder):
                if op == ">=" and r.name == "$MIN_BLOCK":
                    found["min"] = True
                elif op == "<=" and r.name == "$MAX_BLOCK":
                    found["max"] = True
    if not (found["min"] and found["max"]):
        raise E.MissingSecureBounds("$MIN_BLOCK / $MAX_BLOCK")


def parse_and_validate(sql: str, settings: ParsilSettings):
    """parse -> validate -> expand -> resource-checked assemble
    (utils.rs:202-213).  Returns the assembled CircuitPis."""
    from mp2_tpu_torch.parsil import assembler as asm
    from mp2_tpu_torch.parsil.expand import expand

    query = ast.parse(sql)
    table = settings.context.table(query.table)
    if len(table.columns) > settings.context.max_num_columns:
        raise E.TooManyOutputs(
            len(table.columns), settings.context.max_num_columns
        )
    validate(query, settings)
    expanded = expand(query, table)
    # re-validate post-expansion (wildcards became columns; strings
    # became consts; aliases resolved — column existence checks now bind)
    for item in expanded.items:
        _check_columns(item, table)
    _check_columns(expanded.where, table)
    _check_secure_bounds(expanded, table)
    ctx = settings.context
    if len(expanded.items) > ctx.max_num_items_per_output:
        raise E.TooManyOutputs(
            len(expanded.items), ctx.max_num_items_per_output
        )
    pis = asm.assemble(expanded, table)
    if len(pis.predicate_ops) > ctx.max_num_predicate_ops:
        raise E.TooManyPredicateOps(
            len(pis.predicate_ops), ctx.max_num_predicate_ops
        )
    if len(pis.result.result_operations) > ctx.max_num_result_ops:
        raise E.TooManyResultOps(
            len(pis.result.result_operations), ctx.max_num_result_ops
        )
    if settings.limit is not None and pis.limit is None:
        pis.limit = settings.limit
    if settings.offset is not None and pis.offset is None:
        pis.offset = settings.offset
    return pis


def _check_columns(e, table: ZkTable) -> None:
    if e is None or isinstance(
        e, (ast.Const, ast.Placeholder, ast.Aggregation)
    ):
        if isinstance(e, ast.Aggregation) and e.expr is not None:
            _check_columns(e.expr, table)
        return
    if isinstance(e, ast.Column):
        table.column_index(e.name)  # UnknownColumn if absent
        return
    if isinstance(e, ast.UnOp):
        _check_columns(e.operand, table)
        return
    if isinstance(e, ast.BinOp):
        _check_columns(e.left, table)
        _check_columns(e.right, table)
        return
