"""AST desugaring (role of parsil/src/expand.rs): rewrite accepted sugar
into the core expression forms the assembler lowers.

  * `e BETWEEN lo AND hi`  -> `e >= lo AND e <= hi` (negated: NOT(...))
  * `e IN (a, b, ...)`     -> `e = a OR e = b OR ...`
  * `e IS [NOT] TRUE/FALSE`-> equality against 1/0 (NULL forms are left
    for validate to reject)
  * string literals        -> Const via str_to_u256 (utils.rs:217) or
    InvalidInteger
  * unary `+`              -> dropped
  * `SELECT *`             -> one Column item per schema column
  * table/column aliases   -> rewritten to the underlying schema names

Resolution of aliases needs the table schema, so expand takes the resolved
ZkTable (validate fetched it from the ContextProvider).

A jax-free copy of `mp2_tpu/parsil/expand.py`: only the imports change."""

from __future__ import annotations

from typing import List, Optional, Union

from mp2_tpu_torch.parsil import ast
from mp2_tpu_torch.parsil import errors as E
from mp2_tpu_torch.parsil.symbols import ZkTable

U256_LIMIT = 1 << 256


def str_to_u256(s: str) -> int:
    """Radix-prefixed or decimal string to U256 (parsil/src/utils.rs:217
    via alloy U256::from_str): 0x hex, 0b binary, 0o octal, else decimal;
    must fit 256 bits."""
    t = s.strip().lower()
    try:
        if t.startswith("0x"):
            v = int(t[2:], 16) if t[2:] else 0
        elif t.startswith("0b"):
            v = int(t[2:], 2) if t[2:] else 0
        elif t.startswith("0o"):
            v = int(t[2:], 8) if t[2:] else 0
        elif t and t.isdigit():
            v = int(t)
        else:
            raise ValueError(t)
    except ValueError:
        raise E.InvalidInteger(s) from None
    if v >= U256_LIMIT:
        raise E.InvalidInteger(s)
    return v


class _Aliases:
    def __init__(self, query: ast.Select, table: ZkTable):
        self.table_names = {query.table}
        if query.table_alias:
            self.table_names.add(query.table_alias)
        self.colmap = {}
        if query.column_aliases:
            if len(query.column_aliases) > len(table.columns):
                raise E.UnknownColumn(
                    query.column_aliases[len(table.columns)], query.table
                )
            for alias, col in zip(query.column_aliases, table.columns):
                self.colmap[alias] = col.name

    def column(self, c: ast.Column) -> ast.Column:
        if c.table is not None and c.table not in self.table_names:
            raise E.UnknownTable(c.table)
        name = self.colmap.get(c.name, c.name)
        return ast.Column(name)


def _expand_expr(e, al: _Aliases):
    if e is None or isinstance(e, (ast.Const, ast.Placeholder, ast.NullLit)):
        return e
    if isinstance(e, ast.Column):
        return al.column(e)
    if isinstance(e, ast.StringLit):
        return ast.Const(str_to_u256(e.text))
    if isinstance(e, ast.UnOp):
        inner = _expand_expr(e.operand, al)
        if e.op == "+":
            return inner
        return ast.UnOp(e.op, inner)
    if isinstance(e, ast.BinOp):
        return ast.BinOp(e.op, _expand_expr(e.left, al),
                         _expand_expr(e.right, al))
    if isinstance(e, ast.Between):
        x = _expand_expr(e.expr, al)
        lo = _expand_expr(e.lo, al)
        hi = _expand_expr(e.hi, al)
        core = ast.BinOp("AND", ast.BinOp(">=", x, lo),
                         ast.BinOp("<=", x, hi))
        return ast.UnOp("NOT", core) if e.negated else core
    if isinstance(e, ast.InList):
        x = _expand_expr(e.expr, al)
        core = None
        for item in e.items:
            eq = ast.BinOp("=", x, _expand_expr(item, al))
            core = eq if core is None else ast.BinOp("OR", core, eq)
        if core is None:
            core = ast.Const(0)
        return ast.UnOp("NOT", core) if e.negated else core
    if isinstance(e, ast.Is):
        if e.what in ("TRUE", "FALSE"):
            x = _expand_expr(e.expr, al)
            want = ast.Const(1 if e.what == "TRUE" else 0)
            core = ast.BinOp("=", x, want)
            return ast.UnOp("NOT", core) if e.negated else core
        return e  # NULL/UNKNOWN: validate rejects
    if isinstance(e, ast.Like):
        return ast.Like(_expand_expr(e.expr, al),
                        _expand_expr(e.pattern, al), e.ilike, e.negated)
    return e


def expand(query: ast.Select, table: ZkTable) -> ast.Select:
    """Desugared copy of `query` with aliases resolved against `table`."""
    al = _Aliases(query, table)
    items: List[Union[ast.Aggregation, ast.Expr]] = []
    for item in query.items:
        if isinstance(item, ast.Wildcard):
            items.extend(ast.Column(c.name) for c in table.columns)
        elif isinstance(item, ast.Aggregation):
            items.append(
                ast.Aggregation(item.func, _expand_expr(item.expr, al))
            )
        else:
            items.append(_expand_expr(item, al))
    order_items = [
        ast.OrderByItem(_expand_expr(o.expr, al), o.direction, o.nulls_first)
        for o in query.order_by_items
    ]
    legacy_ob = None
    if order_items:
        legacy_ob = (order_items[0].expr, order_items[0].direction)
    return ast.Select(
        items=items, table=query.table,
        where=_expand_expr(query.where, al), distinct=query.distinct,
        limit=query.limit, offset=query.offset, order_by=legacy_ob,
        order_by_items=order_items, table_alias=query.table_alias,
        column_aliases=[],
    )
