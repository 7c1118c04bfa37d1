"""SQL tokenizer + parser for the supported ZK-SQL subset.

Hand-rolled (no sqlparser/sqlglot in this environment); grammar follows the
reference's supported subset (the reference's README.md:53-61 and
parsil/src/validate.rs): a single SELECT over one table, either all
aggregations or all scalar expressions (no mixing), U256 arithmetic and
comparison/boolean operators, numbered placeholders plus $MIN_BLOCK /
$MAX_BLOCK, optional LIMIT/OFFSET, optional DISTINCT, BETWEEN / IN-list /
IS TRUE/FALSE sugar, table + column aliasing (`t AS tt (a, b, c)`), and
`SELECT *` wildcards.

The parser is deliberately more liberal than the circuit subset: it
RECOGNIZES constructs the subset excludes (LIKE, JSON accessors, bitwise
operators, unary minus, IS NULL, string literals, multi-criteria ORDER BY
with NULLS specifiers) and represents them in the AST, so the validation
pass (validate.py, mirroring parsil/src/validate.rs) can reject each with
its precise typed error.  Constructs that cannot be represented at all
(mutating statements, CTEs, set operations, joins, nested selects) raise
their typed error directly from the parser — same observable contract as
the reference's parse-then-validate split over a generic SQL parser.

A jax-free copy of `mp2_tpu/parsil/ast.py`: only the imports change.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from mp2_tpu_torch.parsil import errors as E

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "AND", "OR", "NOT", "XOR", "LIMIT", "OFFSET",
    "SUM", "AVG", "MIN", "MAX", "COUNT", "DISTINCT", "AS", "ORDER", "BY",
    "ASC", "DESC", "BETWEEN", "IN", "IS", "NULL", "TRUE", "FALSE", "LIKE",
    "ILIKE", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "OUTER",
    "ON", "GROUP", "HAVING", "UNION", "INTERSECT", "EXCEPT", "INSERT",
    "UPDATE", "DELETE", "CREATE", "DROP", "ALTER", "TABLE", "INTO",
    "VALUES", "WITH", "NULLS", "FIRST", "LAST", "FETCH", "TOP", "ALL",
    "ANY", "SOME", "EXISTS", "CASE", "UNKNOWN", "CAST",
}

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+|0x[0-9a-fA-F]+)"
    r"|(?P<str>'[^']*')"
    r"|(?P<ph>\$[A-Za-z_0-9]+)"
    r"|(?P<id>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><=|>=|!=|<>|->>|->|=|<|>|\+|-|\*|/|%|\(|\)|,|;|\.|&|\||\^|::))"
)


@dataclass(frozen=True)
class Token:
    kind: str  # num | str | ph | id | kw | op
    text: str


def tokenize(sql: str) -> List[Token]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            rest = sql[pos:].strip()
            if not rest:
                break
            raise SyntaxError(f"cannot tokenize near: {rest[:30]!r}")
        pos = m.end()
        if m.group("num"):
            out.append(Token("num", m.group("num")))
        elif m.group("str"):
            out.append(Token("str", m.group("str")[1:-1]))
        elif m.group("ph"):
            out.append(Token("ph", m.group("ph")))
        elif m.group("id"):
            t = m.group("id")
            if t.upper() in KEYWORDS:
                out.append(Token("kw", t.upper()))
            else:
                out.append(Token("id", t))
        else:
            out.append(Token("op", m.group("op")))
    return out


# --- AST --------------------------------------------------------------------


@dataclass(frozen=True)
class Column:
    name: str
    table: Optional[str] = None  # qualifier: `t.col`


@dataclass(frozen=True)
class Const:
    value: int


@dataclass(frozen=True)
class StringLit:
    """A quoted literal; expand converts it via str_to_u256 (utils.rs:217)
    or rejects with InvalidInteger."""

    text: str


@dataclass(frozen=True)
class NullLit:
    pass


@dataclass(frozen=True)
class Placeholder:
    name: str  # "$1", "$MIN_BLOCK", ...


@dataclass(frozen=True)
class BinOp:
    op: str  # + - * / % = != < <= > >= AND OR XOR  (also & | ^ -> ->> ::,
    #          which validate rejects as UnsupportedBinaryOperator)
    left: "Expr"
    right: "Expr"


@dataclass(frozen=True)
class UnOp:
    op: str  # NOT (also unary "-", rejected by validate)
    operand: "Expr"


@dataclass(frozen=True)
class Between:
    """`e [NOT] BETWEEN lo AND hi` — desugared by expand (expand.rs role)."""

    expr: "Expr"
    lo: "Expr"
    hi: "Expr"
    negated: bool = False


@dataclass(frozen=True)
class InList:
    """`e [NOT] IN (a, b, ...)` — desugared to an OR chain by expand."""

    expr: "Expr"
    items: Tuple["Expr", ...] = ()
    negated: bool = False


@dataclass(frozen=True)
class Is:
    """`e IS [NOT] TRUE/FALSE/NULL/UNKNOWN`; TRUE/FALSE desugars, the
    NULL-related forms are rejected by validate (validate.rs:153-156)."""

    expr: "Expr"
    what: str  # TRUE | FALSE | NULL | UNKNOWN
    negated: bool = False


@dataclass(frozen=True)
class Like:
    """`e [NOT] [I]LIKE pattern` — always rejected (validate.rs:172-173)."""

    expr: "Expr"
    pattern: "Expr"
    ilike: bool = False
    negated: bool = False


@dataclass(frozen=True)
class Wildcard:
    """`*` in the projection; expand replaces it with the table columns."""


Expr = Union[
    Column, Const, StringLit, NullLit, Placeholder, BinOp, UnOp,
    Between, InList, Is, Like,
]


@dataclass(frozen=True)
class Aggregation:
    func: str  # SUM AVG MIN MAX COUNT
    expr: Optional[Expr]  # None for COUNT(*)


@dataclass(frozen=True)
class OrderByItem:
    expr: Expr
    direction: str = "ASC"
    nulls_first: Optional[bool] = None  # NULLS FIRST/LAST — rejected


@dataclass
class Select:
    items: List[Union[Aggregation, Expr, Wildcard]]
    table: str
    where: Optional[Expr]
    distinct: bool = False
    limit: Optional[int] = None
    offset: Optional[int] = None
    order_by: Optional[Tuple[Expr, str]] = None  # legacy single-criterion
    order_by_items: List[OrderByItem] = field(default_factory=list)
    table_alias: Optional[str] = None
    column_aliases: List[str] = field(default_factory=list)  # positional


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.pos = 0

    def peek(self, ahead: int = 0) -> Optional[Token]:
        i = self.pos + ahead
        return self.toks[i] if i < len(self.toks) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise SyntaxError("unexpected end of query")
        self.pos += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise SyntaxError(f"expected {text or kind}, got {t.text!r}")
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t and t.kind == kind and (text is None or t.text == text):
            self.pos += 1
            return t
        return None

    # -- grammar -------------------------------------------------------------
    def parse(self) -> Select:
        t = self.peek()
        if t is None:
            raise SyntaxError("empty query")
        if t.kind == "kw":
            if t.text in ("INSERT", "UPDATE", "DELETE", "CREATE", "DROP",
                          "ALTER", "VALUES", "TABLE"):
                raise E.MutableQueries(t.text)
            if t.text == "WITH":
                raise E.UnsupportedFeature("CTEs")
            if t.text != "SELECT":
                raise E.NotASelect(t.text)
        else:
            raise E.NotASelect(t.text)
        sel = self.select_body()
        t = self.peek()
        if t and t.kind == "kw" and t.text in ("UNION", "INTERSECT", "EXCEPT"):
            raise E.SetOperation(t.text)
        if self.peek() is not None:
            raise SyntaxError(f"trailing tokens at {self.peek().text!r}")
        return sel

    def select_body(self) -> Select:
        self.expect("kw", "SELECT")
        if self.accept("kw", "TOP"):
            raise E.NonStandardSql("TOP")
        distinct = bool(self.accept("kw", "DISTINCT"))
        if distinct and self.accept("kw", "ON"):
            raise E.UnsupportedFeature("DISTINCT ON")
        self.accept("kw", "ALL")
        items = [self.select_item()]
        while self.accept("op", ","):
            items.append(self.select_item())
        if self.accept("kw", "INTO"):
            raise E.UnsupportedFeature("SELECT ... INTO not supported")
        self.expect("kw", "FROM")
        table, alias, col_aliases = self.table_factor()
        where = None
        if self.accept("kw", "WHERE"):
            where = self.expr()
        if self.accept("kw", "GROUP"):
            raise E.UnsupportedFeature("GROUP BY")
        if self.accept("kw", "HAVING"):
            raise E.UnsupportedFeature("HAVING")
        order_items: List[OrderByItem] = []
        if self.accept("kw", "ORDER"):
            self.expect("kw", "BY")
            order_items.append(self.order_by_item())
            while self.accept("op", ","):
                order_items.append(self.order_by_item())
        limit = offset = None
        if self.accept("kw", "LIMIT"):
            t = self.peek()
            if t is None or t.kind != "num":
                raise E.NonStandardSql(f"LIMIT {t.text if t else ''}")
            limit = int(self.next().text, 0)
        if self.accept("kw", "OFFSET"):
            t = self.peek()
            if t is None or t.kind != "num":
                raise E.NonStandardSql(f"OFFSET {t.text if t else ''}")
            offset = int(self.next().text, 0)
        if self.accept("kw", "FETCH"):
            raise E.NonStandardSql("FETCH")
        self.accept("op", ";")
        legacy_ob = None
        if order_items:
            legacy_ob = (order_items[0].expr, order_items[0].direction)
        return Select(
            items=items, table=table, where=where, distinct=distinct,
            limit=limit, offset=offset, order_by=legacy_ob,
            order_by_items=order_items, table_alias=alias,
            column_aliases=col_aliases,
        )

    def table_factor(self):
        t = self.peek()
        if t and t.kind == "op" and t.text == "(":
            # derived table `FROM (SELECT ...)` (validate.rs:236-239)
            raise E.NestedSelect("derived table")
        name = self.expect("id").text
        if self.accept("op", "."):
            other = self.expect("id").text
            raise E.CompoundTableName(f"{name}.{other}")
        alias = None
        col_aliases: List[str] = []
        if self.accept("kw", "AS"):
            alias = self.expect("id").text
        else:
            t = self.peek()
            if t and t.kind == "id":
                alias = self.next().text
        if alias and self.accept("op", "("):
            col_aliases.append(self.expect("id").text)
            while self.accept("op", ","):
                col_aliases.append(self.expect("id").text)
            self.expect("op", ")")
        t = self.peek()
        if t and t.kind == "kw":
            if t.text in ("JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS",
                          "OUTER"):
                raise E.UnsupportedJointure(t.text)
        return name, alias, col_aliases

    def order_by_item(self) -> OrderByItem:
        e = self.expr()
        direction = "ASC"
        if self.accept("kw", "ASC"):
            pass
        elif self.accept("kw", "DESC"):
            direction = "DESC"
        nulls = None
        if self.accept("kw", "NULLS"):
            if self.accept("kw", "FIRST"):
                nulls = True
            else:
                self.expect("kw", "LAST")
                nulls = False
        return OrderByItem(e, direction, nulls)

    def select_item(self):
        t = self.peek()
        if t and t.kind == "op" and t.text == "*":
            self.next()
            return Wildcard()
        if t and t.kind == "kw" and t.text in ("SUM", "AVG", "MIN", "MAX",
                                               "COUNT"):
            func = self.next().text
            self.expect("op", "(")
            if func == "COUNT" and self.accept("op", "*"):
                self.expect("op", ")")
                item = Aggregation(func, None)
            else:
                inner = self.expr()
                if self.accept("op", ","):
                    # count args for the typed arity error
                    extra = 1
                    self.expr()
                    while self.accept("op", ","):
                        extra += 1
                        self.expr()
                    self.expect("op", ")")
                    raise E.InvalidArity(func, 1, 1 + extra)
                self.expect("op", ")")
                item = Aggregation(func, inner)
            if self.accept("kw", "AS"):
                self.expect("id")
            return item
        if t and t.kind == "id" and self.peek(1) is not None \
                and self.peek(1).kind == "op" and self.peek(1).text == "(":
            raise E.UnknownFunction(t.text)
        e = self.expr()
        if self.accept("kw", "AS"):
            self.expect("id")
        return e

    def expr(self) -> Expr:
        return self.or_expr()

    def or_expr(self) -> Expr:
        left = self.xor_expr()
        while self.accept("kw", "OR"):
            left = BinOp("OR", left, self.xor_expr())
        return left

    def xor_expr(self) -> Expr:
        left = self.and_expr()
        while self.accept("kw", "XOR"):
            left = BinOp("XOR", left, self.and_expr())
        return left

    def and_expr(self) -> Expr:
        left = self.not_expr()
        while self.accept("kw", "AND"):
            left = BinOp("AND", left, self.not_expr())
        return left

    def not_expr(self) -> Expr:
        if self.accept("kw", "NOT"):
            return UnOp("NOT", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self) -> Expr:
        left = self.add_expr()
        negated = False
        t = self.peek()
        if t and t.kind == "kw" and t.text == "NOT":
            nt = self.peek(1)
            if nt and nt.kind == "kw" and nt.text in ("BETWEEN", "IN", "LIKE",
                                                      "ILIKE"):
                self.next()
                negated = True
                t = self.peek()
        if t and t.kind == "kw":
            if t.text == "BETWEEN":
                self.next()
                lo = self.add_expr()
                self.expect("kw", "AND")
                hi = self.add_expr()
                return Between(left, lo, hi, negated)
            if t.text == "IN":
                self.next()
                self.expect("op", "(")
                tt = self.peek()
                if tt and tt.kind == "kw" and tt.text == "SELECT":
                    raise E.NestedSelect("IN (SELECT ...)")
                items = [self.expr()]
                while self.accept("op", ","):
                    items.append(self.expr())
                self.expect("op", ")")
                return InList(left, tuple(items), negated)
            if t.text in ("LIKE", "ILIKE"):
                ilike = t.text == "ILIKE"
                self.next()
                pat = self.add_expr()
                return Like(left, pat, ilike, negated)
            if t.text == "IS":
                self.next()
                neg = bool(self.accept("kw", "NOT"))
                for what in ("TRUE", "FALSE", "NULL", "UNKNOWN"):
                    if self.accept("kw", what):
                        return Is(left, what, neg)
                raise SyntaxError("IS must be followed by TRUE/FALSE/NULL")
        if t and t.kind == "op" and t.text in ("=", "!=", "<>", "<", "<=",
                                               ">", ">="):
            op = self.next().text
            if op == "<>":
                op = "!="
            nt = self.peek()
            if nt and nt.kind == "kw" and nt.text in ("ALL", "ANY", "SOME"):
                # `a = ALL (SELECT ...)` — validate.rs:148-150 territory
                raise E.UnsupportedFeature(nt.text)
            return BinOp(op, left, self.add_expr())
        return left

    def add_expr(self) -> Expr:
        left = self.mul_expr()
        while True:
            t = self.peek()
            if t and t.kind == "op" and t.text in ("+", "-", "&", "|", "^"):
                left = BinOp(self.next().text, left, self.mul_expr())
            else:
                return left

    def mul_expr(self) -> Expr:
        left = self.json_expr()
        while True:
            t = self.peek()
            if t and t.kind == "op" and t.text in ("*", "/", "%"):
                left = BinOp(self.next().text, left, self.json_expr())
            else:
                return left

    def json_expr(self) -> Expr:
        left = self.atom()
        while True:
            t = self.peek()
            if t and t.kind == "op" and t.text in ("->", "->>", "::"):
                left = BinOp(self.next().text, left, self.atom())
            else:
                return left

    def atom(self) -> Expr:
        t = self.next()
        if t.kind == "num":
            return Const(int(t.text, 0))
        if t.kind == "str":
            return StringLit(t.text)
        if t.kind == "ph":
            return Placeholder(t.text)
        if t.kind == "id":
            if self.accept("op", "."):
                col = self.expect("id").text
                return Column(col, table=t.text)
            return Column(t.text)
        if t.kind == "kw":
            if t.text == "TRUE":
                return Const(1)
            if t.text == "FALSE":
                return Const(0)
            if t.text == "NULL":
                return NullLit()
            if t.text in ("EXISTS", "CASE", "CAST"):
                raise E.UnsupportedFeature(t.text)
            if t.text == "SELECT":
                raise E.NestedSelect("SELECT")
        if t.kind == "op" and t.text == "(":
            nt = self.peek()
            if nt and nt.kind == "kw" and nt.text == "SELECT":
                raise E.NestedSelect("(SELECT ...)")
            e = self.expr()
            self.expect("op", ")")
            return e
        if t.kind == "op" and t.text in ("-", "+"):
            return UnOp(t.text, self.atom())
        raise SyntaxError(f"unexpected token {t.text!r}")


def parse(sql: str) -> Select:
    return Parser(tokenize(sql)).parse()
