"""Isolator pass: rewrite a query's WHERE clause to ONLY the known index
bounds (role of parsil/src/isolator.rs as a standalone pass, previously
folded into the assembler's block-range extraction).

Given a validated query and optional secondary-index bounds, emit the SQL
used to locate boundary rows:

    SELECT * FROM t WHERE t.block >= $MIN_BLOCK AND t.block <= $MAX_BLOCK
        [AND t.<sec> >= lo] [AND t.<sec> <= hi] LIMIT <MAX_NUM_OUTPUTS>

Every predicate irrelevant to the index bounds is pruned (isolator.rs:
"prune all the sub-expressions irrelevant to evaluation of the known
index bounds"); secondary-index references from the ORIGINAL query are
dropped — only the caller-provided bounds (which come from the proven
QueryBounds) appear.  Mirrors the reference's golden `isolation` corpus
(parsil/src/tests.rs:212-303).

A jax-free copy of `mp2_tpu/parsil/isolator.py`: only the imports change.
"""

from __future__ import annotations

from typing import Optional

from mp2_tpu_torch.parsil import ast
from mp2_tpu_torch.parsil.symbols import ParsilSettings, ZkTable


def isolate_with(
    query: ast.Select,
    table: ZkTable,
    lo_sec: Optional[int] = None,
    hi_sec: Optional[int] = None,
    max_num_outputs: int = 5,
) -> str:
    """Isolated boundary-row SQL for `query` over `table`.

    The primary-index bound predicates are re-emitted table-qualified in
    canonical >= / <= form; the secondary index appears only with the
    explicit `lo_sec` / `hi_sec` bounds; everything else in WHERE is
    pruned.  LIMIT caps the fetch at the circuit's output bound
    (tests.rs isolation: `LIMIT {MAX_NUM_OUTPUTS}`)."""
    t = query.table
    primary = table.primary_index.name
    sec = table.secondary_index

    parts = [
        f"{t}.{primary} >= $MIN_BLOCK",
        f"{t}.{primary} <= $MAX_BLOCK",
    ]
    if sec is not None:
        if lo_sec is not None:
            parts.append(f"{t}.{sec.name} >= {int(lo_sec)}")
        if hi_sec is not None:
            parts.append(f"{t}.{sec.name} <= {int(hi_sec)}")
    where = " AND ".join(parts)
    return f"SELECT * FROM {t} WHERE {where} LIMIT {max_num_outputs}"


def isolate(
    sql: str,
    settings: ParsilSettings,
    lo_sec: Optional[int] = None,
    hi_sec: Optional[int] = None,
) -> str:
    """Parse+validate `sql` under `settings`, then isolate (the
    reference's isolator::isolate_with entry)."""
    from mp2_tpu_torch.parsil.validate import parse_and_validate  # noqa: F401
    from mp2_tpu_torch.parsil.expand import expand

    query = ast.parse(sql)
    table = settings.context.table(query.table)
    expanded = expand(query, table)
    return isolate_with(
        expanded, table, lo_sec, hi_sec,
        max_num_outputs=settings.context.max_num_outputs,
    )
