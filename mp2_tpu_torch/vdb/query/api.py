"""Query execution over the verifiable DB (host golden pipeline).

Role of the reference's query side (SURVEY.md §3.4): resolve the block range,
enumerate matching rows epoch-by-epoch, evaluate the universal-circuit
predicate/result semantics per row, aggregate, and emit a `QueryResult`
carrying the commitments the revelation layer binds to (computational hash,
placeholder hash, result values).

The proving path (row-chunk circuits, chunk aggregation, revelation) consumes
exactly these values; the planner here also produces the row-chunk workplan
(rows -> chunks -> aggregation tree) mirroring batching_planner.rs.

A jax-free copy of `mp2_tpu/vdb/query/api.py`: only the imports change.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.parsil.assembler import CircuitPis
from mp2_tpu_torch.utils.u256 import U256_MAX
from mp2_tpu_torch.parsil.symbols import ZkTable
from mp2_tpu_torch.vdb.query import ops as O
from mp2_tpu_torch.vdb.query.ops import (
    AggregationOperation,
    Placeholders,
    aggregate_rows,
    computational_hash,
    eval_predicate,
    eval_result_row,
)

NUM_ROWS_PER_CHUNK = 3  # reference NUM_ROWS (tests/common/cases/query/mod.rs:39-48)
NUM_CHUNKS_PER_AGG = 5  # reference NUM_CHUNKS


@dataclass
class TableData:
    """Materialized rows per block: row = column values in schema order."""

    schema: ZkTable
    rows_by_block: Dict[int, List[List[int]]] = field(default_factory=dict)

    def add_row(self, block: int, values: Sequence[int]):
        assert len(values) == len(self.schema.columns)
        self.rows_by_block.setdefault(block, []).append(list(values))


@dataclass
class QueryResult:
    rows: List[List[int]]  # result rows (single row for aggregations)
    num_matching_rows: int
    overflow: bool
    computational_hash: Tuple[int, int, int, int]
    placeholder_hash: Tuple[int, int, int, int]
    chunks: List[List[Tuple[int, int]]]  # proving plan: [(block, row_idx)]


def placeholder_hash(
    names: Sequence[str], ph: Placeholders, bounds, num_slots: int = None
) -> Tuple[int, int, int, int]:
    """Commitment to the placeholder values (revelation/placeholders_check.rs
    equivalent): H(min_p || max_p || min_s || max_s || (name_hash,
    value-limbs)*) — ALL FOUR query bounds are committed, so the verifier
    derives the secondary range the circuits enforced (the reference routes
    secondary bounds through QueryBound sources, utils.rs:131-199; one
    commitment covering them is this repo's equivalent).  `num_slots` pads
    to the universal circuit's fixed placeholder bank."""
    from mp2_tpu_torch.utils.u256 import u256_to_fields

    inputs: List[int] = (
        u256_to_fields(bounds.min_block)
        + u256_to_fields(bounds.max_block)
        + u256_to_fields(getattr(bounds, "min_secondary", 0))
        + u256_to_fields(getattr(bounds, "max_secondary", U256_MAX))
    )
    for n in names:
        inputs.append(p2h.hash_no_pad([ord(c) for c in n])[0])
        inputs.extend(u256_to_fields(ph.get(n)))
    if num_slots is not None:
        inputs.extend([0] * (9 * (num_slots - len(names))))
    return p2h.hash_no_pad(inputs)


def execute_query(
    pis: CircuitPis, table: TableData, ph: Placeholders
) -> QueryResult:
    bounds = pis.bounds.resolve(ph)
    # make the range available to the circuit semantics as placeholders too
    values = dict(ph.values)
    values.setdefault("$MIN_BLOCK", bounds.min_block)
    values.setdefault("$MAX_BLOCK", bounds.max_block)
    ph = Placeholders(values)

    matching: List[Tuple[int, int, List[int]]] = []  # (block, idx, outputs)
    overflow = False
    for block in sorted(table.rows_by_block):
        if not (bounds.min_block <= block <= bounds.max_block):
            continue
        for idx, row in enumerate(table.rows_by_block[block]):
            ok, ov1 = eval_predicate(pis.predicate_ops, row, ph)
            overflow |= ov1
            if not ok:
                continue
            out, ov2 = eval_result_row(pis.result, row, ph)
            overflow |= ov2
            matching.append((block, idx, out))

    # ---- result shaping
    if pis.is_aggregation:
        rows = [aggregate_rows(pis.result, [m[2] for m in matching])]
    else:
        rows = [m[2] for m in matching]
        if pis.order_by is not None:
            j, direction = pis.order_by
            rows = sorted(rows, key=lambda r: r[j], reverse=(direction == "DESC"))
        if pis.result.distinct:
            seen = set()
            uniq = []
            for r in rows:
                t = tuple(r)
                if t not in seen:
                    seen.add(t)
                    uniq.append(r)
            rows = sorted(uniq)
        if pis.offset:
            rows = rows[pis.offset :]
        if pis.limit is not None:
            rows = rows[: pis.limit]

    # ---- proving plan: chunk matching rows (batching_planner.rs:87)
    keys = [(b, i) for b, i, _ in matching]
    chunks = [
        keys[i : i + NUM_ROWS_PER_CHUNK]
        for i in range(0, len(keys), NUM_ROWS_PER_CHUNK)
    ]

    ch = computational_hash(
        pis.predicate_ops, pis.result, table.schema.column_ids()
    )
    return QueryResult(
        rows=rows,
        num_matching_rows=len(matching),
        overflow=overflow,
        computational_hash=ch,
        placeholder_hash=placeholder_hash(pis.placeholder_names, ph, bounds),
        chunks=chunks,
    )
