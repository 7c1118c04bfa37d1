"""Table schemas + settings for the SQL front-end (role of
parsil/src/symbols.rs: ZkTable/ZkColumn + the ContextProvider trait with
its per-instance MAX_* bounds, symbols.rs:108-137, and the
FileContextProvider used by the golden tests).

A jax-free copy of `mp2_tpu/parsil/symbols.py`: only the imports change."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from mp2_tpu_torch.parsil import errors as E


@dataclass(frozen=True)
class ZkColumn:
    name: str
    identifier: int  # the digest column identifier
    kind: str = "standard"  # "primary_index" | "secondary_index" | "standard"


@dataclass
class ZkTable:
    name: str
    columns: List[ZkColumn]

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise E.UnknownColumn(name, self.name)

    def column(self, name: str) -> ZkColumn:
        return self.columns[self.column_index(name)]

    @property
    def primary_index(self) -> ZkColumn:
        return next(c for c in self.columns if c.kind == "primary_index")

    @property
    def secondary_index(self) -> Optional[ZkColumn]:
        return next((c for c in self.columns if c.kind == "secondary_index"), None)

    def column_ids(self) -> List[int]:
        return [c.identifier for c in self.columns]


class ContextProvider:
    """Schema lookup + the circuit-side resource bounds that flow into
    query validation and UniversalQueryParams (symbols.rs ContextProvider:
    MAX_NUM_COLUMNS / _PREDICATE_OPS / _RESULT_OPS / _ITEMS_PER_OUTPUT /
    _OUTPUTS as per-instance values instead of Rust associated consts)."""

    def __init__(
        self,
        tables: Dict[str, ZkTable],
        max_num_columns: int = 20,
        max_num_predicate_ops: int = 20,
        max_num_result_ops: int = 20,
        max_num_items_per_output: int = 5,
        max_num_outputs: int = 3,
        max_num_placeholders: int = 10,
    ):
        self.tables = tables
        self.max_num_columns = max_num_columns
        self.max_num_predicate_ops = max_num_predicate_ops
        self.max_num_result_ops = max_num_result_ops
        self.max_num_items_per_output = max_num_items_per_output
        self.max_num_outputs = max_num_outputs
        self.max_num_placeholders = max_num_placeholders

    def table(self, name: str) -> ZkTable:
        if name not in self.tables:
            raise E.UnknownTable(name)
        return self.tables[name]

    def universal_query_params(self, num_placeholders: Optional[int] = None):
        """Bounds -> UniversalQueryParams, so circuit instantiation is
        driven by the provider instead of hand-built test params
        (VERDICT r3 item 5)."""
        from mp2_tpu_torch.vdb.query.universal import UniversalQueryParams

        return UniversalQueryParams(
            num_columns=self.max_num_columns,
            num_placeholders=num_placeholders or self.max_num_placeholders,
            num_predicate_ops=self.max_num_predicate_ops,
            num_result_ops=self.max_num_result_ops,
            num_outputs=self.max_num_items_per_output,
        )


class FileContextProvider(ContextProvider):
    """Load ZkTable schemas from a JSON file (symbols.rs
    FileContextProvider::from_file).  Format: a list of
    {"name": ..., "columns": [{"name", "id", "kind"}...]}."""

    def __init__(self, path: str, **bounds):
        with open(path) as f:
            raw = json.load(f)
        tables = {}
        for t in raw:
            cols = [
                ZkColumn(c["name"], int(c["id"]), c.get("kind", "standard"))
                for c in t["columns"]
            ]
            tables[t["name"]] = ZkTable(t["name"], cols)
        super().__init__(tables, **bounds)


@dataclass
class PlaceholderSettings:
    """Which placeholders a query may reference (placeholders.rs role):
    $MIN_BLOCK / $MAX_BLOCK always, plus $1..$n freestanding."""

    num_freestanding: int = 0

    def validate_name(self, name: str) -> None:
        if name in ("$MIN_BLOCK", "$MAX_BLOCK"):
            return
        body = name[1:]
        if body.isdigit() and 1 <= int(body) <= self.num_freestanding:
            return
        raise E.UnknownPlaceholder(name)


@dataclass
class ParsilSettings:
    """parse_and_validate inputs (utils.rs ParsilSettings): schema context,
    placeholder policy, and the invocation-time LIMIT/OFFSET (inline
    LIMIT/OFFSET in the SQL text are rejected with
    UseInvocationParameter, matching the reference's must_reject
    corpus)."""

    context: ContextProvider
    placeholders: PlaceholderSettings = field(
        default_factory=PlaceholderSettings
    )
    limit: Optional[int] = None
    offset: Optional[int] = None
    # legacy repo surface: parse_and_assemble(sql, table) accepts inline
    # LIMIT/OFFSET (pre-round-4 tests and the CLI rely on it)
    allow_inline_limit: bool = False
