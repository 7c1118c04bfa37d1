"""Query proof planner: tree access + non-existence inputs.

Role of mp2-v1/src/query/planner.rs (`TreeFetcher`, `NonExistenceInput`)
and parsil's bracketer: given a query's primary-index range, locate the
nodes proving emptiness (largest node below / smallest node above the
range) and fetch the touched-node lineages the row-chunk circuits need.

A jax-free copy of `mp2_tpu/vdb/query/planner.py`: only the imports change.
`find_node_for_non_existence_sql` pushes its probes down into
`ryhope/pgsql`, which is not ported yet (ROADMAP Queue 1 item 4), and
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from mp2_tpu_torch.ryhope.kvdb import MerkleTreeKvDb


@dataclass(frozen=True)
class NonExistenceInput:
    """Witness for an empty primary-index range (query/non_existence.rs):
    a node adjacent to the range plus its Merkle path, proving no index
    value falls inside [min_query, max_query]."""

    node_key: object
    lineage: List
    is_below: bool  # node is the predecessor (True) or successor (False)


def find_node_for_non_existence(
    db: MerkleTreeKvDb, min_query: int, max_query: int, epoch: Optional[int] = None
) -> Optional[NonExistenceInput]:
    """Bracketer: the largest key < min_query, else the smallest key >
    max_query.  Returns None if keys exist INSIDE the range (range not
    empty)."""
    view = db.view_at(epoch) if epoch is not None else db.current_view()
    keys = sorted(view.keys())
    if any(min_query <= k <= max_query for k in keys):
        return None
    below = [k for k in keys if k < min_query]
    above = [k for k in keys if k > max_query]
    if below:
        key = max(below)
        return NonExistenceInput(key, view.lineage(key), True)
    if above:
        key = min(above)
        return NonExistenceInput(key, view.lineage(key), False)
    return None  # empty tree


def fetch_row_paths(
    db: MerkleTreeKvDb, keys: Sequence, epoch: Optional[int] = None
) -> Dict[object, List]:
    """Merkle paths (with payloads available via the db) for the rows a
    chunk proof touches (merkle_path.rs gadget inputs)."""
    view = db.view_at(epoch) if epoch is not None else db.current_view()
    return {k: view.lineage(k) for k in keys if view.tree.contains(k)}


# --------------------------------------------------------------------------
# SQL push-down variants (VERDICT r3 item 6): the searches run INSIDE the
# store (ORDER BY ... LIMIT 1 probes, one ANY() bulk fetch) instead of
# enumerating every key host-side — O(log n)/O(touched) instead of
# O(table) per query.  Mirrors parsil/src/bracketer.rs +
# mp2-v1/src/query/planner.rs:39-80 (TreeFetcher wide-lineage caching).
# --------------------------------------------------------------------------


@dataclass
class WideLineage:
    """Bulk-fetched proving context (ryhope storage/mod.rs WideLineage
    role): per-touched-row Merkle paths + every needed payload, obtained
    with ONE store round trip."""

    lineages: Dict[object, List]
    payloads: Dict[object, object]


def find_node_for_non_existence_sql(
    store, view, min_query: int, max_query: int, accessor: Optional[str] = None
) -> Optional[NonExistenceInput]:
    """Push-down bracketer: three LIMIT-1 probes against the store (range
    occupancy, largest-below, smallest-above) — no host-side key
    enumeration.  `view` supplies topology for the witness lineage;
    `store` is a PgsqlTreeStore whose table holds the same tree.  The
    bracketer and the store are not ported yet (ROADMAP Queue 1 item 4)."""
    raise NotImplementedError(
        "find_node_for_non_existence_sql needs parsil/bracketer and "
        "ryhope/pgsql, which are not ported yet (ROADMAP Queue 1 item 4)")


def fetch_wide_lineage(store, view, keys: Sequence) -> WideLineage:
    """TreeFetcher role: lineages from closed-form topology (host math,
    O(k log n)), payloads via ONE ANY() bulk fetch of the union of all
    lineage keys (planner.rs:39-80 batch + cache discipline)."""
    lineages = {
        k: view.lineage(k) for k in keys if view.tree.contains(k)
    }
    needed = sorted({k for lin in lineages.values() for k in lin}, key=repr)
    payloads = store.wide_lineage_between(view.epoch, needed)
    return WideLineage(lineages=lineages, payloads=payloads)
