"""Verifiable-DB tree construction: cells tree -> rows tree -> block tree.

Typed glue between the digest conventions and the ryhope stores — the role
of mp2-v1's `indexing` module (the reference's mp2-v1/src/indexing/: CellTree
= in-memory sbbst, RowTree = scapegoat keyed by the secondary index,
BlockTree = append-only sbbst keyed by block number; payloads carry hash +
digest per node and implement aggregation).

Every payload aggregation here mirrors the corresponding circuit's public-
input computation, so proofs generated later bind to exactly these values.

A jax-free copy of `mp2_tpu/vdb/trees.py`: only the imports change.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from mp2_tpu_torch.field.ecgfp5 import NEUTRAL, Point
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.ryhope.kvdb import MerkleTreeKvDb
from mp2_tpu_torch.ryhope.sbbst import Sbbst
from mp2_tpu_torch.ryhope.scapegoat import Scapegoat
from mp2_tpu_torch.utils.u256 import u256_to_fields
from mp2_tpu_torch.vdb import digests as D
from mp2_tpu_torch.vdb.digests import HashOut, RowDigest, SplitDigest


@dataclass(frozen=True)
class Cell:
    identifier: int
    value: int
    is_multiplier: bool = False


# ---------------------------------------------------------------------------
# cells tree (complete BST over the non-indexed cells of one row)
# ---------------------------------------------------------------------------


@dataclass
class CellsNode:
    cell: Cell
    hash: HashOut = None
    split: SplitDigest = None
    individual_cnt: int = 0
    multiplier_cnt: int = 0


@dataclass(frozen=True)
class CellsTreeResult:
    root_hash: HashOut
    split: SplitDigest
    individual_cnt: int
    multiplier_cnt: int
    nodes: Dict[int, CellsNode]
    tree: Sbbst


def build_cells_tree(cells: List[Cell]) -> CellsTreeResult:
    """Cells positioned 1..n in an sbbst (reference indexing/cell.rs:24-33).

    Empty cells list => empty-tree result (empty hash, neutral digests).
    """
    tree = Sbbst(n=len(cells))
    nodes = {i + 1: CellsNode(c) for i, c in enumerate(cells)}
    if not cells:
        return CellsTreeResult(D.EMPTY_HASH, SplitDigest.neutral(), 0, 0, {}, tree)

    def fill(k: int):
        l, r = tree.children_inner(k)
        for c in (l, r):
            if c is not None:
                fill(c)
        node = nodes[k]
        lh = nodes[l].hash if l is not None else None
        rh = nodes[r].hash if r is not None else None
        node.hash = D.cells_node_hash(lh, rh, node.cell.identifier, node.cell.value)
        own = SplitDigest.from_single(
            D.cell_values_digest(node.cell.identifier, node.cell.value),
            node.cell.is_multiplier,
        )
        split = own
        ind = 0 if node.cell.is_multiplier else 1
        mult = 1 if node.cell.is_multiplier else 0
        for c in (l, r):
            if c is not None:
                split = split.accumulate(nodes[c].split)
                ind += nodes[c].individual_cnt
                mult += nodes[c].multiplier_cnt
        node.split = split
        node.individual_cnt = ind
        node.multiplier_cnt = mult

    root = tree.root_inner()
    fill(root)
    r = nodes[root]
    return CellsTreeResult(r.hash, r.split, r.individual_cnt, r.multiplier_cnt, nodes, tree)


# ---------------------------------------------------------------------------
# rows tree (scapegoat keyed by the secondary index)
# ---------------------------------------------------------------------------

# RowTreeKey: (secondary_value, unique_suffix) so duplicated secondary values
# stay distinct, ordered by value first (reference RowTreeKey semantics).
RowTreeKey = Tuple[int, int]


@dataclass
class RowPayload:
    secondary: Cell
    row_unique_data: HashOut
    cells: CellsTreeResult
    # aggregated (filled by the kvdb aggregate hook)
    hash: HashOut = None
    min_value: int = 0
    max_value: int = 0
    individual_vd: Point = NEUTRAL
    multiplier_vd: Point = NEUTRAL
    multiplier_cnt: int = 0

    def own_digest(self) -> RowDigest:
        return D.row_digest(
            self.secondary.identifier,
            self.secondary.value,
            self.secondary.is_multiplier,
            self.row_unique_data,
            self.cells.split,
            self.cells.individual_cnt,
            self.cells.multiplier_cnt,
        )


def _row_aggregate(key: RowTreeKey, payload: RowPayload, children) -> RowPayload:
    own = payload.own_digest()
    mins = [payload.secondary.value]
    maxs = [payload.secondary.value]
    ind = own.individual_vd
    # every row carries the SAME multiplier digest/counter (the shared
    # multiplier columns of a merged table); children must agree, not sum
    # (row_tree/full_node.rs:46-52)
    mult = own.multiplier_vd
    mcnt = own.multiplier_cnt
    lh = rh = None
    left, right = children
    if left is not None:
        mins.append(left.min_value)
        maxs.append(left.max_value)
        ind = ind + left.individual_vd
        assert left.multiplier_vd == mult and left.multiplier_cnt == mcnt, (
            "rows disagree on the multiplier digest"
        )
        lh = left.hash
    if right is not None:
        mins.append(right.min_value)
        maxs.append(right.max_value)
        ind = ind + right.individual_vd
        assert right.multiplier_vd == mult and right.multiplier_cnt == mcnt, (
            "rows disagree on the multiplier digest"
        )
        rh = right.hash
    payload.min_value = min(mins)
    payload.max_value = max(maxs)
    payload.individual_vd = ind
    payload.multiplier_vd = mult
    payload.multiplier_cnt = mcnt
    payload.hash = D.row_node_hash(
        lh,
        rh,
        payload.min_value,
        payload.max_value,
        payload.secondary.identifier,
        payload.secondary.value,
        payload.cells.root_hash,
    )
    return payload


def new_row_tree(alpha: float = 0.8) -> MerkleTreeKvDb:
    return MerkleTreeKvDb(Scapegoat(alpha), _row_aggregate)


# ---------------------------------------------------------------------------
# block (index) tree
# ---------------------------------------------------------------------------


@dataclass
class BlockPayload:
    index_id: int  # block-number column identifier
    block_number: int
    rows_hash: HashOut  # rows tree root hash
    rows_digest: Point  # final digest of the rows tree (after merge handling)
    # aggregated
    hash: HashOut = None
    min_value: int = 0
    max_value: int = 0
    digest: Point = NEUTRAL  # accumulated node digests over the subtree

    def node_digest(self) -> Point:
        """HashToInt(H(index_id || block_number)) * rows_digest."""
        return D.compute_index_digest(
            [self.index_id] + u256_to_fields(self.block_number),
            self.rows_digest,
        )


def _block_aggregate(key: int, payload: BlockPayload, children) -> BlockPayload:
    mins = [payload.block_number]
    maxs = [payload.block_number]
    digest = payload.node_digest()
    lh = rh = None
    left, right = children
    if left is not None:
        mins.append(left.min_value)
        maxs.append(left.max_value)
        digest = digest + left.digest
        lh = left.hash
    if right is not None:
        mins.append(right.min_value)
        maxs.append(right.max_value)
        digest = digest + right.digest
        rh = right.hash
    payload.min_value = min(mins)
    payload.max_value = max(maxs)
    payload.digest = digest
    payload.hash = D.block_node_hash(
        lh,
        rh,
        payload.min_value,
        payload.max_value,
        payload.index_id,
        payload.block_number,
        payload.rows_hash,
    )
    return payload


def new_block_tree() -> MerkleTreeKvDb:
    return MerkleTreeKvDb(Sbbst(), _block_aggregate)
