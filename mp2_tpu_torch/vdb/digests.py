"""Verifiable-DB hash & digest conventions (host golden model).

Out-of-circuit mirrors of the reference's cells/rows/block-tree circuit
outputs — the exact formulas the tree-building layer aggregates and the
circuits (mp2_tpu_torch.vdb.circuits, later milestones) must reproduce in-circuit:

  cell values digest   D(identifier || u256_be_limbs(value))
                       (verifiable-db/src/cells_tree/mod.rs:66-73)
  cells node hash      H(left_h || right_h || identifier || value)
                       with empty-hash placeholders (leaf.rs:30-40,
                       partial_node.rs: single child is always LEFT)
  split digests        individual vs multiplier accumulation
                       (mp2-common/src/digest.rs:13-112)
  row digest           row_id_individual = H2Int(row_unique_data || ind_cnt);
                       individual_vd *= row_id_individual
                       (row_tree/secondary_index_cell.rs:100-141)
  row node hash        H(left_h || right_h || min || max || index_id ||
                         index_value || cells_tree_hash)   (row_tree/leaf.rs:40)
  block node digest    HashToInt(H(index_id || index_value)) * rows_digest
                       (block_tree/mod.rs:22-58)
  block node hash      H(left_h || right_h || min || max || index_id ||
                         index_value || rows_tree_hash)    (block_tree/leaf.rs)
  final digest (merge) individual + H2Int(H('') || mult_cnt) * multiplier_vd
                       (block_tree/mod.rs compute_final_digest)

A jax-free copy of `mp2_tpu/vdb/digests.py`: only the imports change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from mp2_tpu_torch.field.ecgfp5 import NEUTRAL, Point
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.utils.u256 import u256_to_fields

HashOut = Tuple[int, int, int, int]
EMPTY_HASH: HashOut = p2h.empty_poseidon_hash()


# ---------------------------------------------------------------------------
# split digests (multiplier / individual)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SplitDigest:
    individual: Point
    multiplier: Point

    @staticmethod
    def neutral() -> "SplitDigest":
        return SplitDigest(NEUTRAL, NEUTRAL)

    @staticmethod
    def from_single(digest: Point, is_multiplier: bool) -> "SplitDigest":
        if is_multiplier:
            return SplitDigest(NEUTRAL, digest)
        return SplitDigest(digest, NEUTRAL)

    def accumulate(self, other: "SplitDigest") -> "SplitDigest":
        return SplitDigest(
            self.individual + other.individual,
            self.multiplier + other.multiplier,
        )


# ---------------------------------------------------------------------------
# cells tree
# ---------------------------------------------------------------------------


def cell_values_digest(identifier: int, value: int) -> Point:
    return p2h.map_to_curve_point([identifier] + u256_to_fields(value))


def cells_node_hash(
    left_h: Optional[HashOut], right_h: Optional[HashOut], identifier: int, value: int
) -> HashOut:
    lh = left_h if left_h is not None else EMPTY_HASH
    rh = right_h if right_h is not None else EMPTY_HASH
    return p2h.hash_no_pad(
        list(lh) + list(rh) + [identifier] + u256_to_fields(value)
    )


# ---------------------------------------------------------------------------
# rows tree
# ---------------------------------------------------------------------------


def row_id_individual(row_unique_data: HashOut, individual_cnt: int) -> int:
    h = p2h.hash_no_pad(list(row_unique_data) + [individual_cnt])
    return p2h.hash_to_int(h)


@dataclass(frozen=True)
class RowDigest:
    multiplier_cnt: int
    individual_vd: Point
    multiplier_vd: Point


def row_digest(
    identifier: int,
    value: int,
    is_multiplier: bool,
    row_unique_data: HashOut,
    cells_split: SplitDigest,
    cells_individual_cnt: int,
    cells_multiplier_cnt: int,
) -> RowDigest:
    own = SplitDigest.from_single(cell_values_digest(identifier, value), is_multiplier)
    acc = own.accumulate(cells_split)
    individual_cnt = cells_individual_cnt + (0 if is_multiplier else 1)
    multiplier_cnt = cells_multiplier_cnt + (1 if is_multiplier else 0)
    rid = row_id_individual(row_unique_data, individual_cnt)
    return RowDigest(
        multiplier_cnt=multiplier_cnt,
        individual_vd=acc.individual.scalar_mul(rid),
        multiplier_vd=acc.multiplier,
    )


def row_node_hash(
    left_h: Optional[HashOut],
    right_h: Optional[HashOut],
    min_value: int,
    max_value: int,
    index_id: int,
    index_value: int,
    cells_tree_hash: HashOut,
) -> HashOut:
    lh = left_h if left_h is not None else EMPTY_HASH
    rh = right_h if right_h is not None else EMPTY_HASH
    return p2h.hash_no_pad(
        list(lh)
        + list(rh)
        + u256_to_fields(min_value)
        + u256_to_fields(max_value)
        + [index_id]
        + u256_to_fields(index_value)
        + list(cells_tree_hash)
    )


# ---------------------------------------------------------------------------
# block (index) tree
# ---------------------------------------------------------------------------


def compute_index_digest(inputs: Sequence[int], digest: Point) -> Point:
    h = p2h.hash_no_pad(list(inputs))
    return digest.scalar_mul(p2h.hash_to_int(h))


def add_primary_index_to_digest(
    primary_index_id: int, index_value: int, digest: Point
) -> Point:
    return compute_index_digest(
        [primary_index_id] + u256_to_fields(index_value), digest
    )


def compute_final_digest(
    is_merge_case: bool,
    individual_vd: Point,
    multiplier_vd: Point,
    multiplier_cnt: int,
) -> Point:
    """block_tree/mod.rs:69-95: in the merge case
        row_id_multiplier = H2Int(H("") || multiplier_cnt)
        multiplier_digest = row_id_multiplier * multiplier_vd
        final             = H2Int(fields(multiplier_digest)) * individual_vd
    which equals the final-extraction merge digest
    H2Int(fields(dv_mult)) * dv_ind (merge_circuit.rs/digest.rs
    combine_to_digest): the single multiplier table's extraction digest is
    row_id * sum(column digests) with row_id = H2Int(H("") || #columns)."""
    if not is_merge_case:
        return individual_vd
    h = p2h.hash_no_pad(list(EMPTY_HASH) + [multiplier_cnt])
    md = multiplier_vd.scalar_mul(p2h.hash_to_int(h))
    fh = p2h.hash_no_pad(md.to_fields())
    return individual_vd.scalar_mul(p2h.hash_to_int(fh))


def block_node_hash(
    left_h: Optional[HashOut],
    right_h: Optional[HashOut],
    min_value: int,
    max_value: int,
    index_id: int,
    index_value: int,
    rows_tree_hash: HashOut,
) -> HashOut:
    # same layout as the rows tree node hash
    return row_node_hash(
        left_h, right_h, min_value, max_value, index_id, index_value, rows_tree_hash
    )


def block_metadata_hash(extraction_metadata_digest: Point, index_id: int) -> HashOut:
    """metadata_hash = H(extraction.DM || block_id) (block_tree/leaf.rs)."""
    return p2h.hash_no_pad(extraction_metadata_digest.to_fields() + [index_id])


# ---------------------------------------------------------------------------
# IVC
# ---------------------------------------------------------------------------

PROVABLE_DATA_COMMITMENT_PREFIX = b"DATA_COMMIT"


def provable_data_commitment_prefix_hash(metadata_hash: HashOut) -> HashOut:
    prefix = [b for b in PROVABLE_DATA_COMMITMENT_PREFIX]
    return p2h.hash_no_pad(prefix + list(metadata_hash))


def ivc_data_commitment(prev_commitment: HashOut, digest: Point) -> HashOut:
    """H(prev_commitment || current multiset digest) (ivc/circuit.rs:37+)."""
    return p2h.hash_no_pad(list(prev_commitment) + digest.to_fields())
