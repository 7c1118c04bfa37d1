"""Values-extraction conventions: column identifiers, row unique data, leaf
digests (host golden model of mp2-v1/src/values_extraction/mod.rs:157-470).

These are the map-phase outputs over storage-trie leaves: each leaf yields a
values digest DV (accumulated over the MPT towards the root) and a metadata
digest DM committing to the table schema.

A jax-free copy of `mp2_tpu/extraction/values.py` without the
mapping-of-mappings leaf's values digest, which waits for that leaf's
circuit (ROADMAP Queue 1 item 3b.5): only the imports change.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from mp2_tpu_torch.extraction.columns import (
    ColumnInfo,
    column_values_digest,
    metadata_digest,
)
from mp2_tpu_torch.field.ecgfp5 import Point
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.utils.u256 import left_pad32, pack_bytes_be

KEY_ID_PREFIX = b"\0KEY"
INNER_KEY_ID_PREFIX = b"\0\0IN_KEY"
OUTER_KEY_ID_PREFIX = b"\0OUT_KEY"
BLOCK_ID_DST = b"BLOCK_NUMBER"

HashOut = Tuple[int, int, int, int]


# ---------------------------------------------------------------------------
# column identifiers
# ---------------------------------------------------------------------------


def identifier_block_column() -> int:
    return p2h.hash_no_pad(list(BLOCK_ID_DST))[0]


def identifier_raw_extra(contract_address: bytes, chain_id: int, extra: bytes = b"") -> bytes:
    assert len(contract_address) == 20
    return contract_address + chain_id.to_bytes(8, "big") + extra


def identifier_for_value_column(
    slot: int,
    byte_offset: int,
    length: int,
    evm_word: int,
    contract_address: bytes,
    chain_id: int,
    extra: bytes = b"",
) -> int:
    """id = H(slot || byte_offset || length || evm_word || addr || chain || extra)[0]
    (all single bytes except the be-encoded u32/u64 parts)."""
    raw = (
        bytes([slot])
        + byte_offset.to_bytes(4, "big")
        + length.to_bytes(4, "big")
        + evm_word.to_bytes(4, "big")
        + identifier_raw_extra(contract_address, chain_id, extra)
    )
    return p2h.hash_no_pad(list(raw))[0]


def _id_with_prefix(prefix: bytes, slot: int, extra: bytes) -> int:
    raw = prefix + bytes([slot]) + extra
    return p2h.hash_no_pad(list(raw))[0]


def identifier_for_mapping_key_column(
    slot: int, contract_address: bytes, chain_id: int, extra: bytes = b""
) -> int:
    return _id_with_prefix(
        KEY_ID_PREFIX, slot, identifier_raw_extra(contract_address, chain_id, extra)
    )


def identifier_for_outer_mapping_key_column(
    slot: int, contract_address: bytes, chain_id: int, extra: bytes = b""
) -> int:
    return _id_with_prefix(
        OUTER_KEY_ID_PREFIX, slot, identifier_raw_extra(contract_address, chain_id, extra)
    )


def identifier_for_inner_mapping_key_column(
    slot: int, contract_address: bytes, chain_id: int, extra: bytes = b""
) -> int:
    return _id_with_prefix(
        INNER_KEY_ID_PREFIX, slot, identifier_raw_extra(contract_address, chain_id, extra)
    )


# ---------------------------------------------------------------------------
# row unique data & row ids
# ---------------------------------------------------------------------------


def row_unique_data(columns: Sequence[bytes]) -> HashOut:
    packed = []
    for col in columns:
        packed.extend(pack_bytes_be(left_pad32(col)))
    return p2h.hash_no_pad(packed)


def row_unique_data_for_single_leaf() -> HashOut:
    return row_unique_data([])


def row_unique_data_for_mapping_leaf(mapping_key: bytes) -> HashOut:
    return row_unique_data([mapping_key])


def row_unique_data_for_mapping_of_mappings_leaf(
    outer_key: bytes, inner_key: bytes
) -> HashOut:
    return row_unique_data([outer_key, inner_key])


def compute_row_id(unique: HashOut, num_actual_columns: int) -> int:
    h = p2h.hash_no_pad(list(unique) + [num_actual_columns])
    return p2h.hash_to_int(h)


# ---------------------------------------------------------------------------
# leaf digests (values + metadata)
# ---------------------------------------------------------------------------


def compute_leaf_single_metadata_digest(table_info: Sequence[ColumnInfo]) -> Point:
    return metadata_digest(table_info)


def compute_leaf_single_values_digest(
    table_info: Sequence[ColumnInfo],
    extracted_column_identifiers: Sequence[int],
    value: bytes,
) -> Point:
    vd = column_values_digest(table_info, extracted_column_identifiers, value)
    row_id = compute_row_id(row_unique_data_for_single_leaf(), len(table_info))
    return vd.scalar_mul(row_id)


def compute_leaf_mapping_metadata_digest(
    table_info: Sequence[ColumnInfo], slot: int, key_id: int
) -> Point:
    md = metadata_digest(table_info)
    # key_column_md = H(be_u32("\0KEY") || slot)
    prefix = int.from_bytes(KEY_ID_PREFIX, "big")
    key_column_md = p2h.hash_no_pad([prefix, slot])
    md_key = p2h.map_to_curve_point(list(key_column_md) + [key_id])
    return md + md_key


def compute_leaf_mapping_values_digest(
    table_info: Sequence[ColumnInfo],
    extracted_column_identifiers: Sequence[int],
    value: bytes,
    mapping_key: bytes,
    evm_word: int,
    key_id: int,
) -> Point:
    num_actual_columns = len(table_info) + 1
    vd = column_values_digest(table_info, extracted_column_identifiers, value)
    if evm_word == 0:
        inputs = [key_id] + pack_bytes_be(left_pad32(mapping_key))
        vd = vd + p2h.map_to_curve_point(inputs)
    row_id = compute_row_id(
        row_unique_data_for_mapping_leaf(mapping_key), num_actual_columns
    )
    return vd.scalar_mul(row_id)


def compute_leaf_mapping_of_mappings_metadata_digest(
    table_info: Sequence[ColumnInfo], slot: int, outer_key_id: int, inner_key_id: int
) -> Point:
    md = metadata_digest(table_info)
    for prefix_bytes, key_id in (
        (OUTER_KEY_ID_PREFIX, outer_key_id),
        (INNER_KEY_ID_PREFIX, inner_key_id),
    ):
        prefix = int.from_bytes(prefix_bytes, "big")
        col_md = p2h.hash_no_pad([prefix, slot])
        md = md + p2h.map_to_curve_point(list(col_md) + [key_id])
    return md

