"""Umbrella metadata-hash API (reference: mp2-v1/src/api.rs:289-486).

The public mirrors a consumer calls to predict the metadata commitment a
fully-proven table will carry (the 4-field hash the IVC layer exposes),
WITHOUT running any extraction: `metadata_hash`, `merge_metadata_hash`,
`no_provable_metadata_hash`, plus `compute_table_info` and the
`SlotInputs` descriptor they consume.

Semantics follow THIS pipeline's circuits (extraction/api.py,
models/pipeline.py): the final-extraction metadata digest is the plain
EcGFp5 SUM of the values digest and the contract digest (+ the length
digest for lengthed tables), and the block column id is hashed in once at
the index level (digests.block_metadata_hash — the reference's
combine_digest_and_block, api.rs:421-430).  The reference re-encodes the
values digest through map_to_curve_point at the final level (api.rs:
349-355); this pipeline's final-extraction circuits sum directly, so the
mirrors here match what the circuits actually expose.

A jax-free copy of `mp2_tpu/extraction/metadata.py`: only the imports
change.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from mp2_tpu_torch.extraction import values as V
from mp2_tpu_torch.extraction.columns import ColumnInfo
from mp2_tpu_torch.extraction.final_circuits import (
    DUMMY_METADATA_DIGEST_PREFIX,
)
from mp2_tpu_torch.field.ecgfp5 import Point
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.utils.u256 import pack_bytes_be
from mp2_tpu_torch.vdb import digests as D

HashOut = Tuple[int, int, int, int]


@dataclass(frozen=True)
class SlotInput:
    """One extracted column of an EVM storage slot (api.rs SlotInput)."""

    slot: int
    byte_offset: int = 0
    length: int = 256  # bits
    evm_word: int = 0


@dataclass(frozen=True)
class SlotInputs:
    """Which slot family a table extracts (api.rs SlotInputs)."""

    kind: str  # "simple" | "mapping" | "mapping_of_mappings" | "mapping_with_length"
    inputs: Tuple[SlotInput, ...]
    length_slot: Optional[int] = None

    @staticmethod
    def simple(inputs: Sequence[SlotInput]) -> "SlotInputs":
        return SlotInputs("simple", tuple(inputs))

    @staticmethod
    def mapping(inputs: Sequence[SlotInput]) -> "SlotInputs":
        return SlotInputs("mapping", tuple(inputs))

    @staticmethod
    def mapping_of_mappings(inputs: Sequence[SlotInput]) -> "SlotInputs":
        return SlotInputs("mapping_of_mappings", tuple(inputs))

    @staticmethod
    def mapping_with_length(
        inputs: Sequence[SlotInput], length_slot: int
    ) -> "SlotInputs":
        return SlotInputs("mapping_with_length", tuple(inputs), length_slot)


def compute_table_info(
    inputs: Sequence[SlotInput],
    contract_address: bytes,
    chain_id: int,
    extra: bytes = b"",
) -> List[ColumnInfo]:
    """api.rs compute_table_info: derive each column's identifier and
    ColumnInfo from its SlotInput."""
    out = []
    for si in inputs:
        ident = V.identifier_for_value_column(
            si.slot, si.byte_offset, si.length, si.evm_word,
            contract_address, chain_id, extra,
        )
        out.append(
            ColumnInfo(
                slot=si.slot, identifier=ident, byte_offset=si.byte_offset,
                bit_offset=0, length=si.length, evm_word=si.evm_word,
            )
        )
    return out


def _value_metadata(
    s: SlotInputs, contract_address: bytes, chain_id: int, extra: bytes
) -> Point:
    """api.rs value_metadata: the values-extraction metadata digest for one
    slot family (block id NOT yet included)."""
    ti = compute_table_info(s.inputs, contract_address, chain_id, extra)
    if s.kind == "simple":
        return V.compute_leaf_single_metadata_digest(ti)
    slot = s.inputs[0].slot
    assert all(si.slot == slot for si in s.inputs), (
        "mapping-family inputs must share one slot"
    )
    if s.kind == "mapping":
        key_id = V.identifier_for_mapping_key_column(
            slot, contract_address, chain_id, extra
        )
        return V.compute_leaf_mapping_metadata_digest(ti, slot, key_id)
    if s.kind == "mapping_of_mappings":
        outer = V.identifier_for_outer_mapping_key_column(
            slot, contract_address, chain_id, extra
        )
        inner = V.identifier_for_inner_mapping_key_column(
            slot, contract_address, chain_id, extra
        )
        return V.compute_leaf_mapping_of_mappings_metadata_digest(
            ti, slot, outer, inner
        )
    if s.kind == "mapping_with_length":
        key_id = V.identifier_for_mapping_key_column(
            slot, contract_address, chain_id, extra
        )
        md = V.compute_leaf_mapping_metadata_digest(ti, slot, key_id)
        # length_extraction DM commits to (length_slot, variable_slot)
        # (extraction/api.py length proof)
        return md + p2h.map_to_curve_point([s.length_slot, slot])
    raise ValueError(f"unknown SlotInputs kind {s.kind!r}")


def contract_metadata_digest(contract_address: bytes) -> Point:
    """DM = D(pack_u32_be(address)) (contract_extraction/leaf.rs:98)."""
    return p2h.map_to_curve_point(pack_bytes_be(contract_address))


def metadata_hash(
    slot_inputs: SlotInputs,
    contract_address: bytes,
    chain_id: int,
    extra: bytes = b"",
) -> HashOut:
    """api.rs metadata_hash: the commitment a fully-proven table carries —
    H((values_DM + contract_DM).to_fields() || block_column_id)."""
    dm = _value_metadata(slot_inputs, contract_address, chain_id, extra)
    dm = dm + contract_metadata_digest(contract_address)
    return D.block_metadata_hash(dm, V.identifier_block_column())


def merge_metadata_hash(
    contract_address: bytes,
    chain_id: int,
    extra: bytes,
    table_a: SlotInputs,
    table_b: SlotInputs,
) -> HashOut:
    """api.rs merge_metadata_hash: two tables of one contract merged at
    final extraction.  THIS pipeline's merge circuit sums the two values
    metadata digests and the contract digest directly
    (final_circuits.final_merge_pi_values: DM = DM_a + DM_b + contract) —
    the reference instead re-encodes each side through map_to_curve_point
    (api.rs:289-309); the mirror matches what our circuit exposes."""
    md_a = _value_metadata(table_a, contract_address, chain_id, extra)
    md_b = _value_metadata(table_b, contract_address, chain_id, extra)
    dm = md_a + md_b + contract_metadata_digest(contract_address)
    return D.block_metadata_hash(dm, V.identifier_block_column())


def no_provable_metadata_digest(column_ids: Sequence[int]) -> Point:
    """api.rs no_provable_metadata_digest: digest of the (deduplicated,
    sorted) column identifiers."""
    ids = sorted(set(int(c) for c in column_ids))
    return p2h.map_to_curve_point(ids)


def no_provable_metadata_hash(
    column_ids: Sequence[int], provable_data_commitment: bool = False
) -> HashOut:
    """api.rs no_provable_metadata_hash: the commitment for a table with
    NO provable extraction — the digest of the column ids, re-encoded
    under the DUMMY_EXTRACTION prefix exactly as the no-provable final-
    extraction circuit does (final_circuits.build_no_provable_body), so
    a dummy proof can never masquerade as a provable one."""
    md = no_provable_metadata_digest(column_ids)
    enc = p2h.map_to_curve_point(
        list(DUMMY_METADATA_DIGEST_PREFIX) + md.to_fields()
    )
    if provable_data_commitment:
        # commitment additionally binds the table data root recomputation
        # flag (api.rs:468-486 prefix semantics)
        return p2h.hash_no_pad(
            enc.to_fields() + [V.identifier_block_column(), 1]
        )
    return D.block_metadata_hash(enc, V.identifier_block_column())
