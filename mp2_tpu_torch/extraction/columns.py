"""Column-extraction gadget data (host golden model).

Mirrors mp2-v1's column gadgets: ColumnInfo (slot / byte_offset / bit_offset
/ length / evm_word / identifier), bit-level value extraction out of 32-byte
EVM words (gadgets/column_gadget.rs:326-368), per-column metadata digests
(gadgets/column_info.rs:94-118) and table metadata digests
(gadgets/metadata_gadget.rs:126-130).

A jax-free copy of `mp2_tpu/extraction/columns.py`: only the imports
change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from mp2_tpu_torch.field.ecgfp5 import NEUTRAL, Point
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.utils.u256 import left_pad32, pack_bytes_be

MAPPING_LEAF_VALUE_LEN = 32
MAX_FIELD_PER_EVM = 16  # reference mp2-v1/src/api.rs:88


@dataclass(frozen=True)
class ColumnInfo:
    slot: int
    identifier: int
    byte_offset: int
    bit_offset: int
    length: int  # in bits
    evm_word: int

    def mpt_metadata(self):
        """H(slot || evm_word || byte_offset || bit_offset || length)."""
        return p2h.hash_no_pad(
            [self.slot, self.evm_word, self.byte_offset, self.bit_offset, self.length]
        )

    def digest(self) -> Point:
        """D(mpt_metadata || identifier)."""
        return p2h.map_to_curve_point(
            list(self.mpt_metadata()) + [self.identifier]
        )


def simple_column(slot: int, identifier: int) -> ColumnInfo:
    """A full 32-byte (256-bit) column at evm_word 0."""
    return ColumnInfo(
        slot=slot, identifier=identifier, byte_offset=0, bit_offset=0,
        length=256, evm_word=0,
    )


def _first_bits(v: int, n: int) -> int:
    return v >> (8 - n) if n else 0


def _last_bits(v: int, n: int) -> int:
    return v & ((1 << n) - 1)


def extract_value(value_bytes: bytes, info: ColumnInfo) -> bytes:
    """Bit-exact port of the reference's extract_value: slice length bits at
    (byte_offset, bit_offset) out of the 32-byte word, left-padded to 32."""
    assert len(value_bytes) == MAPPING_LEAF_VALUE_LEN
    assert info.bit_offset <= 8
    last_byte_offset = info.byte_offset + (info.length + 7) // 8 - 1
    result = []
    for i in range(info.byte_offset, last_byte_offset + 1):
        cur = value_bytes[i]
        nxt = value_bytes[i + 1] if i < MAPPING_LEAF_VALUE_LEN - 1 else 0
        actual = (
            _last_bits(cur, 8 - info.bit_offset) << info.bit_offset
        ) + _first_bits(nxt, info.bit_offset)
        result.append(actual & 0xFF)
    length_mod_8 = info.length % 8
    if length_mod_8 > 0:
        result[-1] = _first_bits(result[-1], length_mod_8)
    return left_pad32(bytes(result))


def metadata_digest(table_info: Sequence[ColumnInfo]) -> Point:
    """Sum of per-column digests over the actual columns."""
    acc = NEUTRAL
    for info in table_info:
        acc = acc + info.digest()
    return acc


def column_values_digest(
    table_info: Sequence[ColumnInfo],
    extracted_column_identifiers: Sequence[int],
    value_bytes: bytes,
) -> Point:
    """Sum over extracted columns of D(identifier || pack_be(extracted)).

    (ColumnGadgetData::digest, column_gadget.rs:301-324; only columns whose
    identifier is listed are extracted from this EVM word.)
    """
    acc = NEUTRAL
    ids = set(extracted_column_identifiers)
    for info in table_info:
        if info.identifier not in ids:
            continue
        extracted = extract_value(value_bytes, info)
        inputs = [info.identifier] + pack_bytes_be(extracted)
        acc = acc + p2h.map_to_curve_point(inputs)
    return acc


def filter_table_column_identifiers(
    table_info: Sequence[ColumnInfo], slot: int, evm_word: int
) -> List[int]:
    return [
        c.identifier
        for c in table_info
        if c.slot == slot and c.evm_word == evm_word
    ]
