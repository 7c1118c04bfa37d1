"""In-circuit column-extraction gadget: slice `length` bits at
(byte_offset, bit_offset) out of a 32-byte EVM word and accumulate
per-column value digests.

Circuit counterpart of `extraction.columns.extract_value` /
`column_values_digest` (reference mp2-v1/src/values_extraction/gadgets/
column_gadget.rs:301-368).  The table schema is STATIC here — offsets and
lengths are compile-time constants baked into the leaf circuit (the
reference witnesses ColumnInfo and commits to it via the metadata digest;
baking achieves the same binding because the schema determines the VK and
the metadata digest is a baked constant of the same schema).

A jax-free copy of `mp2_tpu/extraction/column_gadget.py`: only the
imports change.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.curve import (
    CurveTarget,
    curve_add,
    map_to_curve_point_circuit,
)
from mp2_tpu_torch.circuit.gadgets.keccak import bytes_to_bits
from mp2_tpu_torch.extraction.columns import ColumnInfo


def extract_value_circuit(
    b: CircuitBuilder,
    word_bits: List[List[Target]],
    info: ColumnInfo,
) -> List[Target]:
    """Mirror of columns.extract_value over bit targets: `word_bits[i][k]`
    is bit k (LSB-first) of word byte i.  Returns the extracted value as
    32 byte targets, left-padded with zeros."""
    bo = info.bit_offset
    assert 0 <= bo <= 8

    def actual_bit(i: int, j: int) -> Target:
        """Bit j (LSB-first) of extract_value's composed byte at word
        position i: low `bo` bits come from the NEXT byte's top bits, the
        rest from the current byte's low bits."""
        if j < bo:
            if i + 1 >= 32:
                return b.zero()
            return word_bits[i + 1][8 - bo + j]
        return word_bits[i][j - bo]

    last = info.byte_offset + (info.length + 7) // 8 - 1
    out: List[Target] = []
    for i in range(info.byte_offset, last + 1):
        lm8 = info.length % 8
        if i == last and lm8 > 0:
            # final byte keeps only its TOP lm8 bits, shifted down
            acc = b.zero()
            for j in range(8 - lm8, 8):
                acc = b.mul_add(
                    actual_bit(i, j), b.constant(1 << (j - (8 - lm8))), acc
                )
        else:
            acc = b.zero()
            for j in range(8):
                acc = b.mul_add(actual_bit(i, j), b.constant(1 << j), acc)
        out.append(acc)
    z = b.zero()
    return [z] * (32 - len(out)) + out


def column_values_digest_circuit(
    b: CircuitBuilder,
    table_info: Sequence[ColumnInfo],
    extracted_column_identifiers: Sequence[int],
    value32: Sequence[Target],
    word_bits: Optional[List[List[Target]]] = None,
) -> CurveTarget:
    """Sum over extracted columns of D(identifier || pack_be(extracted))
    (columns.column_values_digest in-circuit).  `value32` are the word's
    byte targets; bit decomposition is shared across columns and skipped
    entirely when every extracted column is byte-aligned and full-length."""
    from mp2_tpu_torch.circuit.gadgets.bytes import pack_u32_be

    ids = set(extracted_column_identifiers)
    cols = [c for c in table_info if c.identifier in ids]
    assert cols, "no columns to extract"
    need_bits = any(c.bit_offset != 0 or c.length % 8 != 0 for c in cols)
    if need_bits and word_bits is None:
        bits = bytes_to_bits(b, list(value32))
        word_bits = [bits[8 * i : 8 * (i + 1)] for i in range(32)]

    acc: Optional[CurveTarget] = None
    z = b.zero()
    for info in cols:
        if info.bit_offset == 0 and info.length % 8 == 0:
            n = info.length // 8
            ext = list(value32[info.byte_offset : info.byte_offset + n])
            padded = [z] * (32 - n) + ext
        else:
            padded = extract_value_circuit(b, word_bits, info)
        packed = pack_u32_be(b, padded)
        d = map_to_curve_point_circuit(
            b, [b.constant(info.identifier)] + packed
        )
        acc = d if acc is None else curve_add(b, acc, d)
    return acc
