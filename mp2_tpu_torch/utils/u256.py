"""U256 <-> field-element packing (host side).

Convention from the reference (mp2-common/src/u256.rs:871-878): a 256-bit
unsigned integer is 8 u32 limbs in BIG-endian order, each limb one Goldilocks
element.  Byte packing follows utils::Packer with Endianness::Big.

A jax-free copy of `mp2_tpu/utils/u256.py`: only the imports change.
"""

from __future__ import annotations

from typing import List, Sequence

NUM_LIMBS = 8
U256_MAX = (1 << 256) - 1


def u256_to_fields(v: int) -> List[int]:
    assert 0 <= v <= U256_MAX
    return [(v >> (32 * (NUM_LIMBS - 1 - i))) & 0xFFFFFFFF for i in range(NUM_LIMBS)]


def u256_from_fields(limbs: Sequence[int]) -> int:
    assert len(limbs) == NUM_LIMBS
    v = 0
    for l in limbs:
        v = (v << 32) | (int(l) & 0xFFFFFFFF)
    return v


def left_pad32(data: bytes) -> bytes:
    assert len(data) <= 32
    return b"\x00" * (32 - len(data)) + data


def pack_bytes_be(data: bytes) -> List[int]:
    """Pack bytes into u32 field elements, big-endian (utils::Packer)."""
    assert len(data) % 4 == 0
    return [int.from_bytes(data[i : i + 4], "big") for i in range(0, len(data), 4)]


def pack_bytes_le(data: bytes) -> List[int]:
    assert len(data) % 4 == 0
    return [int.from_bytes(data[i : i + 4], "little") for i in range(0, len(data), 4)]
