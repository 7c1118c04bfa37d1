"""EVM storage-slot location derivation (host; the in-circuit version lives
with the keccak gadget).  Reference: mp2-common/src/storage_key.rs and eth.rs
StorageSlot model.

  simple slot s            location = pad32(s)
  struct at slot s, word w location = pad32(s + w)  (w = evm_word offset)
  mapping(k => v) slot s   location = keccak(pad32(k) || pad32(s))
  mapping of mappings      location = keccak(pad32(k2) || keccak(pad32(k1) || pad32(s)))
  struct inside mapping    location = base + evm_word

A jax-free copy of `mp2_tpu/extraction/storage_key.py`: only the
imports change.
"""

from __future__ import annotations

from mp2_tpu_torch.utils.keccak import keccak256
from mp2_tpu_torch.utils.u256 import left_pad32


def simple_slot_location(slot: int, evm_word: int = 0) -> bytes:
    return (slot + evm_word).to_bytes(32, "big")


def mapping_location(slot: int, key: bytes, evm_word: int = 0) -> bytes:
    base = keccak256(left_pad32(key) + (slot).to_bytes(32, "big"))
    return (int.from_bytes(base, "big") + evm_word).to_bytes(32, "big")


def mapping_of_mappings_location(
    slot: int, outer_key: bytes, inner_key: bytes, evm_word: int = 0
) -> bytes:
    inner_base = keccak256(left_pad32(outer_key) + (slot).to_bytes(32, "big"))
    base = keccak256(left_pad32(inner_key) + inner_base)
    return (int.from_bytes(base, "big") + evm_word).to_bytes(32, "big")
