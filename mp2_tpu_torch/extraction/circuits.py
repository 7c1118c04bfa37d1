"""Extraction circuits: the first REAL in-circuit extraction family.

block_extraction (reference mp2-v1/src/block_extraction/circuit.rs:20-50):
proves an RLP block header keccak-hashes to the claimed block hash and
extracts parent hash / state root / block number from their header offsets
(fixed by the header schema; the reference hardcodes state-root offset 91
for mainnet headers, parameterized here so fixture and mainnet shapes both
compile).

storage-key derivation (reference mp2-common/src/storage_key.rs:209-597):
in-circuit keccak(pad32(mapping_key) || pad32(slot)) — the location a
mapping entry's MPT leaf must sit under.

The remaining family (RLP leaf decode, variable-depth MPT path walks,
branch circuits — mp2-common/src/{rlp.rs, mpt_sequential}) builds on the
same keccak + byte-wire layer; tracked in STATUS.md as the next slice.

A jax-free copy of `mp2_tpu/extraction/circuits.py`: only the imports
change, `_bits_to_u32s_be_bytes` is imported from `mpt_circuits` (which
carries it), and the two builders take the device their circuit is
compiled for and proved on (`device="cuda"` unless the caller asks for the
CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.keccak import keccak256_fixed, set_bytes
from mp2_tpu_torch.extraction.mpt_circuits import _bits_to_u32s_be_bytes
from mp2_tpu_torch.prover.config import CircuitConfig, test_config
from mp2_tpu_torch.prover.prove import CircuitData, prove
from mp2_tpu_torch.utils.u256 import pack_bytes_be


def _bytes_to_u32s_be(b: CircuitBuilder, byte_ts: Sequence[Target]) -> List[Target]:
    out = []
    for i in range(0, len(byte_ts), 4):
        acc = None
        for j in range(4):
            term = b.mul_const(1 << (8 * (3 - j)), byte_ts[i + j])
            acc = term if acc is None else b.add(acc, term)
        out.append(acc)
    return out


@dataclass
class BlockExtractionCircuit:
    """PIs: block_hash(8 u32) || parent_hash(8) || state_root(8) || number."""

    data: CircuitData
    header_targets: List[Target]

    def prove_header(self, header: bytes):
        inputs: Dict = {}
        set_bytes(inputs, self.header_targets, header)
        w = self.data.generate_witness(inputs)
        return prove(self.data, w, self.expected_public_inputs(header))

    def expected_public_inputs(self, header: bytes) -> List[int]:
        from mp2_tpu_torch.extraction.api import extract_block

        out = extract_block(header)
        return (
            pack_bytes_be(out.block_hash)
            + pack_bytes_be(out.parent_hash)
            + pack_bytes_be(out.state_root)
            + [out.block_number]
        )


def build_block_extraction_circuit(
    header_len: int,
    parent_offset: int,
    state_root_offset: int,
    number_offset: int,
    number_len: int,
    config: CircuitConfig = None,
    device="cuda",
) -> BlockExtractionCircuit:
    """Offsets are schema constants of the header layout (the RLP structure
    of a header is fixed per fork; reference bakes offset 91/449)."""
    b = CircuitBuilder(config or test_config())
    header = b.add_inputs(header_len)
    digest_bits = keccak256_fixed(b, header)
    block_hash = _bits_to_u32s_be_bytes(b, digest_bits)
    parent = _bytes_to_u32s_be(b, header[parent_offset : parent_offset + 32])
    state_root = _bytes_to_u32s_be(
        b, header[state_root_offset : state_root_offset + 32]
    )
    number = None
    for i in range(number_len):
        term = b.mul_const(
            1 << (8 * (number_len - 1 - i)), header[number_offset + i]
        )
        number = term if number is None else b.add(number, term)
    b.register_public_inputs(block_hash + parent + state_root + [number])
    return BlockExtractionCircuit(data=b.build(device), header_targets=header)


def fixture_header_offsets(header: bytes) -> dict:
    """Locate the field offsets inside an RLP header (works for the test
    fixture shape AND canonical headers: fields sit at fixed offsets once
    the list prefix length is known)."""
    # list prefix: 0xf7+k followed by k length bytes
    assert header[0] >= 0xF7, "expected a long-list header"
    prefix = 1 + (header[0] - 0xF7)
    parent_offset = prefix + 1          # 0xa0 || 32 bytes
    uncles_offset = parent_offset + 32 + 1
    coinbase_offset = uncles_offset + 32 + 1  # 0x94 || 20 bytes
    state_root_offset = coinbase_offset + 20 + 1
    # walk remaining items to the 9th (block number)
    off = state_root_offset + 32
    idx = 4
    while idx < 8:
        h = header[off]
        if h < 0x80:
            off += 1
        elif h <= 0xB7:
            off += 1 + (h - 0x80)
        else:
            k = h - 0xB7
            off += 1 + k + int.from_bytes(header[off + 1 : off + 1 + k], "big")
        idx += 1
    h = header[off]
    if h < 0x80:
        number_offset, number_len = off, 1
    else:
        number_offset, number_len = off + 1, h - 0x80
    return dict(
        header_len=len(header),
        parent_offset=parent_offset,
        state_root_offset=state_root_offset,
        number_offset=number_offset,
        number_len=number_len,
    )


# ---------------------------------------------------------------------------
# storage-key derivation
# ---------------------------------------------------------------------------


@dataclass
class MappingLocationCircuit:
    """PIs: location(8 u32) — keccak(pad32(key) || pad32(slot)), the slot
    of a mapping entry (storage_key.rs:409-480)."""

    data: CircuitData
    key_targets: List[Target]
    slot_target: Target

    def prove_location(self, key: bytes, slot: int):
        from mp2_tpu_torch.extraction.storage_key import mapping_location
        from mp2_tpu_torch.utils.u256 import left_pad32

        inputs: Dict = {}
        set_bytes(inputs, self.key_targets, left_pad32(key))
        inputs[self.slot_target] = slot
        w = self.data.generate_witness(inputs)
        pis = pack_bytes_be(mapping_location(slot, key))
        return prove(self.data, w, pis)


def build_mapping_location_circuit(
    config: CircuitConfig = None,
    device="cuda",
) -> MappingLocationCircuit:
    b = CircuitBuilder(config or test_config())
    key = b.add_inputs(32)  # already left-padded to 32
    slot = b.add_input()
    # slot as a 32-byte big-endian word: 31 zero bytes + the slot byte
    # (slots < 256, the reference's u8 slot convention)
    b.decompose_bits(slot, 8)
    zero = b.zero()
    slot_bytes = [zero] * 31 + [slot]
    digest_bits = keccak256_fixed(b, list(key) + slot_bytes)
    location = _bits_to_u32s_be_bytes(b, digest_bits)
    b.register_public_inputs(location)
    return MappingLocationCircuit(data=b.build(device), key_targets=key, slot_target=slot)
