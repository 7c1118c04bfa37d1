"""The pipeline's table configuration and block fixtures.

The part of `mp2_tpu/models/pipeline.py` that the circuit-driven indexer
(`models.circuit_pipeline.CircuitTableIndexer` and `MergedTableIndexer`)
needs: the circuit names, `MappingTableConfig` (a table extracted from one
mapping slot), `MergedTableConfig` (a mapping table joined with a single
slot), the fixture chain `make_chain` builds (each block's storage trie,
state trie and RLP header), the tables' query schemas and `IvcOutput`.  A
jax-free copy in which only the imports change.

Not ported yet: the host-golden `TableIndexer`, which waits for ROADMAP
Queue 1 item 5.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from mp2_tpu_torch.extraction import storage_key as SK
from mp2_tpu_torch.extraction import values as V
from mp2_tpu_torch.extraction.columns import simple_column
from mp2_tpu_torch.parsil.symbols import ZkColumn, ZkTable
from mp2_tpu_torch.utils import rlp
from mp2_tpu_torch.utils.keccak import keccak256
from mp2_tpu_torch.utils.trie import MPT

CIRCUITS = [
    "values_leaf", "values_branch", "contract", "block_extraction",
    "final_extraction", "cells_leaf", "cells_full", "cells_partial",
    "rows_leaf", "rows_full", "rows_partial", "block_leaf", "block_parent",
    "block_membership", "ivc_first", "ivc_subsequent",
    "row_chunk", "chunk_aggregation", "non_existence", "revelation",
]


@dataclass
class MappingTableConfig:
    """A table extracted from one mapping slot: rows keyed by mapping key."""

    contract_address: bytes
    chain_id: int
    slot: int

    def __post_init__(self):
        self.key_id = V.identifier_for_mapping_key_column(
            self.slot, self.contract_address, self.chain_id
        )
        self.value_id = V.identifier_for_value_column(
            self.slot, 0, 256, 0, self.contract_address, self.chain_id
        )
        self.block_id = V.identifier_block_column()
        self.column = simple_column(self.slot, self.value_id)

    def schema(self) -> ZkTable:
        return ZkTable(
            "t",
            [
                ZkColumn("block", self.block_id, "primary_index"),
                ZkColumn("key", self.key_id, "secondary_index"),
                ZkColumn("value", self.value_id),
            ],
        )


@dataclass
class MergedTableConfig(MappingTableConfig):
    """A MERGED table (final_extraction merge_circuit.rs): a mapping table
    (individual rows) joined with a single-slot table whose columns repeat
    on every row (the multiplier side of the split-digest scheme) — e.g.
    ERC-20 balances merged with the total supply."""

    single_slot: int = 0

    def __post_init__(self):
        super().__post_init__()
        assert self.single_slot != self.slot
        self.supply_id = V.identifier_for_value_column(
            self.single_slot, 0, 256, 0, self.contract_address, self.chain_id
        )
        self.single_column = simple_column(self.single_slot, self.supply_id)

    def schema(self) -> ZkTable:
        return ZkTable(
            "t",
            [
                ZkColumn("block", self.block_id, "primary_index"),
                ZkColumn("key", self.key_id, "secondary_index"),
                ZkColumn("value", self.value_id),
                ZkColumn("supply", self.supply_id),
            ],
        )


@dataclass
class BlockFixture:
    number: int
    header_rlp: bytes
    state: MPT
    storage: MPT
    entries: Dict[bytes, int]  # mapping key -> value
    single_value: Optional[int] = None  # merged tables: the multiplier slot


def make_chain(
    cfg: MappingTableConfig, per_block_entries: Sequence[Dict[bytes, int]],
    start_block: int = 100,
    single_values: Optional[Sequence[int]] = None,
) -> List[BlockFixture]:
    """Build a fixture chain: each block's storage trie holds the mapping
    (and, for merged tables, the single multiplier slot per
    `single_values[i]`)."""
    blocks = []
    parent = keccak256(b"genesis")
    for i, entries in enumerate(per_block_entries):
        number = start_block + i
        storage = MPT(secure=True)
        for k, v in entries.items():
            storage.insert(SK.mapping_location(cfg.slot, k), rlp.encode_int(v))
        single_v = single_values[i] if single_values is not None else None
        if single_v is not None:
            storage.insert(
                SK.simple_slot_location(cfg.single_slot),
                rlp.encode_int(single_v),
            )
        storage.insert(keccak256(b"unrelated"), rlp.encode_int(7))
        state = MPT(secure=True)
        account = rlp.encode(
            [b"\x01", b"\x00", storage.root_hash(), keccak256(b"code")]
        )
        state.insert(cfg.contract_address, account)
        header = rlp.encode(
            [
                parent,
                keccak256(b"uncles"),
                bytes(20),
                state.root_hash(),
                keccak256(b"tx"),
                keccak256(b"rc"),
                b"\x00" * 32,
                b"\x01",
                number.to_bytes(4, "big"),
            ]
        )
        blocks.append(
            BlockFixture(number, header, state, storage, dict(entries),
                         single_value=single_v)
        )
        parent = keccak256(header)
    return blocks


@dataclass
class IvcOutput:
    first_block: int
    latest_block: int
    latest_block_hash: bytes
    block_tree_root: Tuple[int, int, int, int]
    metadata_hash: Tuple[int, int, int, int]
