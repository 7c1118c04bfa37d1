"""Extraction pipeline (host golden model): the map-reduce pass over
Ethereum state that feeds the verifiable DB.

Mirrors the reference's mp2-v1 flow (SURVEY.md §3.2): per-MPT-node outputs
(map phase over storage-trie leaves, reduce over branches), contract-level
state-trie binding, block-header extraction, and the final-extraction join.
Each dataclass carries exactly the public inputs its circuit counterpart
exposes, so the proving layer (mp2_tpu_torch.vdb/extraction circuits) binds to
these values; until those circuits land, this model IS the pipeline executed
by the end-to-end tests (the reference uses the same layering for its
unit tests via unconstrained dummy proofs, SURVEY.md §4 tier 2).

A jax-free copy of `mp2_tpu/extraction/api.py`: only the imports change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from mp2_tpu_torch.extraction import values as V
from mp2_tpu_torch.extraction.columns import ColumnInfo, filter_table_column_identifiers
from mp2_tpu_torch.field.ecgfp5 import NEUTRAL, Point
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.utils import rlp
from mp2_tpu_torch.utils.keccak import keccak256
from mp2_tpu_torch.utils.trie import MPT, verify_proof
from mp2_tpu_torch.utils.u256 import left_pad32, pack_bytes_be


@dataclass(frozen=True)
class ValuesExtractionOutput:
    """Per-subtree output of the values-extraction map phase
    (values_extraction/public_inputs.rs:24-37)."""

    node_hash: bytes  # keccak of the subtree's top node (H)
    key_pointer: int  # nibbles consumed below this node (T counts down)
    values_digest: Point  # DV
    metadata_digest: Point  # DM
    n_leaves: int  # N


@dataclass(frozen=True)
class SlotEntry:
    """One storage slot to extract: a simple/struct slot, or one mapping
    entry (mapping_key + key_id set)."""

    slot: int
    location: bytes
    mapping_key: Optional[bytes] = None
    key_id: Optional[int] = None
    evm_word: int = 0


def extract_storage_slots(
    trie: MPT,
    table_info: Sequence[ColumnInfo],
    slot_entries: Sequence[SlotEntry],
) -> ValuesExtractionOutput:
    """Run the map-reduce extraction over a storage trie.

    Each entry's MPT path is walked leaf-to-root; shared branches accumulate
    child digests (branch circuits at arities 2/9/16 in the reference; the
    host model aggregates exactly, the proving layer batches per arity).
    """
    # Phase 1: collect leaf contributions and the dedup'd proof DAG.
    leaf_outputs: Dict[bytes, ValuesExtractionOutput] = {}
    children: Dict[bytes, set] = {}
    root_body: Optional[bytes] = None

    for entry in slot_entries:
        slot, location = entry.slot, entry.location
        proof = trie.get_proof(location)
        value_rlp = verify_proof(trie.root_hash(), location, proof)
        value = left_pad32(rlp.decode(value_rlp))
        ids = filter_table_column_identifiers(table_info, slot, entry.evm_word)
        if entry.mapping_key is None:
            dv = V.compute_leaf_single_values_digest(table_info, ids, value)
            dm = V.compute_leaf_single_metadata_digest(table_info)
        else:
            assert entry.key_id is not None
            dv = V.compute_leaf_mapping_values_digest(
                table_info, ids, value, entry.mapping_key, entry.evm_word,
                entry.key_id,
            )
            dm = V.compute_leaf_mapping_metadata_digest(
                table_info, slot, entry.key_id
            )
        leaf_body = proof[-1]
        out = ValuesExtractionOutput(
            node_hash=keccak256(leaf_body),
            key_pointer=0,
            values_digest=dv,
            metadata_digest=dm,
            n_leaves=1,
        )
        prev = leaf_outputs.get(leaf_body)
        if prev is not None:
            out = ValuesExtractionOutput(
                node_hash=out.node_hash,
                key_pointer=out.key_pointer,
                values_digest=prev.values_digest + out.values_digest,
                metadata_digest=out.metadata_digest,
                n_leaves=prev.n_leaves + out.n_leaves,
            )
        leaf_outputs[leaf_body] = out
        # record the (deduplicated) parent -> child edges of this proof
        for parent, child in zip(proof[:-1], proof[1:]):
            assert keccak256(child) in parent or child in parent, (
                "child not in parent node"
            )
            children.setdefault(parent, set()).add(child)
        if root_body is None:
            root_body = proof[0]
        else:
            assert root_body == proof[0], "all proofs must share the trie root"
    assert root_body is not None

    # Phase 2: fold bottom-up once (reduce phase: branch circuits sum child
    # digests and leaf counts).
    def fold(body: bytes) -> ValuesExtractionOutput:
        if body in leaf_outputs and body not in children:
            return leaf_outputs[body]
        dv = NEUTRAL
        dm = None
        n = 0
        max_ptr = 0
        for child in sorted(children.get(body, ())):
            c = fold(child)
            dv = dv + c.values_digest
            # the reference branch circuit ENFORCES all children share one
            # metadata digest (values_extraction/branch.rs:104-105); mixed
            # tables under one branch must be rejected, not silently merged
            if dm is not None and dm != c.metadata_digest:
                raise AssertionError(
                    "branch children disagree on metadata digest (mixed tables)"
                )
            dm = c.metadata_digest
            n += c.n_leaves
            max_ptr = max(max_ptr, c.key_pointer)
        if body in leaf_outputs:  # a branch that also terminates a key
            l = leaf_outputs[body]
            dv = dv + l.values_digest
            if dm is not None and dm != l.metadata_digest:
                raise AssertionError(
                    "branch children disagree on metadata digest (mixed tables)"
                )
            dm = l.metadata_digest
            n += l.n_leaves
        return ValuesExtractionOutput(
            node_hash=keccak256(body),
            key_pointer=max_ptr + 1,
            values_digest=dv,
            metadata_digest=dm,
            n_leaves=n,
        )

    return fold(root_body)


# ---------------------------------------------------------------------------
# block extraction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockExtractionOutput:
    """block_extraction PIs: block hash, prev hash, state root, number."""

    block_hash: bytes
    parent_hash: bytes
    state_root: bytes
    block_number: int


def extract_block(header_rlp: bytes) -> BlockExtractionOutput:
    items = rlp.decode(header_rlp)
    assert isinstance(items, list) and len(items) >= 9
    return BlockExtractionOutput(
        block_hash=keccak256(header_rlp),
        parent_hash=items[0],
        state_root=items[3],
        block_number=int.from_bytes(items[8], "big"),
    )


# ---------------------------------------------------------------------------
# contract extraction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ContractExtractionOutput:
    """contract_extraction PIs: state-trie node hash, storage root, DM."""

    node_hash: bytes
    storage_root: bytes
    metadata_digest: Point


def extract_contract(
    state_trie: MPT, contract_address: bytes, account_rlp_fields=None
) -> ContractExtractionOutput:
    proof = state_trie.get_proof(contract_address)
    account_rlp = verify_proof(state_trie.root_hash(), contract_address, proof)
    account = rlp.decode(account_rlp)  # [nonce, balance, storage_root, code_hash]
    storage_root = account[2]
    # DM = D(pack_u32_be(contract_address))  (contract_extraction/leaf.rs:98)
    dm = p2h.map_to_curve_point(pack_bytes_be(contract_address))
    return ContractExtractionOutput(
        node_hash=state_trie.root_hash(),
        storage_root=storage_root,
        metadata_digest=dm,
    )


# ---------------------------------------------------------------------------
# length extraction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LengthExtractionOutput:
    """length_extraction PIs: the length-slot value + storage-trie binding
    (role of mp2-v1/src/length_extraction: proves a 'length slot' so
    final extraction can check completeness n == length)."""

    node_hash: bytes  # storage trie root
    slot: int
    length: int
    metadata_digest: Point


def extract_length(
    trie: MPT, slot: int, location: bytes, variable_slot: int
) -> LengthExtractionOutput:
    proof = trie.get_proof(location)
    value_rlp = verify_proof(trie.root_hash(), location, proof)
    length = int.from_bytes(rlp.decode(value_rlp), "big")
    # DM = D(length_slot || variable_slot): commits to the SLOTS only, so the
    # digest is stable across blocks (length_extraction/api.rs:27-31; the
    # circuit must not commit to the changing length value)
    dm = p2h.map_to_curve_point([slot, variable_slot])
    return LengthExtractionOutput(
        node_hash=trie.root_hash(), slot=slot, length=length, metadata_digest=dm
    )


# ---------------------------------------------------------------------------
# final extraction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FinalExtractionOutput:
    """final_extraction PIs: block hash binding + digests
    (final_extraction/base_circuit.rs:35-70)."""

    block_hash: bytes
    prev_block_hash: bytes
    block_number: int
    values_digest: Point
    metadata_digest: Point
    is_merge: bool = False


def final_extraction(
    block_out: BlockExtractionOutput,
    contract_out: ContractExtractionOutput,
    values_out: ValuesExtractionOutput,
    storage_trie_root: bytes,
    state_trie_root: bytes,
) -> FinalExtractionOutput:
    """The reduce-phase join (Simple variant): storage root of the values
    proof must equal the contract's storage root; the state root must be the
    block's."""
    assert values_out.node_hash == contract_out.storage_root == storage_trie_root, (
        "values proof root != contract storage root"
    )
    assert state_trie_root == block_out.state_root, "state root not in block"
    # final metadata digest = contract DM + values DM (merged commitment)
    dm = values_out.metadata_digest + contract_out.metadata_digest
    return FinalExtractionOutput(
        block_hash=block_out.block_hash,
        prev_block_hash=block_out.parent_hash,
        block_number=block_out.block_number,
        values_digest=values_out.values_digest,
        metadata_digest=dm,
    )


def final_extraction_lengthed(
    block_out: BlockExtractionOutput,
    contract_out: ContractExtractionOutput,
    values_out: ValuesExtractionOutput,
    length_out: LengthExtractionOutput,
    storage_trie_root: bytes,
    state_trie_root: bytes,
) -> FinalExtractionOutput:
    """Lengthed variant (final_extraction/api.rs): additionally checks
    extraction COMPLETENESS — the number of extracted leaves must equal the
    on-chain length-slot value."""
    assert length_out.node_hash == storage_trie_root, (
        "length proof is not over the same storage trie"
    )
    assert values_out.n_leaves == length_out.length, (
        f"incomplete extraction: {values_out.n_leaves} leaves != "
        f"length slot {length_out.length}"
    )
    out = final_extraction(
        block_out, contract_out, values_out, storage_trie_root, state_trie_root
    )
    return FinalExtractionOutput(
        block_hash=out.block_hash,
        prev_block_hash=out.prev_block_hash,
        block_number=out.block_number,
        values_digest=out.values_digest,
        metadata_digest=out.metadata_digest + length_out.metadata_digest,
    )
