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

A jax-free copy of the storage part of `mp2_tpu/extraction/api.py`
(`ValuesExtractionOutput`, `SlotEntry`, `extract_storage_slots`): only the
imports change.  The block, contract, length and final-extraction models
wait for their circuits (ROADMAP Queue 1 item 3b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from mp2_tpu_torch.extraction import values as V
from mp2_tpu_torch.extraction.columns import ColumnInfo, filter_table_column_identifiers
from mp2_tpu_torch.field.ecgfp5 import NEUTRAL, Point
from mp2_tpu_torch.utils import rlp
from mp2_tpu_torch.utils.keccak import keccak256
from mp2_tpu_torch.utils.trie import MPT, verify_proof
from mp2_tpu_torch.utils.u256 import left_pad32


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
