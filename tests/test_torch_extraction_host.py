"""The port's host layer of extraction against mp2_tpu on the CPU.

keccak, RLP, the Merkle-Patricia trie, the storage-slot locations, the
column extraction, the values-extraction digests and the host model
`extract_storage_slots` (the values that the storage-trie proofs are held
to) must give the reference's outputs exactly on inputs drawn from a numpy
seed; the tolerance is 0.  Curve points are compared by their field
encodings.
"""

import numpy as np
import pytest

from mp2_tpu.extraction import api as JA
from mp2_tpu.extraction import columns as JCol
from mp2_tpu.extraction import storage_key as JSK
from mp2_tpu.extraction import values as JV
from mp2_tpu.utils import keccak as jkeccak
from mp2_tpu.utils import rlp as jrlp
from mp2_tpu.utils import trie as jtrie
from mp2_tpu_torch.extraction import api as A
from mp2_tpu_torch.extraction import columns as Col
from mp2_tpu_torch.extraction import storage_key as SK
from mp2_tpu_torch.extraction import values as V
from mp2_tpu_torch.extraction.mpt_circuits import (compact_nibbles, host_key_nibbles,
                                                   host_leaf_s, mpt_pi_values)
from mp2_tpu_torch.utils import keccak, rlp, trie

ADDR = bytes(range(20))
CHAIN_ID = 1
SLOT = 4
# block 100 and block 101 of tests/test_circuit_pipeline.py:30-38
PIPELINE_BLOCKS = ({b"\x11": 100, b"\x22": 200},
                   {b"\x11": 150, b"\x22": 200, b"\x33": 50})


def _keccak_lengths():
    edges = [0, 1, 55, 56, 134, 135, 136, 137, 271, 272, 273, 407, 408, 409, 600]
    rng = np.random.default_rng(9)
    return edges + [int(n) for n in rng.integers(0, 601, size=25)]


def test_keccak256_matches_reference():
    rng = np.random.default_rng(1)
    for n in _keccak_lengths():
        msg = rng.bytes(n)
        assert keccak.keccak256(msg) == jkeccak.keccak256(msg) == jkeccak._keccak256_py(msg)
    # Ethereum's keccak256 of the empty string
    assert keccak.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


def test_keccak_f1600_matches_reference():
    rng = np.random.default_rng(2)
    for _ in range(4):
        st = [int(v) for v in rng.integers(0, 1 << 63, size=25, dtype=np.uint64)]
        assert keccak.keccak_f1600(st) == jkeccak.keccak_f1600(st)


def _rlp_item(rng, depth):
    """A random RLP item: byte strings of the short, long and one-byte
    forms, and lists nested up to `depth`."""
    kind = int(rng.integers(0, 4 if depth else 3))
    if kind == 0:
        return rng.bytes(int(rng.integers(0, 2)))
    if kind == 1:
        return rng.bytes(int(rng.integers(2, 56)))
    if kind == 2:
        return rng.bytes(int(rng.integers(56, 300)))
    return [_rlp_item(rng, depth - 1) for _ in range(int(rng.integers(0, 20)))]


def test_rlp_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(60):
        item = _rlp_item(rng, 3)
        enc = rlp.encode(item)
        assert enc == jrlp.encode(item)
        assert rlp.decode(enc) == jrlp.decode(enc) == _as_decoded(item)
    for v in [0, 1, 127, 128, 255, 256, 1 << 64, (1 << 256) - 1]:
        assert rlp.encode_int(v) == jrlp.encode_int(v)


def _as_decoded(item):
    return bytes(item) if isinstance(item, (bytes, bytearray)) else [
        _as_decoded(x) for x in item]


def _mapping_trie(mod_trie, mod_rlp, mod_sk, keys, values, unrelated=True):
    t = mod_trie.MPT(secure=True)
    for k, v in zip(keys, values):
        t.insert(mod_sk.mapping_location(SLOT, k), mod_rlp.encode_int(v))
    if unrelated:
        t.insert(keccak.keccak256(b"unrelated"), mod_rlp.encode_int(7))
    return t


@pytest.mark.parametrize("n_entries", [1, 2, 3, 7, 16, 40])
def test_mpt_matches_reference(n_entries):
    """Root, every proof and its walk for a random mapping trie."""
    rng = np.random.default_rng(100 + n_entries)
    keys = [rng.bytes(int(rng.integers(1, 33))) for _ in range(n_entries)]
    values = [int(v) for v in rng.integers(1, 1 << 62, size=n_entries)]
    values[0] = 10**30  # one value of more than 8 bytes
    t = _mapping_trie(trie, rlp, SK, keys, values)
    jt = _mapping_trie(jtrie, jrlp, JSK, keys, values)
    assert t.root_hash() == jt.root_hash()
    for k, v in zip(keys, values):
        loc = SK.mapping_location(SLOT, k)
        assert loc == JSK.mapping_location(SLOT, k)
        proof = t.get_proof(loc)
        assert proof == jt.get_proof(loc)
        got = trie.verify_proof(t.root_hash(), loc, proof)
        assert got == jtrie.verify_proof(jt.root_hash(), loc, proof) == rlp.encode_int(v)
        assert t.get(loc) == jt.get(loc) == rlp.encode_int(v)
        assert host_key_nibbles(loc) == trie.to_nibbles(keccak.keccak256(loc))
        assert 0 < host_leaf_s(proof[-1]) <= 64
    assert t.get(b"absent") is jt.get(b"absent") is None
    with pytest.raises(AssertionError):
        trie.verify_proof(keccak.keccak256(b"another root"), loc, proof)


def test_hex_prefix_matches_reference():
    rng = np.random.default_rng(4)
    for n in range(0, 65):
        nibs = [int(v) for v in rng.integers(0, 16, size=n)]
        for is_leaf in (False, True):
            hp = trie.hex_prefix(nibs, is_leaf)
            assert hp == jtrie.hex_prefix(nibs, is_leaf)
            if n:
                assert compact_nibbles(hp) == nibs


def test_storage_key_matches_reference():
    rng = np.random.default_rng(5)
    for _ in range(10):
        slot, word = (int(v) for v in rng.integers(0, 256, size=2))
        k1, k2 = rng.bytes(int(rng.integers(1, 33))), rng.bytes(32)
        assert SK.simple_slot_location(slot, word) == JSK.simple_slot_location(slot, word)
        assert SK.mapping_location(slot, k1, word) == JSK.mapping_location(slot, k1, word)
        assert (SK.mapping_of_mappings_location(slot, k1, k2, word)
                == JSK.mapping_of_mappings_location(slot, k1, k2, word))


WORD = bytes([0xDE, 0xAD, 0xBE, 0xEF] + list(range(4, 32 - 4)) + [0xCA, 0xFE, 0x01, 0x7F])
# the columns of tests/test_column_gadget.py:20-34
COLUMNS = [(1, 11, 0, 0, 256, 0), (1, 12, 24, 0, 64, 0), (1, 13, 5, 3, 12, 0),
           (1, 14, 31, 7, 1, 0)]


def test_extract_value_matches_reference():
    """The vectors of tests/test_column_gadget.py:53, then random columns
    over random words."""
    cols, jcols = [Col.ColumnInfo(*c) for c in COLUMNS], [JCol.ColumnInfo(*c) for c in COLUMNS]
    got = Col.extract_value(WORD, cols[2])
    cur, nxt, nxt2 = WORD[5], WORD[6], WORD[7]
    b0 = (((cur & ((1 << 5) - 1)) << 3) + (nxt >> 5)) & 0xFF
    b1 = ((((nxt & ((1 << 5) - 1)) << 3) + (nxt2 >> 5)) & 0xFF) >> 4
    assert len(got) == 32 and got[-2:] == bytes([b0, b1])
    for c, jc in zip(cols, jcols):
        assert Col.extract_value(WORD, c) == JCol.extract_value(WORD, jc)
    rng = np.random.default_rng(6)
    for _ in range(40):
        word = rng.bytes(32)
        byte_offset = int(rng.integers(0, 32))
        bit_offset = int(rng.integers(0, 9))
        length = int(rng.integers(1, 8 * (32 - byte_offset) + 1))
        c = (2, 21, byte_offset, bit_offset, length, 0)
        assert (Col.extract_value(word, Col.ColumnInfo(*c))
                == JCol.extract_value(word, JCol.ColumnInfo(*c)))


def test_column_digests_match_reference():
    cols, jcols = [Col.ColumnInfo(*c) for c in COLUMNS], [JCol.ColumnInfo(*c) for c in COLUMNS]
    assert (Col.metadata_digest(cols).to_fields()
            == JCol.metadata_digest(jcols).to_fields())
    for ids in ([11], [13, 14], [11, 12, 13, 14]):
        assert (Col.column_values_digest(cols, ids, WORD).to_fields()
                == JCol.column_values_digest(jcols, ids, WORD).to_fields())
    assert (Col.filter_table_column_identifiers(cols, 1, 0)
            == JCol.filter_table_column_identifiers(jcols, 1, 0))
    assert Col.simple_column(3, 9) == Col.ColumnInfo(3, 9, 0, 0, 256, 0)


def test_values_digests_match_reference():
    rng = np.random.default_rng(7)
    assert V.identifier_block_column() == JV.identifier_block_column()
    for _ in range(3):
        slot = int(rng.integers(0, 256))
        addr = rng.bytes(20)
        for f in ("identifier_for_mapping_key_column",
                  "identifier_for_outer_mapping_key_column",
                  "identifier_for_inner_mapping_key_column"):
            assert getattr(V, f)(slot, addr, 5) == getattr(JV, f)(slot, addr, 5)
        assert (V.identifier_for_value_column(slot, 3, 64, 1, addr, 5, b"x")
                == JV.identifier_for_value_column(slot, 3, 64, 1, addr, 5, b"x"))
        key_id = V.identifier_for_mapping_key_column(slot, addr, 5)
        value_id = V.identifier_for_value_column(slot, 0, 256, 0, addr, 5)
        table = [Col.simple_column(slot, value_id)]
        jtable = [JCol.simple_column(slot, value_id)]
        value, mkey = rng.bytes(32), rng.bytes(int(rng.integers(1, 33)))
        assert (V.compute_leaf_single_metadata_digest(table).to_fields()
                == JV.compute_leaf_single_metadata_digest(jtable).to_fields())
        assert (V.compute_leaf_single_values_digest(table, [value_id], value).to_fields()
                == JV.compute_leaf_single_values_digest(jtable, [value_id], value).to_fields())
        assert (V.compute_leaf_mapping_metadata_digest(table, slot, key_id).to_fields()
                == JV.compute_leaf_mapping_metadata_digest(jtable, slot, key_id).to_fields())
        for word in (0, 1):
            assert (V.compute_leaf_mapping_values_digest(
                table, [value_id], value, mkey, word, key_id).to_fields()
                == JV.compute_leaf_mapping_values_digest(
                    jtable, [value_id], value, mkey, word, key_id).to_fields())
        unique = V.row_unique_data_for_mapping_leaf(mkey)
        assert unique == JV.row_unique_data_for_mapping_leaf(mkey)
        assert V.compute_row_id(unique, 2) == JV.compute_row_id(unique, 2)
        assert (V.row_unique_data_for_mapping_of_mappings_leaf(mkey, value)
                == JV.row_unique_data_for_mapping_of_mappings_leaf(mkey, value))
        assert V.row_unique_data_for_single_leaf() == JV.row_unique_data_for_single_leaf()


def _extract(pkg_api, pkg_trie, pkg_rlp, pkg_sk, pkg_v, pkg_col, entries, unrelated=True):
    """extract_storage_slots over a mapping table's trie in one package,
    as the pipeline calls it (tests/test_circuit_pipeline.py:30)."""
    key_id = pkg_v.identifier_for_mapping_key_column(SLOT, ADDR, CHAIN_ID)
    value_id = pkg_v.identifier_for_value_column(SLOT, 0, 256, 0, ADDR, CHAIN_ID)
    t = _mapping_trie(pkg_trie, pkg_rlp, pkg_sk, list(entries), list(entries.values()),
                      unrelated)
    slots = [pkg_api.SlotEntry(SLOT, pkg_sk.mapping_location(SLOT, k), mapping_key=k,
                               key_id=key_id) for k in sorted(entries)]
    return t, pkg_api.extract_storage_slots(t, [pkg_col.simple_column(SLOT, value_id)],
                                            slots)


def _extract_both(entries, unrelated=True):
    t, out = _extract(A, trie, rlp, SK, V, Col, entries, unrelated)
    jt, jout = _extract(JA, jtrie, jrlp, JSK, JV, JCol, entries, unrelated)
    assert t.root_hash() == jt.root_hash() == out.node_hash == jout.node_hash
    assert (out.key_pointer, out.n_leaves) == (jout.key_pointer, jout.n_leaves)
    assert out.values_digest.to_fields() == jout.values_digest.to_fields()
    assert out.metadata_digest.to_fields() == jout.metadata_digest.to_fields()
    assert out.n_leaves == len(entries)
    return t, out


@pytest.mark.parametrize("block", [0, 1])
def test_extract_storage_slots_pipeline_tries(block):
    _extract_both(PIPELINE_BLOCKS[block])


def _extension_keys():
    """Two mapping keys whose trie keys share their first nibble: the
    trie of the two (alone) has an extension node at its root."""
    nib = {}
    for i in range(1, 64):
        k = bytes([i])
        first = host_key_nibbles(SK.mapping_location(SLOT, k))[0]
        if first in nib:
            return [nib[first], k]
        nib[first] = k
    raise AssertionError("no two keys share a first nibble")


def test_extract_storage_slots_with_an_extension_node():
    keys = _extension_keys()
    t, out = _extract_both({keys[0]: 10**20, keys[1]: 5}, unrelated=False)
    root = rlp.decode(t.get_proof(SK.mapping_location(SLOT, keys[0]))[0])
    assert len(root) == 2 and root[0][0] >> 4 in (0, 1)  # an extension's hex prefix
    assert out.n_leaves == 2


def test_pipeline_root_public_inputs_are_the_golden_ones():
    """Block 101's root PIs from the port's host model equal those that
    tools/make_extraction_golden.py recorded from the JAX package."""
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "mp2_tpu_torch", "testdata", "extraction_golden.json")
    with open(path) as f:
        golden = json.load(f)
    t, out = _extract_both(PIPELINE_BLOCKS[1])
    assert t.root_hash().hex() == golden["trie"]["root_hash"]
    pis = mpt_pi_values(out.node_hash, out.values_digest, out.metadata_digest, out.n_leaves)
    assert pis == golden["trie"]["host_root_public_inputs"]
    assert golden["table"]["key_id"] == V.identifier_for_mapping_key_column(SLOT, ADDR,
                                                                            CHAIN_ID)
