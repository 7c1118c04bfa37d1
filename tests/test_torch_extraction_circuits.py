"""The port's extraction circuits against mp2_tpu on the CPU.

Mirrors tests/test_keccak_gadget.py:24,45 (the in-circuit keccak-256 of a
fixed-length message of one and of two blocks), tests/test_column_gadget.py:38
(the column-extraction gadget) and tests/test_mpt_circuits.py:56,118,188,321
(the storage trie's `leaf_single`, `branch`, `extension` and `leaf_mapping`
circuits, each also refusing a forged input).  Every circuit is built in
both packages, once per module, and shared by the cases that use it.  The
port's witness must equal the reference's and pass `check_witness` against
the public inputs of the port's host layer; the tolerance is 0.

The column-gadget circuits (128 and 512 rows) are compiled in full and
their `circuit_digest` values compared.  The others have 2^14 to 2^16 rows:
as in tests/test_torch_vdb_block.py, both packages compile them without the
fixed commitment and the inputs of the commitment are compared (n, the gate
types in order, the selector, constant and sigma columns and the public
input targets).  The members of the recursive set, verifiers included, are
held against the JAX package's digests on the card (chip_smoke.py,
testdata/extraction_golden.json).
"""

import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest

import mp2_tpu.circuit.builder as jbuilder
import mp2_tpu.circuit.gadgets.bytes as jbytes
import mp2_tpu.circuit.gadgets.curve as jcurve
import mp2_tpu.circuit.gadgets.keccak as jkeccak_gadget
import mp2_tpu.extraction.column_gadget as jcolumn_gadget
import mp2_tpu.extraction.columns as jcolumns
import mp2_tpu.extraction.mpt_circuits as jmpt
import mp2_tpu.extraction.storage_key as jsk
import mp2_tpu.extraction.values as jvalues
import mp2_tpu.prover.config as jconfig
import mp2_tpu.prover.prove as jprove
import mp2_tpu.utils.keccak as jkeccak
import mp2_tpu.utils.rlp as jrlp
import mp2_tpu.utils.trie as jtrie
import mp2_tpu.utils.u256 as ju256
import mp2_tpu_torch.circuit.builder as builder
import mp2_tpu_torch.circuit.gadgets.bytes as bytes_gadget
import mp2_tpu_torch.circuit.gadgets.curve as curve
import mp2_tpu_torch.circuit.gadgets.keccak as keccak_gadget
import mp2_tpu_torch.extraction.column_gadget as column_gadget
import mp2_tpu_torch.extraction.columns as columns
import mp2_tpu_torch.extraction.mpt_circuits as mpt
import mp2_tpu_torch.extraction.storage_key as sk
import mp2_tpu_torch.extraction.values as values
import mp2_tpu_torch.prover.config as config
import mp2_tpu_torch.prover.prove as prove
import mp2_tpu_torch.utils.keccak as keccak
import mp2_tpu_torch.utils.rlp as rlp
import mp2_tpu_torch.utils.trie as trie
import mp2_tpu_torch.utils.u256 as u256
from mp2_tpu_torch.field.ecgfp5 import Point
from mp2_tpu_torch.utils import collector_paused

PKGS = {
    "port": SimpleNamespace(
        B=builder.CircuitBuilder, cfg=config.test_config, kg=keccak_gadget,
        bg=bytes_gadget, curve=curve, cg=column_gadget, col=columns, mpt=mpt,
        sk=sk, v=values, keccak=keccak, rlp=rlp, trie=trie, u256=u256,
        build=lambda b: b.build("cpu")),
    "ref": SimpleNamespace(
        B=jbuilder.CircuitBuilder, cfg=jconfig.test_config, kg=jkeccak_gadget,
        bg=jbytes, curve=jcurve, cg=jcolumn_gadget, col=jcolumns, mpt=jmpt,
        sk=jsk, v=jvalues, keccak=jkeccak, rlp=jrlp, trie=jtrie, u256=ju256,
        build=lambda b: b.build()),
}
ADDR = bytes(range(20))
CHAIN_ID = 1
KECCAK_MESSAGES = {"single_block": bytes(range(64)),  # tests/test_keccak_gadget.py:24,45
                   "two_blocks": bytes((7 * i + 3) % 256 for i in range(150))}


@pytest.fixture
def without_fixed_commitment(monkeypatch):
    """Compile without the fixed columns' LDE and Merkle commitment."""
    monkeypatch.setattr(prove.CircuitData, "_build_fixed", lambda self: None)
    monkeypatch.setattr(jprove.CircuitData, "_build_fixed", lambda self: None)


def _same_circuit(data, jdata):
    """The port's circuit against the reference's: the digest where the
    fixed commitment was computed, else None in both, and the commitment's
    inputs."""
    assert data.n == jdata.n
    assert [n for n, _ in data.gate_types] == [n for n, _ in jdata.gate_types]
    for col in ("selector_values", "constants_values", "sigma_values"):
        np.testing.assert_array_equal(getattr(data, col), getattr(jdata, col))
    assert list(data.public_inputs) == list(jdata.public_inputs)
    assert data.circuit_digest == jdata.circuit_digest


def _witness(data, assign_fn):
    inputs = {}
    assign_fn(inputs)
    with collector_paused():
        return data.generate_witness(inputs)


class _Stub:
    """A child proof's public inputs as plain witness inputs."""

    def __init__(self, b, n):
        self.ts = b.add_inputs(n)

    def assign(self, inputs, vals):
        for t, v in zip(self.ts, vals):
            inputs[t] = int(v)


# ---------------------------------------------------------------------------
# the in-circuit keccak
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _keccak_case(pkg, case):
    """(circuit, witness) of keccak256_fixed over one of KECCAK_MESSAGES."""
    m, msg = PKGS[pkg], KECCAK_MESSAGES[case]
    with collector_paused():
        b = m.B(m.cfg())
        byte_ts = b.add_inputs(len(msg))
        b.register_public_inputs(m.kg.bits_to_u32s(b, m.kg.keccak256_fixed(b, byte_ts)))
        data = m.build(b)
    return data, _witness(data, lambda inputs: m.kg.set_bytes(inputs, byte_ts, msg))


def _packed_digest_bits(d):
    bits = [(byte >> k) & 1 for byte in d for k in range(8)]
    return [sum(bit << k for k, bit in enumerate(bits[i:i + 32])) for i in range(0, 256, 32)]


# ---------------------------------------------------------------------------
# the column gadget
# ---------------------------------------------------------------------------

WORD = bytes([0xDE, 0xAD, 0xBE, 0xEF] + list(range(4, 32 - 4)) + [0xCA, 0xFE, 0x01, 0x7F])
COLUMNS = [(1, 11, 0, 0, 256, 0), (1, 12, 24, 0, 64, 0), (1, 13, 5, 3, 12, 0),
           (1, 14, 31, 7, 1, 0)]  # tests/test_column_gadget.py:20-34
COLUMN_IDS = [(11,), (12,), (13,), (14,), (11, 12, 13, 14)]


@functools.lru_cache(maxsize=None)
def _column_case(pkg, ids):
    """(circuit, witness) of the column gadget over WORD, compiled in full."""
    m = PKGS[pkg]
    b = m.B(m.cfg())
    word = m.bg.add_byte_inputs(b, 32)
    d = m.cg.column_values_digest_circuit(b, [m.col.ColumnInfo(*c) for c in COLUMNS],
                                          list(ids), word)
    b.register_public_inputs(m.curve.curve_to_pi_targets(b, d))
    data = m.build(b)
    return data, _witness(data, lambda inputs: inputs.update(zip(word, WORD)))


# ---------------------------------------------------------------------------
# the MPT node circuits over a struct slot of three words
# (tests/test_mpt_circuits.py:28-53)
# ---------------------------------------------------------------------------

STRUCT_SLOT = 3


@functools.lru_cache(maxsize=None)
def _struct_fixture(pkg):
    """A struct slot spanning 3 EVM words, one full-word column per word;
    each word is its own trie leaf at pad32(slot + w)."""
    m = PKGS[pkg]
    table = [m.col.ColumnInfo(
        slot=STRUCT_SLOT,
        identifier=m.v.identifier_for_value_column(STRUCT_SLOT, 0, 256, w, ADDR, CHAIN_ID),
        byte_offset=0, bit_offset=0, length=256, evm_word=w) for w in range(3)]
    t = m.trie.MPT(secure=True)
    locs = []
    for w in range(3):
        loc = m.sk.simple_slot_location(STRUCT_SLOT, evm_word=w)
        t.insert(loc, m.rlp.encode_int(10**18 + w + 1))  # hash-referenced leaves
        locs.append(loc)
    return table, table[0].identifier, t, locs


def _leaf_single_pis(pkg, body, key_nibs):
    m = PKGS[pkg]
    table, value_id, _, _ = _struct_fixture(pkg)
    value = m.u256.left_pad32(m.rlp.decode(m.rlp.decode(body)[1]))
    dv = m.v.compute_leaf_single_values_digest(table, [value_id], value)
    dm = m.v.compute_leaf_single_metadata_digest(table)
    return m.mpt.mpt_pi_values(m.keccak.keccak256(body), dv, dm, 1, key_nibs,
                               m.mpt.host_leaf_s(body))


@functools.lru_cache(maxsize=None)
def _leaf_single_circuit(pkg):
    m = PKGS[pkg]
    table, value_id, _, _ = _struct_fixture(pkg)
    kw = {"device": "cpu"} if pkg == "port" else {}
    with collector_paused():
        return m.mpt.build_leaf_single_circuit(table, value_id, **kw)


@functools.lru_cache(maxsize=None)
def _leaf_single_case(pkg):
    """(circuit, witness) of leaf_single over the struct's first word."""
    mc = _leaf_single_circuit(pkg)
    _, _, t, locs = _struct_fixture(pkg)
    body = t.get_proof(locs[0])[-1]
    key_nibs = PKGS[pkg].mpt.host_key_nibbles(locs[0])
    return mc.data, _witness(mc.data, lambda inputs: mc.assign(inputs, body, key_nibs))


@functools.lru_cache(maxsize=None)
def _branch_inputs(pkg):
    """The struct trie's root branch over two of its leaves: the body, the
    children's PIs (as their leaf proofs expose them), their slots, keys."""
    m = PKGS[pkg]
    _, _, t, locs = _struct_fixture(pkg)
    proofs = [t.get_proof(loc) for loc in locs]
    branch_body = proofs[0][0]
    kids = [(pr[1], m.mpt.host_key_nibbles(loc)) for loc, pr in zip(locs, proofs)
            if len(pr) >= 2 and pr[0] == branch_body][:2]
    assert len(kids) == 2, "the fixture shares a root branch"
    items = m.rlp.decode(branch_body)
    child_pis = [_leaf_single_pis(pkg, body, key) for body, key in kids]
    slots = [next(i for i, it in enumerate(items) if it == m.keccak.keccak256(body))
             for body, _ in kids]
    return branch_body, child_pis, slots, kids[0][1]


@functools.lru_cache(maxsize=None)
def _branch_circuit(pkg):
    m = PKGS[pkg]
    with collector_paused():
        b = m.B(m.cfg())
        stubs = [_Stub(b, m.mpt.NUM_MPT_PIS) for _ in range(2)]
        assign = m.mpt.build_branch_circuit(2, None, max_len=272)(b, [s.ts for s in stubs])
        return m.build(b), assign, stubs


def _branch_witness(pkg, slots):
    data, assign, stubs = _branch_circuit(pkg)
    body, child_pis, _, key = _branch_inputs(pkg)

    def fill(inputs):
        assign(inputs, body, slots, key)
        for s, vals in zip(stubs, child_pis):
            s.assign(inputs, vals)

    return _witness(data, fill)


@functools.lru_cache(maxsize=None)
def _branch_case(pkg):
    """(circuit, witness) of branch2 (272 bytes) over the two leaves."""
    return _branch_circuit(pkg)[0], _branch_witness(pkg, tuple(_branch_inputs(pkg)[2]))


@functools.lru_cache(maxsize=None)
def _extension_circuit(pkg):
    m = PKGS[pkg]
    with collector_paused():
        b = m.B(m.cfg())
        stub = _Stub(b, m.mpt.NUM_MPT_PIS)
        assign = m.mpt.build_extension_circuit_body(b, stub.ts, 69)
        return m.build(b), assign, stub


def _extension_inputs(pkg, key):
    """An extension node [hex-prefix 0x00 0x01, hash of the first struct
    leaf] over that leaf's PIs with the child key `key` and S = 2
    (tests/test_mpt_circuits.py:188-228): (body, child PIs, node PIs)."""
    m = PKGS[pkg]
    table, value_id, t, locs = _struct_fixture(pkg)
    leaf = t.get_proof(locs[0])[-1]
    ext_body = m.rlp.encode([b"\x00\x01", m.keccak.keccak256(leaf)])
    value = m.u256.left_pad32(m.rlp.decode(m.rlp.decode(leaf)[1]))
    dv = m.v.compute_leaf_single_values_digest(table, [value_id], value)
    dm = m.v.compute_leaf_single_metadata_digest(table)
    child = m.mpt.mpt_pi_values(m.keccak.keccak256(leaf), dv, dm, 1, key, 2)
    want = m.mpt.mpt_pi_values(m.keccak.keccak256(ext_body), dv, dm, 1, key, 0)
    return ext_body, child, want


def _extension_witness(pkg, key):
    data, assign, stub = _extension_circuit(pkg)
    body, child, _ = _extension_inputs(pkg, key)

    def fill(inputs):
        assign(inputs, body)
        stub.assign(inputs, child)

    return _witness(data, fill)


EXTENSION_KEY = (0, 1) + (7,) * 62


@functools.lru_cache(maxsize=None)
def _extension_case(pkg):
    """(circuit, witness) of the extension over EXTENSION_KEY."""
    return _extension_circuit(pkg)[0], _extension_witness(pkg, list(EXTENSION_KEY))


# ---------------------------------------------------------------------------
# the mapping leaf (tests/test_mpt_circuits.py:321-365)
# ---------------------------------------------------------------------------

MAPPING_SLOT = 2


@functools.lru_cache(maxsize=None)
def _mapping_inputs(pkg):
    m = PKGS[pkg]
    key_id = m.v.identifier_for_mapping_key_column(MAPPING_SLOT, ADDR, CHAIN_ID)
    value_id = m.v.identifier_for_value_column(MAPPING_SLOT, 0, 256, 0, ADDR, CHAIN_ID)
    table = [m.col.simple_column(MAPPING_SLOT, value_id)]
    mkey = b"\x07"
    loc = m.sk.mapping_location(MAPPING_SLOT, mkey)
    t = m.trie.MPT(secure=True)
    t.insert(loc, m.rlp.encode_int(10**18 + 9))
    leaf = t.get_proof(loc)[-1]
    value = m.u256.left_pad32(m.rlp.decode(m.rlp.decode(leaf)[1]))
    dv = m.v.compute_leaf_mapping_values_digest(table, [value_id], value, mkey, 0, key_id)
    dm = m.v.compute_leaf_mapping_metadata_digest(table, MAPPING_SLOT, key_id)
    pis = m.mpt.mpt_pi_values(m.keccak.keccak256(leaf), dv, dm, 1,
                              m.mpt.host_key_nibbles(loc), m.mpt.host_leaf_s(leaf))
    return table, value_id, key_id, leaf, pis


@functools.lru_cache(maxsize=None)
def _mapping_circuit(pkg):
    m = PKGS[pkg]
    table, value_id, key_id, _, _ = _mapping_inputs(pkg)
    with collector_paused():
        b = m.B(m.cfg())
        assign = m.mpt.build_leaf_mapping_body(b, table, value_id, MAPPING_SLOT, key_id)
        return m.build(b), assign


def _mapping_witness(pkg, mkey):
    data, assign = _mapping_circuit(pkg)
    leaf = _mapping_inputs(pkg)[3]
    return _witness(data, lambda inputs: assign(inputs, leaf, PKGS[pkg].u256.left_pad32(mkey)))


@functools.lru_cache(maxsize=None)
def _mapping_case(pkg):
    """(circuit, witness) of leaf_mapping over the mapping key 0x07."""
    return _mapping_circuit(pkg)[0], _mapping_witness(pkg, b"\x07")


CASES = {"keccak": _keccak_case, "column": _column_case, "leaf_single": _leaf_single_case,
         "branch": _branch_case, "extension": _extension_case, "leaf_mapping": _mapping_case}


def _matches(kind, *args):
    """The port's (circuit, witness) of a case, held against the
    reference's: the circuit, then the witness."""
    data, w = CASES[kind]("port", *args)
    jdata, jw = CASES[kind]("ref", *args)
    _same_circuit(data, jdata)
    np.testing.assert_array_equal(w, jw)
    return data, w


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(KECCAK_MESSAGES))
def test_keccak256_fixed_matches_reference(case, without_fixed_commitment):
    data, w = _matches("keccak", case)
    want = _packed_digest_bits(keccak.keccak256(KECCAK_MESSAGES[case]))
    data.check_witness(w, want)
    bad = list(want)
    bad[0] ^= 1
    with pytest.raises(AssertionError):
        data.check_witness(w, bad)


@pytest.mark.parametrize("ids", COLUMN_IDS)
def test_column_digest_circuit_matches_reference(ids):
    data, w = _matches("column", ids)
    assert data.circuit_digest is not None
    cols = [columns.ColumnInfo(*c) for c in COLUMNS]
    data.check_witness(w, columns.column_values_digest(cols, list(ids), WORD).to_fields())


def test_leaf_single_circuit_matches_reference(without_fixed_commitment):
    data, w = _matches("leaf_single")
    mc = _leaf_single_circuit("port")
    table, value_id, t, locs = _struct_fixture("port")
    body = t.get_proof(locs[0])[-1]
    key_nibs = mpt.host_key_nibbles(locs[0])
    pis = _leaf_single_pis("port", body, key_nibs)
    assert pis == _leaf_single_pis("ref", body, key_nibs)
    data.check_witness(w, pis)

    # a forged value digest fails
    bad = mpt.mpt_pi_values(
        keccak.keccak256(body),
        values.compute_leaf_single_values_digest(table, [value_id], u256.left_pad32(b"\x01")),
        values.compute_leaf_single_metadata_digest(table), 1, key_nibs, pis[95])
    with pytest.raises(AssertionError):
        data.check_witness(w, bad)
    # the key is baked to this word's location: another word's leaf fails
    other = t.get_proof(locs[1])[-1]
    with pytest.raises((ValueError, AssertionError)):
        w2 = _witness(data, lambda inputs: mc.assign(inputs, other))
        data.check_witness(w2, _leaf_single_pis("port", other, key_nibs))
    # and claiming another word's key nibbles is refused up front
    with pytest.raises(AssertionError):
        mc.assign({}, other, mpt.host_key_nibbles(locs[1]))


def test_branch_circuit_matches_reference(without_fixed_commitment):
    data, w = _matches("branch")
    body, child_pis, slots, key = _branch_inputs("port")
    assert _branch_inputs("ref") == _branch_inputs("port")
    dv = Point.from_fields(child_pis[0][8:19]) + Point.from_fields(child_pis[1][8:19])
    want = mpt.mpt_pi_values(keccak.keccak256(body), dv,
                             Point.from_fields(child_pis[0][19:30]), 2, key,
                             child_pis[0][95] - 1)
    data.check_witness(w, want)
    # swapping the two slot witnesses breaks the key-nibble consumption
    with pytest.raises((ValueError, AssertionError)):
        data.check_witness(_branch_witness("port", slots[::-1]), want)


def test_extension_circuit_matches_reference(without_fixed_commitment):
    data, w = _matches("extension")
    key = list(EXTENSION_KEY)
    assert _extension_inputs("port", key) == _extension_inputs("ref", key)
    data.check_witness(w, _extension_inputs("port", key)[2])
    # a path that disagrees with the child's key segment fails
    bad_key = [5, 5] + [7] * 62
    with pytest.raises((ValueError, AssertionError)):
        data.check_witness(_extension_witness("port", bad_key),
                           _extension_inputs("port", bad_key)[2])


def test_leaf_mapping_circuit_matches_reference(without_fixed_commitment):
    data, w = _matches("leaf_mapping")
    assert data.n == 1 << 16
    pis = _mapping_inputs("port")[4]
    assert pis == _mapping_inputs("ref")[4]
    data.check_witness(w, pis)
    # another witnessed mapping key derives another trie key, which cannot
    # match the leaf's compact path
    with pytest.raises((ValueError, AssertionError)):
        data.check_witness(_mapping_witness("port", b"\x08"), pis)


def test_mapping_of_mappings_set_is_not_left_out_silently():
    with pytest.raises(NotImplementedError, match="Queue 1 item 3b"):
        mpt.ValuesExtractionCircuits(
            [columns.simple_column(5, 1)], 1, mapping_of_mappings=(5, 2, 3), device="cpu")


# ---------------------------------------------------------------------------
# the recursive set over block 101's trie (MP2_SLOW)
# ---------------------------------------------------------------------------

slow = pytest.mark.skipif(not os.environ.get("MP2_SLOW"),
                          reason="set MP2_SLOW=1 for prove-heavy tests")
PIPELINE_SLOT = 4
PIPELINE_ENTRIES = {b"\x11": 150, b"\x22": 200, b"\x33": 50}  # block 101


def _prove_pipeline_trie(pkg):
    """prove_trie over block 101's storage trie (mp2_tpu/models/pipeline.py:
    148-156) with the set of mp2_tpu/models/circuit_pipeline.py:132-136."""
    m = PKGS[pkg]
    key_id = m.v.identifier_for_mapping_key_column(PIPELINE_SLOT, ADDR, CHAIN_ID)
    value_id = m.v.identifier_for_value_column(PIPELINE_SLOT, 0, 256, 0, ADDR, CHAIN_ID)
    t = m.trie.MPT(secure=True)
    for k, v in PIPELINE_ENTRIES.items():
        t.insert(m.sk.mapping_location(PIPELINE_SLOT, k), m.rlp.encode_int(v))
    t.insert(m.keccak.keccak256(b"unrelated"), m.rlp.encode_int(7))
    kw = {"device": "cpu"} if pkg == "port" else {}
    vx = m.mpt.ValuesExtractionCircuits(
        [m.col.simple_column(PIPELINE_SLOT, value_id)], value_id,
        config=m.cfg(), mapping=(PIPELINE_SLOT, key_id), branch_arities=(1, 2, 3), **kw)
    paths = {k: t.get_proof(m.sk.mapping_location(PIPELINE_SLOT, k))
             for k in sorted(PIPELINE_ENTRIES)}
    env, pis = vx.prove_trie(paths, {k: k for k in paths})
    assert vx.verify(env)
    return vx, env, pis


@slow
def test_prove_trie_root_envelope_matches_reference():
    from mp2_tpu.prover.serde import proof_to_dict as jproof_to_dict
    from mp2_tpu_torch.prover.serde import proof_sha256, proof_to_dict

    vx, env, pis = _prove_pipeline_trie("port")
    jvx, jenv, jpis = _prove_pipeline_trie("ref")
    assert vx.fw.set_digest == jvx.fw.set_digest
    assert pis == jpis and pis[30] == 3 and pis[95] == 0
    assert env.public_inputs == jenv.public_inputs
    assert proof_sha256(proof_to_dict(env.proof)) == proof_sha256(jproof_to_dict(jenv.proof))
