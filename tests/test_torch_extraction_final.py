"""The port's block, contract and final extraction against mp2_tpu on the CPU.

The host models (`extract_block`, `extract_contract`, `extract_length`,
`final_extraction`, `final_extraction_lengthed`), `fixture_header_offsets`,
the host PI functions of `final_circuits` and every function of
`metadata.py` must give the reference's outputs on the `world` fixture of
tests/test_final_extraction.py:70-104 (a two-account state trie over a
struct slot of three words), on blocks 100 and 101 of the pipeline
(mp2_tpu/models/pipeline.py:139-182) and on the table configs of
tests/test_metadata_api.py, each built with its own package's trie.  The
bodies of the contract set (`build_account_leaf_body`,
`build_contract_branch_body`), `final_base_body` and the header circuit
(`build_block_extraction_circuit`) are built in both packages, once per
module: the circuits and witnesses must be equal and pass `check_witness`
against the public inputs of each package's host functions, and the forged
inputs of tests/test_final_extraction.py:107-254 and
tests/test_extraction_circuits.py:33-55 must be refused (the other
account's leaf, a forged values root or walk and a tampered state root in
both packages, a forged branch child in the port's).  Block
101's host outputs equal `testdata/final_extraction_golden.json`, which
the JAX package wrote.  The tolerance is 0 everywhere: the outputs are
canonical field values, digests and byte strings; curve points are
compared by their field encodings.

The bodies are compiled without the fixed commitment, as in
tests/test_torch_extraction_circuits.py, and the inputs of the commitment
compared.  No test here proves a circuit outside MP2_SLOW.
"""

import dataclasses
import functools
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import mp2_tpu.circuit.builder as jbuilder
import mp2_tpu.circuit.gadgets.keccak as jkeccak_gadget
import mp2_tpu.extraction.api as japi
import mp2_tpu.extraction.circuits as jcircuits
import mp2_tpu.extraction.columns as jcolumns
import mp2_tpu.extraction.final_circuits as jfinal
import mp2_tpu.extraction.metadata as jmetadata
import mp2_tpu.extraction.mpt_circuits as jmpt
import mp2_tpu.extraction.storage_key as jsk
import mp2_tpu.extraction.values as jvalues
import mp2_tpu.hash.poseidon2_host as jp2h
import mp2_tpu.prover.config as jconfig
import mp2_tpu.prover.prove as jprove
import mp2_tpu.utils.keccak as jkeccak
import mp2_tpu.utils.rlp as jrlp
import mp2_tpu.utils.trie as jtrie
import mp2_tpu.utils.u256 as ju256
import mp2_tpu.vdb.digests as jdigests
import mp2_tpu_torch.circuit.builder as builder
import mp2_tpu_torch.circuit.gadgets.keccak as keccak_gadget
import mp2_tpu_torch.extraction.api as api
import mp2_tpu_torch.extraction.circuits as circuits
import mp2_tpu_torch.extraction.columns as columns
import mp2_tpu_torch.extraction.final_circuits as final
import mp2_tpu_torch.extraction.metadata as metadata
import mp2_tpu_torch.extraction.mpt_circuits as mpt
import mp2_tpu_torch.extraction.storage_key as sk
import mp2_tpu_torch.extraction.values as values
import mp2_tpu_torch.hash.poseidon2_host as p2h
import mp2_tpu_torch.prover.config as config
import mp2_tpu_torch.prover.prove as prove
import mp2_tpu_torch.utils.keccak as keccak
import mp2_tpu_torch.utils.rlp as rlp
import mp2_tpu_torch.utils.trie as trie
import mp2_tpu_torch.utils.u256 as u256
import mp2_tpu_torch.vdb.digests as digests
from mp2_tpu_torch.utils import collector_paused

PKGS = {
    "port": SimpleNamespace(
        B=builder.CircuitBuilder, cfg=config.test_config, kg=keccak_gadget, api=api,
        circ=circuits, col=columns, fin=final, md=metadata, mpt=mpt, sk=sk, v=values,
        p2h=p2h, keccak=keccak, rlp=rlp, trie=trie, u256=u256, D=digests,
        build=lambda b: b.build("cpu"), device={"device": "cpu"}),
    "ref": SimpleNamespace(
        B=jbuilder.CircuitBuilder, cfg=jconfig.test_config, kg=jkeccak_gadget, api=japi,
        circ=jcircuits, col=jcolumns, fin=jfinal, md=jmetadata, mpt=jmpt, sk=jsk,
        v=jvalues, p2h=jp2h, keccak=jkeccak, rlp=jrlp, trie=jtrie, u256=ju256,
        D=jdigests, build=lambda b: b.build(), device={}),
}
ADDR = bytes(range(20))
OTHER = bytes(range(1, 21))
CHAIN_ID = 1
STRUCT_SLOT = 3  # the world's struct slot (tests/test_final_extraction.py:46)
PIPELINE_SLOT = 4  # the pipeline's mapping slot (chip_smoke.py's table)
PIPELINE_BLOCKS = ({b"\x11": 100, b"\x22": 200},
                   {b"\x11": 150, b"\x22": 200, b"\x33": 50})
LENGTH_SLOT = 9  # a length slot added to block 101's storage for the lengthed model
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "mp2_tpu_torch", "testdata", "final_extraction_golden.json")


def _plain(x):
    """A host output as plain data: dataclasses as dicts, points as their
    field encodings, bytes as hex."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if hasattr(x, "to_fields"):
        return [int(v) for v in x.to_fields()]
    if isinstance(x, bytes):
        return x.hex()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# the fixtures, built with each package's own trie
# ---------------------------------------------------------------------------


def _account(m, storage_root):
    return m.rlp.encode([b"\x01", b"\x00", storage_root, m.keccak.keccak256(b"code")])


def _header(m, state_root, number, parent):
    return m.rlp.encode([parent, m.keccak.keccak256(b"uncles"), bytes(20), state_root,
                         m.keccak.keccak256(b"tx"), m.keccak.keccak256(b"rc"), b"\x00" * 32,
                         b"\x01", number.to_bytes(4, "big")])


@functools.lru_cache(maxsize=None)
def _world(pkg):
    """tests/test_final_extraction.py:70-104: a struct slot of three words
    in ADDR's storage trie, inside a two-account state trie, under a
    header of block 777."""
    m = PKGS[pkg]
    table = [m.col.ColumnInfo(
        slot=STRUCT_SLOT,
        identifier=m.v.identifier_for_value_column(STRUCT_SLOT, 0, 256, w, ADDR, CHAIN_ID),
        byte_offset=0, bit_offset=0, length=256, evm_word=w) for w in range(3)]
    storage = m.trie.MPT(secure=True)
    entries = []
    for w in range(3):
        loc = m.sk.simple_slot_location(STRUCT_SLOT, evm_word=w)
        storage.insert(loc, m.rlp.encode_int(10**18 + w + 1))
        entries.append(m.api.SlotEntry(STRUCT_SLOT, loc, evm_word=w))
    state = m.trie.MPT(secure=True)
    state.insert(ADDR, _account(m, storage.root_hash()))
    state.insert(OTHER, _account(m, m.keccak.keccak256(b"other-storage")))
    header = _header(m, state.root_hash(), 777, m.keccak.keccak256(b"parent"))
    return SimpleNamespace(table=table, storage=storage, entries=entries, state=state,
                           header=header, number=777)


@functools.lru_cache(maxsize=None)
def _pipeline(pkg):
    """Blocks 100 and 101 as mp2_tpu/models/pipeline.py:139-182 builds them
    for the mapping table (ADDR, chain 1, slot 4): each block's storage trie
    with the unrelated leaf, a one-account state trie, the RLP header over
    the parent's keccak."""
    m = PKGS[pkg]
    key_id = m.v.identifier_for_mapping_key_column(PIPELINE_SLOT, ADDR, CHAIN_ID)
    value_id = m.v.identifier_for_value_column(PIPELINE_SLOT, 0, 256, 0, ADDR, CHAIN_ID)
    table = [m.col.simple_column(PIPELINE_SLOT, value_id)]
    blocks, parent = [], m.keccak.keccak256(b"genesis")
    for number, mapping in enumerate(PIPELINE_BLOCKS, start=100):
        storage = m.trie.MPT(secure=True)
        for k, v in mapping.items():
            storage.insert(m.sk.mapping_location(PIPELINE_SLOT, k), m.rlp.encode_int(v))
        storage.insert(m.keccak.keccak256(b"unrelated"), m.rlp.encode_int(7))
        state = m.trie.MPT(secure=True)
        state.insert(ADDR, _account(m, storage.root_hash()))
        header = _header(m, state.root_hash(), number, parent)
        entries = [m.api.SlotEntry(PIPELINE_SLOT, m.sk.mapping_location(PIPELINE_SLOT, k),
                                   mapping_key=k, key_id=key_id) for k in sorted(mapping)]
        blocks.append(SimpleNamespace(table=table, storage=storage, entries=entries,
                                      state=state, header=header, number=number))
        parent = m.keccak.keccak256(header)
    return blocks


FIXTURES = {"world": lambda pkg: _world(pkg), "block100": lambda pkg: _pipeline(pkg)[0],
            "block101": lambda pkg: _pipeline(pkg)[1]}


@functools.lru_cache(maxsize=None)
def _host(pkg, fixture):
    """The host models over one fixture: block, contract, values, final."""
    m, fx = PKGS[pkg], FIXTURES[fixture](pkg)
    block = m.api.extract_block(fx.header)
    contract = m.api.extract_contract(fx.state, ADDR)
    vals = m.api.extract_storage_slots(fx.storage, fx.table, fx.entries)
    fin = m.api.final_extraction(block, contract, vals, fx.storage.root_hash(),
                                 fx.state.root_hash())
    return SimpleNamespace(block=block, contract=contract, values=vals, final=fin)


def _block_pis(m, block):
    return (m.u256.pack_bytes_be(block.block_hash) + m.u256.pack_bytes_be(block.parent_hash)
            + m.u256.pack_bytes_be(block.state_root) + [block.block_number])


# ---------------------------------------------------------------------------
# the host models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_host_models_match_reference(fixture):
    got, want = _host("port", fixture), _host("ref", fixture)
    for part in ("block", "contract", "values", "final"):
        assert _plain(getattr(got, part)) == _plain(getattr(want, part)), part
    fx = FIXTURES[fixture]("port")
    assert got.block.block_number == fx.number
    assert got.contract.storage_root == fx.storage.root_hash()
    assert got.final.values_digest.to_fields() == got.values.values_digest.to_fields()
    assert got.final.metadata_digest.to_fields() == (
        got.values.metadata_digest + got.contract.metadata_digest).to_fields()
    # the join refuses a storage root that is not the contract's
    for pkg in PKGS:
        m, h = PKGS[pkg], _host(pkg, fixture)
        fxp = FIXTURES[fixture](pkg)
        with pytest.raises(AssertionError):
            m.api.final_extraction(h.block, h.contract, h.values,
                                   m.keccak.keccak256(b"another root"),
                                   fxp.state.root_hash())


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_fixture_header_offsets_match_reference(fixture):
    header = FIXTURES[fixture]("port").header
    assert header == FIXTURES[fixture]("ref").header
    offs = circuits.fixture_header_offsets(header)
    assert offs == jcircuits.fixture_header_offsets(header)
    assert int.from_bytes(header[offs["number_offset"]:offs["number_offset"]
                                 + offs["number_len"]], "big") == FIXTURES[fixture]("port").number


@functools.lru_cache(maxsize=None)
def _lengthed(pkg):
    """Block 101's storage with a length slot holding the number of mapping
    entries: the length and lengthed-final models over it, and the same
    with a length one too many (which must be refused)."""
    m = PKGS[pkg]
    blk = _pipeline(pkg)[1]
    storage = m.trie.MPT(secure=True)
    for k, v in PIPELINE_BLOCKS[1].items():
        storage.insert(m.sk.mapping_location(PIPELINE_SLOT, k), m.rlp.encode_int(v))
    storage.insert(m.keccak.keccak256(b"unrelated"), m.rlp.encode_int(7))
    loc = m.sk.simple_slot_location(LENGTH_SLOT)
    storage.insert(loc, m.rlp.encode_int(len(PIPELINE_BLOCKS[1])))
    state = m.trie.MPT(secure=True)
    state.insert(ADDR, _account(m, storage.root_hash()))
    header = _header(m, state.root_hash(), 101, m.keccak.keccak256(_pipeline(pkg)[0].header))
    block = m.api.extract_block(header)
    contract = m.api.extract_contract(state, ADDR)
    vals = m.api.extract_storage_slots(storage, blk.table, blk.entries)
    length = m.api.extract_length(storage, LENGTH_SLOT, loc, PIPELINE_SLOT)
    fin = m.api.final_extraction_lengthed(block, contract, vals, length,
                                          storage.root_hash(), state.root_hash())
    short = dataclasses.replace(length, length=length.length + 1)
    with pytest.raises(AssertionError, match="incomplete extraction"):
        m.api.final_extraction_lengthed(block, contract, vals, short, storage.root_hash(),
                                        state.root_hash())
    return length, fin


def test_length_and_lengthed_final_match_reference():
    (length, fin), (jlength, jfin) = _lengthed("port"), _lengthed("ref")
    assert _plain(length) == _plain(jlength)
    assert _plain(fin) == _plain(jfin)
    assert length.length == len(PIPELINE_BLOCKS[1])
    # the world's storage: the struct's first word read as a length slot
    outs = [_plain(m.api.extract_length(_world(pkg).storage, STRUCT_SLOT,
                                        m.sk.simple_slot_location(STRUCT_SLOT), 2))
            for pkg, m in PKGS.items()]
    assert outs[0] == outs[1] and outs[0]["length"] == 10**18 + 1


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_final_pi_values_match_reference(fixture):
    """final_pi_values and final_merge_pi_values (both multipliers) and
    no_provable_metadata_digest over the fixture's host outputs."""
    outs = {}
    for pkg, m in PKGS.items():
        h = _host(pkg, fixture)
        bp = _block_pis(m, h.block)
        vp = m.mpt.mpt_pi_values(h.values.node_hash, h.values.values_digest,
                                 h.values.metadata_digest, h.values.n_leaves, [7] * 64, 0)
        other = m.mpt.mpt_pi_values(h.values.node_hash, m.p2h.map_to_curve_point([42]),
                                    m.p2h.map_to_curve_point([123]), 3, [7] * 64, 0)
        fin = m.fin.final_pi_values(bp, vp, h.contract.metadata_digest)
        outs[pkg] = [fin,
                     m.fin.final_pi_values(bp, vp, h.contract.metadata_digest,
                                           length_dm=m.p2h.map_to_curve_point([5])),
                     m.fin.final_merge_pi_values(bp, vp, other, h.contract.metadata_digest,
                                                 True),
                     m.fin.final_merge_pi_values(bp, vp, other, h.contract.metadata_digest,
                                                 False),
                     m.fin.no_provable_metadata_digest(h.contract.metadata_digest).to_fields()]
    assert outs["port"] == outs["ref"]
    fin, h = outs["port"][0], _host("port", fixture)
    assert len(fin) == final.NUM_FINAL_PIS
    assert fin[final.F_BN] == h.final.block_number and fin[final.F_N] == h.values.n_leaves
    assert fin[final.F_DV] == h.final.values_digest.to_fields()
    assert fin[final.F_DM] == h.final.metadata_digest.to_fields()


# ---------------------------------------------------------------------------
# metadata.py on the tables of tests/test_metadata_api.py
# ---------------------------------------------------------------------------


def _metadata_outputs(pkg):
    m = PKGS[pkg]
    md, si = m.md, m.md.SlotInput
    tables = {
        "simple": md.SlotInputs.simple([si(3), si(4, 0, 128, 1)]),
        "mapping": md.SlotInputs.mapping([si(3)]),
        "mapping_two_columns": md.SlotInputs.mapping([si(3), si(3, 16, 64, 0)]),
        "mapping_of_mappings": md.SlotInputs.mapping_of_mappings([si(6)]),
        "mapping_with_length": md.SlotInputs.mapping_with_length([si(3)], 8),
    }
    out = {"table_info": _plain(md.compute_table_info([si(3), si(4, 0, 128, 1)], ADDR, 1)),
           "table_info_extra": _plain(md.compute_table_info([si(5, 8, 32, 2)], OTHER, 7,
                                                            b"extra")),
           "contract": _plain(md.contract_metadata_digest(ADDR)),
           "merge": list(md.merge_metadata_hash(ADDR, 1, b"", tables["mapping"],
                                                md.SlotInputs.simple([si(5)]))),
           "merge_extra": list(md.merge_metadata_hash(OTHER, 7, b"x", tables["simple"],
                                                      tables["mapping"])),
           "no_provable_digest": _plain(md.no_provable_metadata_digest([9, 5, 2, 2])),
           "no_provable": list(md.no_provable_metadata_hash([5, 2, 9])),
           "no_provable_data": list(md.no_provable_metadata_hash([5, 2, 9], True)),
           "prefix": md.DUMMY_METADATA_DIGEST_PREFIX.hex()}
    for name, t in tables.items():
        out[name] = list(md.metadata_hash(t, ADDR, 1))
        out[name + "_extra"] = list(md.metadata_hash(t, OTHER, 7, b"extra"))
    return out


def test_metadata_matches_reference():
    got = _metadata_outputs("port")
    assert got == _metadata_outputs("ref")
    # tests/test_metadata_api.py:37-58: the merged table's hash from its
    # column identifiers; the mapping table's from the values and contract
    # digests; order-free no-provable hashes
    key_id = values.identifier_for_mapping_key_column(3, ADDR, 1)
    value_id = values.identifier_for_value_column(3, 0, 256, 0, ADDR, 1)
    supply_id = values.identifier_for_value_column(5, 0, 256, 0, ADDR, 1)
    dm_a = values.compute_leaf_mapping_metadata_digest(
        [columns.simple_column(3, value_id)], 3, key_id)
    dm_b = values.compute_leaf_single_metadata_digest([columns.simple_column(5, supply_id)])
    contract = metadata.contract_metadata_digest(ADDR)
    block_id = values.identifier_block_column()
    assert got["merge"] == list(digests.block_metadata_hash(dm_a + dm_b + contract, block_id))
    assert got["mapping"] == list(digests.block_metadata_hash(dm_a + contract, block_id))
    assert metadata.no_provable_metadata_hash([9, 5, 2, 2]) == tuple(got["no_provable"])
    assert got["no_provable"] != list(metadata.no_provable_metadata_hash([5, 2, 8]))
    assert metadata.DUMMY_METADATA_DIGEST_PREFIX == final.DUMMY_METADATA_DIGEST_PREFIX


# ---------------------------------------------------------------------------
# the golden record of block 101
# ---------------------------------------------------------------------------


def test_block_101_host_outputs_match_golden():
    with open(GOLDEN) as f:
        g = json.load(f)["host"]
    h, blk = _host("port", "block101"), _pipeline("port")[1]
    assert blk.header.hex() == g["header_rlp"]
    assert circuits.fixture_header_offsets(blk.header) == g["header_offsets"]
    assert _plain(h.block) == g["extract_block"]
    assert _plain(h.contract) == g["extract_contract"]
    assert _plain(h.final) == g["final_extraction"]
    vp = mpt.mpt_pi_values(h.values.node_hash, h.values.values_digest,
                           h.values.metadata_digest, h.values.n_leaves)
    assert final.final_pi_values(_block_pis(PKGS["port"], h.block), vp,
                                 h.contract.metadata_digest) == g["final_public_inputs"]
    table = metadata.SlotInputs.mapping([metadata.SlotInput(PIPELINE_SLOT)])
    md_hash = digests.block_metadata_hash(h.final.metadata_digest, g["table"]["block_id"])
    assert list(md_hash) == g["metadata_hash"]
    assert list(metadata.metadata_hash(table, ADDR, CHAIN_ID)) == g["metadata_hash"]


# ---------------------------------------------------------------------------
# the bodies, built once per package
# ---------------------------------------------------------------------------


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


def _witness(data, fill):
    inputs = {}
    fill(inputs)
    with collector_paused():
        return data.generate_witness(inputs)


def _refused(data, fill, pis):
    """The witness of `fill` fails to generate or to check against `pis`."""
    with pytest.raises((ValueError, AssertionError)):
        data.check_witness(_witness(data, fill), pis)


def _stubbed(pkg, body, widths, *args):
    """A body over child PIs given as plain witness inputs: (circuit,
    assign, the stubs' targets)."""
    m = PKGS[pkg]
    with collector_paused():
        b = m.B(m.cfg())
        stubs = [b.add_inputs(w) for w in widths]
        assign = body(m, b, stubs, *args)
        return m.build(b), assign, stubs


def _fill(assign, node, stubs, vals):
    def fill(inputs):
        if assign is not None:
            assign(inputs, node)
        for ts, vs in zip(stubs, vals):
            inputs.update((t, int(v)) for t, v in zip(ts, vs))

    return fill


def _contract_pis(pkg, leaf, key=None, s_delta=0, node=None):
    """contract_pi_values of the world's account leaf (or of `node` above
    it, with S lowered by `s_delta`)."""
    m = PKGS[pkg]
    items = m.rlp.decode(leaf)
    storage_root = m.rlp.decode(items[1])[2]
    s = m.mpt.MAX_KEY_NIBBLES - len(m.mpt.compact_nibbles(items[0])) - s_delta
    dm = m.p2h.map_to_curve_point(m.u256.pack_bytes_be(ADDR))
    key = m.fin.host_key_nibbles(ADDR) if key is None else key
    return m.fin.contract_pi_values(m.keccak.keccak256(node or leaf), storage_root, dm,
                                    key, s)


@functools.lru_cache(maxsize=None)
def _account_leaf(pkg):
    return _stubbed(pkg, lambda m, b, _: m.fin.build_account_leaf_body(b, ADDR), [])


@functools.lru_cache(maxsize=None)
def _account_leaf_case(pkg):
    data, assign, _ = _account_leaf(pkg)
    leaf = _world(pkg).state.get_proof(ADDR)[-1]
    return data, _witness(data, lambda inputs: assign(inputs, leaf))


@functools.lru_cache(maxsize=None)
def _branch(pkg):
    return _stubbed(pkg, lambda m, b, st: m.fin.build_contract_branch_body(b, st[0], 272),
                    [final.NUM_CONTRACT_PIS])


def _branch_inputs(pkg, key=None):
    """The world's state branch over ADDR's leaf: (branch body, child PIs,
    branch PIs), the child claiming `key`."""
    branch, leaf = _world(pkg).state.get_proof(ADDR)
    child = _contract_pis(pkg, leaf, key)
    return branch, child, _contract_pis(pkg, leaf, key, 1, branch)


@functools.lru_cache(maxsize=None)
def _branch_case(pkg):
    data, assign, stubs = _branch(pkg)
    branch, child, _ = _branch_inputs(pkg)
    return data, _witness(data, _fill(assign, branch, stubs, [child]))


def _stub_final_pis(pkg):
    """Consistent (block, contract, values) PI triples over the world
    (tests/test_final_extraction.py:171-195) and the contract digest."""
    m, w = PKGS[pkg], _world(pkg)
    dm_c = m.p2h.map_to_curve_point(m.u256.pack_bytes_be(ADDR))
    contract = m.fin.contract_pi_values(w.state.root_hash(), w.storage.root_hash(), dm_c,
                                        m.fin.host_key_nibbles(ADDR), 0)
    vals = m.mpt.mpt_pi_values(w.storage.root_hash(), m.p2h.map_to_curve_point([42]),
                               m.p2h.map_to_curve_point([123]), 3, [7] * 64, 0)
    return _block_pis(m, m.api.extract_block(w.header)), contract, vals, dm_c


@functools.lru_cache(maxsize=None)
def _final_base(pkg):
    return _stubbed(pkg, lambda m, b, st: m.fin.final_base_body(b, *st),
                    [final.NUM_BLOCK_PIS, final.NUM_CONTRACT_PIS, mpt.NUM_MPT_PIS])


@functools.lru_cache(maxsize=None)
def _final_base_case(pkg):
    data, _, stubs = _final_base(pkg)
    return data, _witness(data, _fill(None, None, stubs, _stub_final_pis(pkg)[:3]))


@functools.lru_cache(maxsize=None)
def _header_circuit(pkg):
    m, header = PKGS[pkg], _world(pkg).header
    with collector_paused():
        return m.circ.build_block_extraction_circuit(**m.circ.fixture_header_offsets(header),
                                                     **m.device)


@functools.lru_cache(maxsize=None)
def _header_case(pkg):
    bc, m = _header_circuit(pkg), PKGS[pkg]
    header = _world(pkg).header
    return bc.data, _witness(bc.data, lambda inputs: m.kg.set_bytes(inputs, bc.header_targets,
                                                                      header))


CASES = {"account_leaf": _account_leaf_case, "contract_branch": _branch_case,
         "final_base": _final_base_case, "block_header": _header_case}


def _matches(kind):
    data, w = CASES[kind]("port")
    jdata, jw = CASES[kind]("ref")
    _same_circuit(data, jdata)
    np.testing.assert_array_equal(w, jw)
    return data, w


def test_account_leaf_body_matches_reference(without_fixed_commitment):
    """tests/test_final_extraction.py:107-137 in both packages."""
    data, w = _matches("account_leaf")
    assert data.n == 1 << 15
    leaf = _world("port").state.get_proof(ADDR)[-1]
    pis = _contract_pis("port", leaf)
    assert pis == _contract_pis("ref", leaf) and len(pis) == final.NUM_CONTRACT_PIS
    data.check_witness(w, pis)
    # another account's leaf cannot satisfy the baked key constants, in
    # either package
    for pkg in PKGS:
        m = PKGS[pkg]
        pdata, assign, _ = _account_leaf(pkg)
        other = _world(pkg).state.get_proof(OTHER)[-1]
        items = m.rlp.decode(other)
        bad = m.fin.contract_pi_values(
            m.keccak.keccak256(other), m.rlp.decode(items[1])[2],
            m.p2h.map_to_curve_point(m.u256.pack_bytes_be(ADDR)), m.fin.host_key_nibbles(ADDR),
            m.mpt.MAX_KEY_NIBBLES - len(m.mpt.compact_nibbles(items[0])))
        _refused(pdata, lambda inputs: assign(inputs, other), bad)


def test_contract_branch_body_matches_reference(without_fixed_commitment):
    """tests/test_final_extraction.py:140-210 in both packages."""
    data, w = _matches("contract_branch")
    assert data.n == 1 << 16
    branch, child, want = _branch_inputs("port")
    assert (branch, child, want) == _branch_inputs("ref")
    data.check_witness(w, want)
    # a child claiming another consumed nibble cannot match the node
    _, assign, stubs = _branch("port")
    key = list(final.host_key_nibbles(ADDR))
    s = child[final._C_S]
    key[s - 1] = (key[s - 1] + 1) % 16
    branch, bad_child, bad = _branch_inputs("port", key)
    _refused(data, _fill(assign, branch, stubs, [bad_child]), bad)


def test_final_base_body_matches_reference(without_fixed_commitment):
    """tests/test_final_extraction.py:212-254 in both packages."""
    data, w = _matches("final_base")
    block, contract, vals, dm_c = _stub_final_pis("port")
    assert (block, contract, vals) == _stub_final_pis("ref")[:3]
    want = final.final_pi_values(block, vals, dm_c)
    assert want[final.F_BN] == 777 and want[final.F_N] == 3
    data.check_witness(w, want)
    for pkg in PKGS:
        m = PKGS[pkg]
        pdata, _, stubs = _final_base(pkg)
        block, contract, vals, dm_c = _stub_final_pis(pkg)
        # a values root that is not the account's storage root, then an
        # unfinished values walk (S != 0)
        for index, value in ((0, vals[0] ^ 1), (95, 2)):
            bad = list(vals)
            bad[index] = value
            _refused(pdata, _fill(None, None, stubs, [block, contract, bad]),
                     m.fin.final_pi_values(block, bad, dm_c))


def test_block_extraction_circuit_matches_reference(without_fixed_commitment):
    """tests/test_extraction_circuits.py:33-55 on the world's header, in
    both packages, without its proof."""
    data, w = _matches("block_header")
    header = _world("port").header
    want = _header_circuit("port").expected_public_inputs(header)
    assert want == _header_circuit("ref").expected_public_inputs(header)
    assert want[:8] == u256.pack_bytes_be(keccak.keccak256(header))
    assert want[-1] == 777
    data.check_witness(w, want)
    for pkg in PKGS:
        bad = list(want)
        bad[16] = (bad[16] + 1) % ((1 << 64) - (1 << 32) + 1)  # a tampered state root
        with pytest.raises(AssertionError):
            CASES["block_header"](pkg)[0].check_witness(CASES["block_header"](pkg)[1], bad)


class _SetRecorder:
    """Stands for RecursionFramework in final_circuits: records the set's
    height and each member's name, children and foreign sets; builds
    nothing."""

    def __init__(self, config, num_user_pis, set_height, device):
        self.set_height, self.members = set_height, []

    def add_aggregation_circuit(self, name, n_children, build_fn, foreign=()):
        self.members.append((name, n_children, [fw.name for fw in foreign]))

    def finalize(self):
        pass


@pytest.mark.parametrize("option", [{"length": object()}, {"merge": True},
                                    {"merge_with": "values_b"}, {"no_provable": True}],
                         ids=["length", "merge", "merge_with", "no_provable"])
def test_unported_final_members_are_not_left_out_silently(option, monkeypatch):
    """`length=` and `no_provable=` raise, naming ROADMAP Queue 1 items 3b.3
    and 3b.4; `merge=` and `merge_with=` (item 3b.2) add `final_merge`
    beside `final_simple`, over the block, contract and both values sets,
    in a set of height 1 as mp2_tpu/extraction/final_circuits.py:897-906
    sizes it."""
    if "length" in option or "no_provable" in option:
        item = "3b.3" if "length" in option else "3b.4"
        with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
            final.FinalExtractionCircuits(None, None, None, device="cpu", **option)
        return
    monkeypatch.setattr(final, "RecursionFramework", _SetRecorder)
    sets = {n: SimpleNamespace(fw=SimpleNamespace(name=n))
            for n in ("block", "contract", "values", "values_b")}
    if "merge_with" in option:
        option = {"merge_with": sets["values_b"]}
    fx = final.FinalExtractionCircuits(sets["block"], sets["contract"], sets["values"],
                                       device="cpu", **option)
    table_b = "values_b" if "merge_with" in option else "values"
    assert fx.fw.set_height == 1
    assert fx.fw.members == [("final_simple", 0, ["block", "contract", "values"]),
                             ("final_merge", 0, ["block", "contract", "values", table_b])]


# ---------------------------------------------------------------------------
# the recursive chain (MP2_SLOW)
# ---------------------------------------------------------------------------

slow = pytest.mark.skipif(not os.environ.get("MP2_SLOW"),
                          reason="set MP2_SLOW=1 for prove-heavy tests")


def _recursive_chain(pkg):
    """tests/test_final_extraction.py:256-322: two struct leaves under the
    storage root branch, the contract's state path, the header and
    final_simple over them."""
    m, w = PKGS[pkg], _world(pkg)
    value_id = w.table[0].identifier
    proofs = [w.storage.get_proof(e.location) for e in w.entries]
    root_node = proofs[0][0]
    picked = [(pr[1], e) for pr, e in zip(proofs, w.entries)
              if len(pr) == 2 and pr[0] == root_node][:2]
    assert len(picked) == 2, "the fixture shares the root branch"
    vx = m.mpt.ValuesExtractionCircuits(w.table, value_id, **m.device)
    envs, pis = [], []
    for body, e in picked:
        env, piv = vx.prove_leaf(body, m.mpt.host_key_nibbles(e.location), e.evm_word)
        envs.append(env)
        pis.append(piv)
    items = m.rlp.decode(root_node)
    slots = [next(i for i, it in enumerate(items) if it == m.keccak.keccak256(body))
             for body, _ in picked]
    values_env, _ = vx.prove_branch(root_node, envs, pis, slots)
    cx = m.fin.ContractExtractionCircuits(ADDR, **m.device)
    contract_env, _ = cx.prove_state_path(w.state.get_proof(ADDR))
    bx = m.fin.BlockExtractionFramework(**m.circ.fixture_header_offsets(w.header), **m.device)
    block_env, _ = bx.prove_header(w.header)
    fx = m.fin.FinalExtractionCircuits(bx, cx, vx, **m.device)
    final_env, final_pis = fx.prove(block_env, contract_env, values_env)
    assert cx.verify(contract_env) and bx.verify(block_env) and fx.verify(final_env)
    return [values_env, contract_env, block_env, final_env], final_pis, fx


@slow
def test_final_extraction_recursive_chain_matches_reference():
    from mp2_tpu.prover.serde import proof_to_dict as jproof_to_dict
    from mp2_tpu_torch.prover.serde import proof_sha256, proof_to_dict

    envs, pis, fx = _recursive_chain("port")
    jenvs, jpis, jfx = _recursive_chain("ref")
    assert fx.fw.set_digest == jfx.fw.set_digest
    assert pis == jpis and pis[final.F_BN] == 777 and pis[final.F_N] == 2
    for env, jenv in zip(envs, jenvs, strict=True):
        assert env.public_inputs == jenv.public_inputs
        assert proof_sha256(proof_to_dict(env.proof)) == proof_sha256(
            jproof_to_dict(jenv.proof))
