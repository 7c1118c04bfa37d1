"""Final-extraction circuit family: block + contract + values proofs bound
into ONE proof whose public inputs feed the verifiable-DB block tree.

Reference counterparts:
  * mp2-v1/src/contract_extraction/{leaf.rs, branch.rs, extension.rs} —
    the state-trie walk proving `storage_root` belongs to the contract
    account under the block's state root;
  * mp2-v1/src/block_extraction/circuit.rs — header keccak + field
    extraction (wrapped here as a one-member RecursionFramework so the
    final circuit can verify it cross-set);
  * mp2-v1/src/final_extraction/{base_circuit.rs, simple_circuit.rs} —
    verifies the three proofs in-circuit and enforces the root chaining
    (values root == contract storage_root, contract root == block
    state_root, both MPT walks fully consumed) and DM = DM_values +
    DM_contract.

PI layouts (user PIs, before the trailing set digest):
  block:    bh(8 u32) | prev_bh(8) | state_root(8) | bn(1)        = 25
  contract: H(8) | storage_root(8) | DM(11) | key(64) | S(1)      = 92

A jax-free copy of the parts of `mp2_tpu/extraction/final_circuits.py` that
a block's extraction runs (mp2_tpu/models/circuit_pipeline.py:150-171):
the PI widths and offsets, the block framework, the contract set, the host
metadata re-encoding, `final_base_body`, the host PI functions and
`FinalExtractionCircuits` with its `final_simple` member and, for a merged
table (mp2_tpu/models/circuit_pipeline.py:437-533), `build_merge_body` and
the `final_merge` member.  Only the imports change, and the three sets take
the device their circuits are compiled for and proved on (`device="cuda"`
unless the caller asks for the CPU).  The length set with its
`final_lengthed` member waits for ROADMAP Queue 1 item 3b.3 and the
no-provable body with its member for item 3b.4: `FinalExtractionCircuits`
raises on `length=` and `no_provable=` instead of leaving them out.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.bytes import (
    add_byte_inputs,
    extract_subarray,
    keccak256_variable,
    pack_u32_be,
    small_lt,
    value_at,
)
from mp2_tpu_torch.circuit.gadgets.curve import (
    curve_add,
    curve_constant,
    curve_from_pi_targets,
    curve_to_pi_targets,
)
from mp2_tpu_torch.extraction.mpt_circuits import (
    MAX_KEY_NIBBLES,
    _bits_to_u32s_be_bytes,
    _compact_key_tail,
    _decode_item,
    _decode_list_at,
    _decode_list_start,
    _enforce_key_segment,
    host_key_nibbles,
)
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.prover.config import CircuitConfig, test_config
from mp2_tpu_torch.recursion.runtime import RecursionFramework, WrappedEnvelope
from mp2_tpu_torch.utils.u256 import pack_bytes_be

NUM_BLOCK_PIS = 25
NUM_CONTRACT_PIS = 8 + 8 + 11 + MAX_KEY_NIBBLES + 1
NUM_FINAL_PIS = 8 + 8 + 1 + 11 + 11 + 1

# every extraction framework pads its user PIs to the values-set width so
# ALL layers share ONE wrapped standard shape (one discover_standard per
# config instead of one per PI width — large build-time win, and any
# cross-layer verifier can consume any layer's envelopes)
from mp2_tpu_torch.extraction.mpt_circuits import NUM_MPT_PIS as EXT_W


def _pad_build(build_fn):
    """Wrap a member build fn to zero-pad its registered PIs to EXT_W."""

    def wrapped(b, *a):
        assign = build_fn(b, *a)
        pad = EXT_W - len(b.public_inputs)
        assert pad >= 0, "member registers more PIs than the shared width"
        b.register_public_inputs([b.zero()] * pad)
        return assign

    return wrapped


def _pad_vals(vals: List[int]) -> List[int]:
    return [int(v) for v in vals] + [0] * (EXT_W - len(vals))

# contract PI offsets
_C_H = slice(0, 8)
_C_SR = slice(8, 16)
_C_DM = slice(16, 27)
_C_KEY = slice(27, 27 + MAX_KEY_NIBBLES)
_C_S = 27 + MAX_KEY_NIBBLES

# values PI offsets (mpt_circuits NUM_MPT_PIS layout)
_V_H = slice(0, 8)
_V_DV = slice(8, 19)
_V_DM = slice(19, 30)
_V_N = 30
_V_S = 95

# block PI offsets
_B_BH = slice(0, 8)
_B_PH = slice(8, 16)
_B_SR = slice(16, 24)
_B_BN = 24

# final PI offsets
F_BH = slice(0, 8)
F_PH = slice(8, 16)
F_BN = 16
F_DV = slice(17, 28)
F_DM = slice(28, 39)
F_N = 39
F_MERGE = 40  # 1 for final_merge proofs, 0 (pad) otherwise


def _assign_node(inputs: Dict, node, nlen, node_bytes: bytes):
    for t, v in zip(node, node_bytes):
        inputs[t] = v
    for t in node[len(node_bytes):]:
        inputs[t] = 0
    inputs[nlen] = len(node_bytes)


# ---------------------------------------------------------------------------
# block extraction as a framework
# ---------------------------------------------------------------------------


class BlockExtractionFramework:
    """One-member RecursionFramework around the header circuit so the final
    circuit can verify block proofs through the standard cross-set verifier
    (the reference verifies the block VK as a fixed circuit,
    base_circuit.rs:182; a singleton set digest is the same invariant)."""

    def __init__(
        self,
        header_len: int,
        parent_offset: int,
        state_root_offset: int,
        number_offset: int,
        number_len: int,
        config: Optional[CircuitConfig] = None,
        device="cuda",
    ):
        cfg = config or test_config()
        self.fw = RecursionFramework(cfg, EXT_W, set_height=1, device=device)

        def build(b: CircuitBuilder):
            from mp2_tpu_torch.circuit.gadgets.keccak import keccak256_fixed

            header = b.add_inputs(header_len)
            digest_bits = keccak256_fixed(b, header)
            bh = _bits_to_u32s_be_bytes(b, digest_bits)
            to_u32 = lambda ts: [
                b.add(
                    b.add(
                        b.mul_const(1 << 24, ts[0]), b.mul_const(1 << 16, ts[1])
                    ),
                    b.add(b.mul_const(1 << 8, ts[2]), ts[3]),
                )
            ]
            ph, sr = [], []
            for i in range(0, 32, 4):
                ph += to_u32(header[parent_offset + i : parent_offset + i + 4])
                sr += to_u32(
                    header[state_root_offset + i : state_root_offset + i + 4]
                )
            bn = None
            for i in range(number_len):
                term = b.mul_const(
                    1 << (8 * (number_len - 1 - i)), header[number_offset + i]
                )
                bn = term if bn is None else b.add(bn, term)
            b.register_public_inputs(bh + ph + sr + [bn])

            def assign(inputs: Dict, header_bytes: bytes):
                assert len(header_bytes) == header_len
                for t, v in zip(header, header_bytes):
                    inputs[t] = v

            return assign

        self.fw.add_leaf_circuit("block", _pad_build(build))
        self.fw.finalize()

    def prove_header(self, header: bytes):
        from mp2_tpu_torch.extraction.api import extract_block

        out = extract_block(header)
        pis = _pad_vals(
            pack_bytes_be(out.block_hash)
            + pack_bytes_be(out.parent_hash)
            + pack_bytes_be(out.state_root)
            + [out.block_number]
        )
        return self.fw.prove_leaf("block", (header,), pis), pis

    def verify(self, env) -> bool:
        return self.fw.verify(env)


# ---------------------------------------------------------------------------
# contract extraction circuit set (state-trie walk)
# ---------------------------------------------------------------------------


def build_account_leaf_body(
    b: CircuitBuilder, contract_address: bytes, max_len: int = 150
):
    """State-trie account leaf [path, rlp([nonce, balance, storage_root,
    code_hash])] with the MPT key BAKED to nibbles(keccak(address)) — the
    leaf can only sit at the contract's account path
    (contract_extraction/leaf.rs:35-90)."""
    node = add_byte_inputs(b, max_len)
    nlen = b.add_input()
    h_bits = keccak256_variable(b, node, nlen, max_len)
    h_u32 = _bits_to_u32s_be_bytes(b, h_bits)

    ps = _decode_list_start(b, node)
    path_off, path_len, _ = _decode_item(b, node, ps)
    a_off, a_len, _ = _decode_item(b, node, b.add(path_off, path_len))
    b.connect(b.add(a_off, a_len), nlen)
    inner = _decode_list_at(b, node, a_off)
    n_off, n_len, _ = _decode_item(b, node, inner)
    bal_off, bal_len, _ = _decode_item(b, node, b.add(n_off, n_len))
    s_off, s_len, _ = _decode_item(b, node, b.add(bal_off, bal_len))
    c_off, c_len, _ = _decode_item(b, node, b.add(s_off, s_len))
    b.connect(s_len, b.constant(32))
    b.connect(c_len, b.constant(32))
    b.connect(b.add(c_off, c_len), nlen)
    sr_u32 = pack_u32_be(b, extract_subarray(b, node, s_off, 32))

    # key chain: constant account key, leaf path must be its tail
    key_nibs = host_key_nibbles(contract_address)
    key = [b.constant(int(v)) for v in key_nibs]
    tail, t = _compact_key_tail(b, node, path_off, path_len, flag_base=2)
    s = b.sub(b.constant(MAX_KEY_NIBBLES), t)
    _enforce_key_segment(b, key, s, b.constant(MAX_KEY_NIBBLES), tail)

    dm = curve_constant(b, p2h.map_to_curve_point(pack_bytes_be(contract_address)))
    b.register_public_inputs(
        h_u32 + sr_u32 + curve_to_pi_targets(b, dm) + key + [s]
    )

    def assign(inputs: Dict, node_bytes: bytes):
        _assign_node(inputs, node, nlen, node_bytes)

    return assign


def build_contract_branch_body(b: CircuitBuilder, child_pis, max_len: int = 532):
    """State-trie branch above the account path: single child (one account
    per chain), storage root + DM pass through, key nibble consumed
    (contract_extraction/branch.rs)."""
    node = add_byte_inputs(b, max_len)
    nlen = b.add_input()
    h_bits = keccak256_variable(b, node, nlen, max_len)
    h_u32 = _bits_to_u32s_be_bytes(b, h_bits)

    ps = _decode_list_start(b, node)
    offs, lens = [], []
    cur = ps
    for _ in range(17):
        poff, plen, _ = _decode_item(b, node, cur)
        offs.append(poff)
        lens.append(plen)
        cur = b.add(poff, plen)
    b.connect(cur, nlen)

    s_child = child_pis[_C_S]
    b.connect(b.is_equal(s_child, b.zero()), b.zero())  # S >= 1
    p = b.sub(s_child, b.one())
    child_key = list(child_pis[_C_KEY])
    # the consumed nibble is the child's RLP slot
    slot = value_at(b, child_key, p)
    b.connect(small_lt(b, slot, b.constant(16)), b.one())
    sel_off = value_at(b, offs, slot)
    sel_len = value_at(b, lens, slot)
    b.connect(sel_len, b.constant(32))
    child_u32 = pack_u32_be(b, extract_subarray(b, node, sel_off, 32))
    for a, c in zip(child_u32, child_pis[_C_H]):
        b.connect(a, c)

    b.register_public_inputs(
        h_u32
        + list(child_pis[_C_SR])
        + list(child_pis[_C_DM])
        + child_key
        + [p]
    )

    def assign(inputs: Dict, node_bytes: bytes):
        _assign_node(inputs, node, nlen, node_bytes)

    return assign


def build_contract_extension_body(b: CircuitBuilder, child_pis, max_len: int = 69):
    """State-trie extension: consume path nibbles, pass SR/DM through."""
    node = add_byte_inputs(b, max_len)
    nlen = b.add_input()
    h_bits = keccak256_variable(b, node, nlen, max_len)
    h_u32 = _bits_to_u32s_be_bytes(b, h_bits)

    ps = _decode_list_start(b, node)
    path_off, path_len, _ = _decode_item(b, node, ps)
    c_off, c_len, _ = _decode_item(b, node, b.add(path_off, path_len))
    b.connect(c_len, b.constant(32))
    b.connect(b.add(c_off, c_len), nlen)
    child_u32 = pack_u32_be(b, extract_subarray(b, node, c_off, 32))
    for a, c in zip(child_u32, child_pis[_C_H]):
        b.connect(a, c)

    child_key = list(child_pis[_C_KEY])
    s_child = child_pis[_C_S]
    tail, t = _compact_key_tail(b, node, path_off, path_len, flag_base=0)
    s_new = b.sub(s_child, t)
    _enforce_key_segment(b, child_key, s_new, s_child, tail)

    b.register_public_inputs(
        h_u32
        + list(child_pis[_C_SR])
        + list(child_pis[_C_DM])
        + child_key
        + [s_new]
    )

    def assign(inputs: Dict, node_bytes: bytes):
        _assign_node(inputs, node, nlen, node_bytes)

    return assign


def contract_pi_values(
    node_hash: bytes, storage_root: bytes, dm, key_nibbles, s: int
) -> List[int]:
    return (
        pack_bytes_be(node_hash)
        + pack_bytes_be(storage_root)
        + dm.to_fields()
        + [int(x) for x in key_nibbles]
        + [int(s)]
    )


class ContractExtractionCircuits:
    """account_leaf / extension / branch as a RecursionFramework set over
    the state trie (contract_extraction/api.rs role)."""

    def __init__(
        self,
        contract_address: bytes,
        config: Optional[CircuitConfig] = None,
        max_leaf_len: int = 150,
        max_branch_len: int = 272,
        device="cuda",
    ):
        cfg = config or test_config()
        self.address = bytes(contract_address)
        self.fw = RecursionFramework(cfg, EXT_W, set_height=2, device=device)
        self.fw.add_leaf_circuit(
            "account_leaf",
            _pad_build(
                lambda b: build_account_leaf_body(b, self.address, max_leaf_len)
            ),
        )
        self.fw.add_aggregation_circuit(
            "branch",
            1,
            _pad_build(
                lambda b, ch: build_contract_branch_body(
                    b, ch[0].public_inputs(), max_branch_len
                )
            ),
        )
        self.fw.add_aggregation_circuit(
            "extension",
            1,
            _pad_build(
                lambda b, ch: build_contract_extension_body(
                    b, ch[0].public_inputs(), max_leaf_len
                )
            ),
        )
        self.fw.finalize()

    def prove_state_path(self, proof_nodes: Sequence[bytes]):
        """Prove root..leaf (proof_nodes root-first, as MPT.get_proof
        returns).  Returns (envelope, pis) for the ROOT node."""
        from mp2_tpu_torch.utils import rlp
        from mp2_tpu_torch.utils.keccak import keccak256
        from mp2_tpu_torch.extraction.mpt_circuits import compact_nibbles

        key = host_key_nibbles(self.address)
        leaf = proof_nodes[-1]
        items = rlp.decode(leaf)
        account = rlp.decode(items[1])
        storage_root = account[2]
        dm = p2h.map_to_curve_point(pack_bytes_be(self.address))
        s = MAX_KEY_NIBBLES - len(compact_nibbles(items[0]))
        pis = _pad_vals(
            contract_pi_values(keccak256(leaf), storage_root, dm, key, s)
        )
        env = self.fw.prove_leaf("account_leaf", (leaf,), pis)

        for node in reversed(proof_nodes[:-1]):
            body_items = rlp.decode(node)
            if len(body_items) == 17:
                s = s - 1
            else:
                s = s - len(compact_nibbles(body_items[0]))
            member = "branch" if len(body_items) == 17 else "extension"
            pis = _pad_vals(
                contract_pi_values(keccak256(node), storage_root, dm, key, s)
            )
            env = self.fw.prove_aggregation(member, [env], (node,), pis)
        assert s == 0, "state path did not consume the whole account key"
        return env, pis

    def verify(self, env) -> bool:
        return self.fw.verify(env)



# ---------------------------------------------------------------------------
# length extraction circuit set (length_extraction/{leaf,branch,extension}.rs)
# ---------------------------------------------------------------------------

NUM_LENGTH_PIS = 8 + 11 + MAX_KEY_NIBBLES + 1 + 1

_L_H = slice(0, 8)
_L_DM = slice(8, 19)
_L_KEY = slice(19, 19 + MAX_KEY_NIBBLES)
_L_S = 19 + MAX_KEY_NIBBLES
_L_N = 20 + MAX_KEY_NIBBLES


# ---------------------------------------------------------------------------
# final extraction
# ---------------------------------------------------------------------------

DUMMY_METADATA_DIGEST_PREFIX = b"DUMMY_EXTRACTION"


def no_provable_metadata_digest(md) -> "Point":
    """Host mirror of the dummy circuit's metadata re-encoding: the prefix
    guarantees a non-provable table's digest can never collide with a real
    extraction digest (mp2-v1/src/api.rs:482-495)."""
    return p2h.map_to_curve_point(
        list(DUMMY_METADATA_DIGEST_PREFIX) + md.to_fields()
    )


def final_base_body(
    b: CircuitBuilder, block_pis, contract_pis, values_pis, length_pis=None
):
    """The base-circuit constraints (final_extraction/base_circuit.rs:49-94)
    over already-available PI targets; with `length_pis` also enforces the
    lengthed variant (lengthed_circuit.rs:37-78): the length slot lives in
    the same storage trie and its value equals the extracted row count."""
    # both MPT walks reached their trie root
    b.connect(values_pis[_V_S], b.zero())
    b.connect(contract_pis[_C_S], b.zero())
    # values trie root is the account's storage root
    for a, c in zip(values_pis[_V_H], contract_pis[_C_SR]):
        b.connect(a, c)
    # state trie root is the block header's state root
    for a, c in zip(contract_pis[_C_H], block_pis[_B_SR]):
        b.connect(a, c)
    dm = curve_add(
        b,
        curve_from_pi_targets(b, list(values_pis[_V_DM])),
        curve_from_pi_targets(b, list(contract_pis[_C_DM])),
    )
    if length_pis is not None:
        b.connect(length_pis[_L_S], b.zero())
        for a, c in zip(length_pis[_L_H], values_pis[_V_H]):
            b.connect(a, c)
        b.connect(length_pis[_L_N], values_pis[_V_N])
        dm = curve_add(
            b, dm, curve_from_pi_targets(b, list(length_pis[_L_DM]))
        )
    b.register_public_inputs(
        list(block_pis[_B_BH])
        + list(block_pis[_B_PH])
        + [block_pis[_B_BN]]
        + list(values_pis[_V_DV])
        + curve_to_pi_targets(b, dm)
        + [values_pis[_V_N]]
    )


def build_merge_body(
    b: CircuitBuilder, block_pis, contract_pis, table_a_pis, table_b_pis
):
    """final_extraction merge (merge_circuit.rs:43-85): TWO singleton
    values-extraction proofs over the same contract/block, combined with
    the split-digest scheme — the witnessed flag picks which table is the
    multiplier, and DV = HashToInt(H(fields(dv_mult))) * dv_ind
    (digest.rs combine_to_digest).  Exposes merge flag = 1."""
    from mp2_tpu_torch.circuit.gadgets.curve import (
        curve_scalar_mul_hash128,
        curve_select,
        curve_zero,
    )

    for vp in (table_a_pis, table_b_pis):
        b.connect(vp[_V_S], b.zero())
        for a, c in zip(vp[_V_H], contract_pis[_C_SR]):
            b.connect(a, c)
    for a, c in zip(contract_pis[_C_H], block_pis[_B_SR]):
        b.connect(a, c)
    dm = curve_add(
        b,
        curve_add(
            b,
            curve_from_pi_targets(b, list(table_a_pis[_V_DM])),
            curve_from_pi_targets(b, list(table_b_pis[_V_DM])),
        ),
        curve_from_pi_targets(b, list(contract_pis[_C_DM])),
    )
    is_a_mult = b.add_input()
    b.connect(b.mul(is_a_mult, b.sub(is_a_mult, b.one())), b.zero())
    dv_a = curve_from_pi_targets(b, list(table_a_pis[_V_DV]))
    dv_b = curve_from_pi_targets(b, list(table_b_pis[_V_DV]))
    zero = curve_zero(b)
    ind = curve_add(
        b,
        curve_select(b, is_a_mult, zero, dv_a),
        curve_select(b, is_a_mult, dv_b, zero),
    )
    mult = curve_add(
        b,
        curve_select(b, is_a_mult, dv_a, zero),
        curve_select(b, is_a_mult, zero, dv_b),
    )
    mh = b.hash_no_pad(curve_to_pi_targets(b, mult))
    dv = curve_scalar_mul_hash128(b, mh[0], mh[1], ind)
    n = b.add(table_a_pis[_V_N], table_b_pis[_V_N])
    b.register_public_inputs(
        list(block_pis[_B_BH])
        + list(block_pis[_B_PH])
        + [block_pis[_B_BN]]
        + curve_to_pi_targets(b, dv)
        + curve_to_pi_targets(b, dm)
        + [n, b.one()]
    )

    def assign(inputs, is_table_a_multiplier: bool):
        inputs[is_a_mult] = 1 if is_table_a_multiplier else 0

    return assign


def final_merge_pi_values(
    block_pis, table_a_pis, table_b_pis, contract_dm,
    is_table_a_multiplier: bool,
) -> List[int]:
    from mp2_tpu_torch.field.ecgfp5 import Point

    dv_a = Point.from_fields(table_a_pis[_V_DV])
    dv_b = Point.from_fields(table_b_pis[_V_DV])
    ind, mult = (dv_b, dv_a) if is_table_a_multiplier else (dv_a, dv_b)
    h = p2h.hash_no_pad(mult.to_fields())
    dv = ind.scalar_mul(p2h.hash_to_int(h))
    dm = (
        Point.from_fields(table_a_pis[_V_DM])
        + Point.from_fields(table_b_pis[_V_DM])
        + contract_dm
    )
    return (
        [int(x) for x in block_pis[_B_BH]]
        + [int(x) for x in block_pis[_B_PH]]
        + [int(block_pis[_B_BN])]
        + dv.to_fields()
        + dm.to_fields()
        + [int(table_a_pis[_V_N]) + int(table_b_pis[_V_N]), 1]
    )


def final_pi_values(
    block_pis, values_pis, contract_dm, length_dm=None
) -> List[int]:
    from mp2_tpu_torch.field.ecgfp5 import Point

    dm = Point.from_fields(values_pis[_V_DM]) + contract_dm
    if length_dm is not None:
        dm = dm + length_dm
    return (
        [int(x) for x in block_pis[_B_BH]]
        + [int(x) for x in block_pis[_B_PH]]
        + [int(block_pis[_B_BN])]
        + [int(x) for x in values_pis[_V_DV]]
        + dm.to_fields()
        + [int(values_pis[_V_N])]
    )


class FinalExtractionCircuits:
    """`final_simple`: verifies one block proof + one contract-set proof +
    one values-set proof cross-set and exposes the bound final PIs
    (final_extraction/simple_circuit.rs with one table)."""

    def __init__(
        self,
        block_fw: BlockExtractionFramework,
        contract: ContractExtractionCircuits,
        values,
        config: Optional[CircuitConfig] = None,
        length=None,
        merge: bool = False,
        no_provable: bool = False,
        merge_with=None,
        device="cuda",
    ):
        """`merge`: also builds a `final_merge` member combining TWO
        values-set proofs (merge_circuit.rs) — table A from `values`, table
        B from `merge_with` when given (e.g. a mapping table merged with a
        single-slot multiplier table), else from `values` too.  `length`
        and `no_provable`: the reference's `final_lengthed`
        (lengthed_circuit.rs) and `final_no_provable` (dummy_circuit.rs)
        members, not ported, so any value but the default raises instead
        of leaving that member out."""
        if length is not None:
            raise NotImplementedError(
                "FinalExtractionCircuits(length=...): the length set and final_lengthed "
                "wait for ROADMAP Queue 1 item 3b.3")
        if no_provable:
            raise NotImplementedError(
                "FinalExtractionCircuits(no_provable=...): final_no_provable waits for "
                "ROADMAP Queue 1 item 3b.4")
        cfg = config or test_config()
        merge = bool(merge or merge_with is not None)
        n_members = (
            1
            + (1 if length is not None else 0)
            + (1 if merge else 0)
            + (1 if no_provable else 0)
        )
        self.fw = RecursionFramework(
            cfg, EXT_W, set_height=1 if n_members <= 2 else 2, device=device
        )

        def build(b, children, foreign):
            final_base_body(
                b,
                foreign[0].public_inputs(),
                foreign[1].public_inputs(),
                foreign[2].public_inputs(),
            )
            return lambda inputs: None

        self.fw.add_aggregation_circuit(
            "final_simple", 0, _pad_build(build),
            foreign=[block_fw.fw, contract.fw, values.fw],
        )
        if merge:
            def build_merge(b, children, foreign):
                return build_merge_body(
                    b,
                    foreign[0].public_inputs(),
                    foreign[1].public_inputs(),
                    foreign[2].public_inputs(),
                    foreign[3].public_inputs(),
                )

            values_b = merge_with if merge_with is not None else values
            self.fw.add_aggregation_circuit(
                "final_merge", 0, _pad_build(build_merge),
                foreign=[block_fw.fw, contract.fw, values.fw, values_b.fw],
            )
        self.fw.finalize()

    def prove(
        self,
        block_env: WrappedEnvelope,
        contract_env: WrappedEnvelope,
        values_env: WrappedEnvelope,
    ):
        from mp2_tpu_torch.field.ecgfp5 import Point

        bpis = block_env.user_inputs
        cpis = contract_env.user_inputs
        vpis = values_env.user_inputs
        pis = _pad_vals(
            final_pi_values(bpis, vpis, Point.from_fields(cpis[_C_DM]))
        )
        env = self.fw.prove_aggregation(
            "final_simple", [], (), pis,
            foreign_children=[block_env, contract_env, values_env],
        )
        return env, pis

    def prove_merge(
        self,
        block_env: WrappedEnvelope,
        contract_env: WrappedEnvelope,
        table_a_env: WrappedEnvelope,
        table_b_env: WrappedEnvelope,
        is_table_a_multiplier: bool = False,
    ):
        from mp2_tpu_torch.field.ecgfp5 import Point

        pis = _pad_vals(final_merge_pi_values(
            block_env.user_inputs, table_a_env.user_inputs,
            table_b_env.user_inputs,
            Point.from_fields(contract_env.user_inputs[_C_DM]),
            is_table_a_multiplier,
        ))
        env = self.fw.prove_aggregation(
            "final_merge", [], (is_table_a_multiplier,), pis,
            foreign_children=[
                block_env, contract_env, table_a_env, table_b_env,
            ],
        )
        return env, pis

    def verify(self, env) -> bool:
        return self.fw.verify(env)
