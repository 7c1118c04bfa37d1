"""MPT node circuits: RLP decoding + keccak binding + digest extraction
IN-CIRCUIT — the map phase of values extraction.

Reference counterparts: mp2-common/src/rlp.rs:22-366 (header/item decode),
mp2-common/src/mpt_sequential (path walk), mp2-v1/src/values_extraction/
{leaf_single.rs:39-60, branch.rs:30-48}.

Circuits (schema baked per table, like the reference's const-generic
CircuitInputs):
  * leaf_single — proves: keccak(node[0:len]) == H; node RLP-parses as
    [path, rlp(value)]; DV = row_digest of the extracted 32-byte value
    under the baked column schema (bit-identical to the host
    compute_leaf_single_values_digest); DM = baked metadata digest.
  * branch — proves: keccak(node) == H; node RLP-parses as a 17-item
    branch; each child proof's hash PI appears verbatim at its witnessed
    (distinct) nibble slot; DV/N accumulate, DM must agree.

PI layout (user PIs): H(8 u32, pack_bytes_be) | DV(11) | DM(11) | N(1).

Key-nibble pointer chain (mpt_sequential/mod.rs MPTKeyWire): every proof
exposes the 64-nibble MPT key plus S = the count of still-unconsumed
leading nibbles (S = reference `pointer` + 1, kept non-negative so no
field -1 encoding is needed).  The leaf matches its hex-prefix compact
path against the key TAIL (S = 64 - path_nibbles); an extension consumes
its path nibbles (S' = S - t, path == key[S'..S]); a branch checks every
child's consumed nibble key[S-1] equals the child's RLP item slot, that
all children share S and the key prefix (branch.rs:92-145), and exposes
S' = S - 1.  The trie root proof must reach S == 0 with key ==
nibbles(keccak(storage_location)) — checked by the consumer against the
storage-key circuit.

A jax-free copy of the storage-trie part of `mp2_tpu/extraction/mpt_circuits.py`:
only the imports change, `build_leaf_single_circuit` and
`ValuesExtractionCircuits` take the device their circuits are compiled for
and proved on (`device="cuda"` unless the caller asks for the CPU), and
`_bits_to_u32s_be_bytes` is carried here from `mp2_tpu/extraction/circuits.py`.
The mapping-of-mappings leaf and the state trie's account leaf wait for
ROADMAP Queue 1 items 3b.5 and 3b.6: `ValuesExtractionCircuits` raises on
`mapping_of_mappings=` instead of leaving that member out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.bytes import (
    add_byte_inputs,
    extract_subarray,
    keccak256_variable,
    left_pad32,
    pack_u32_be,
    small_lt,
    value_at,
)
from mp2_tpu_torch.circuit.gadgets.curve import (
    curve_add,
    curve_constant,
    curve_scalar_mul_hash128,
    curve_to_pi_targets,
    map_to_curve_point_circuit,
)
from mp2_tpu_torch.extraction.columns import ColumnInfo, metadata_digest
from mp2_tpu_torch.extraction.values import (
    compute_leaf_mapping_metadata_digest,
    compute_row_id,
    row_unique_data_for_single_leaf,
)
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.prover.config import CircuitConfig, test_config
from mp2_tpu_torch.prover.prove import CircuitData, prove

MAX_LEAF_LEN = 69  # reference mp2-v1/src/lib.rs MAX_LEAF_NODE_LEN
MAX_KEY_NIBBLES = 64
MAX_PATH_BYTES = 33  # 64 nibbles = 32 bytes + hex-prefix flag byte


# ---------------------------------------------------------------------------
# MPT key wire (mpt_sequential/mod.rs MPTKeyWire)
# ---------------------------------------------------------------------------


def _byte_nibbles(b: CircuitBuilder, byte: Target):
    """(hi, lo) nibbles of a byte-range target."""
    bits = b.decompose_bits(byte, 8)
    lo = b.zero()
    hi = b.zero()
    for j in range(4):
        lo = b.mul_add(bits[j], b.constant(1 << j), lo)
        hi = b.mul_add(bits[4 + j], b.constant(1 << j), hi)
    return hi, lo


def add_key_nibbles(b: CircuitBuilder) -> List[Target]:
    key = b.add_inputs(MAX_KEY_NIBBLES)
    for t in key:
        b.decompose_bits(t, 4)
    return key


def _compact_key_tail(
    b: CircuitBuilder, node, path_off: Target, path_len: Target,
    flag_base: int,
):
    """Decode the hex-prefix path item at (path_off, path_len bytes) into
    (64 tail-nibble targets, nibble count t).  flag_base: 2 for leaves,
    0 for extensions (trie.hex_prefix encoding)."""
    pb = extract_subarray(b, node, path_off, MAX_PATH_BYTES)
    hi0, lo0 = _byte_nibbles(b, pb[0])
    odd = b.sub(hi0, b.constant(flag_base))
    b.connect(b.mul(odd, b.sub(odd, b.one())), b.zero())  # odd ∈ {0,1}
    b.connect(b.mul(b.logic_not(odd), lo0), b.zero())  # even pad nibble = 0
    tail_odd = [lo0]
    for k in range(1, MAX_PATH_BYTES):
        hi, lo = _byte_nibbles(b, pb[k])
        tail_odd.extend((hi, lo))
    tail = [
        b.select(odd, tail_odd[j], tail_odd[j + 1])
        for j in range(MAX_KEY_NIBBLES)
    ]
    t = b.add(b.mul_const(2, b.sub(path_len, b.one())), odd)
    return tail, t


def _enforce_key_segment(
    b: CircuitBuilder, key: Sequence[Target], start: Target, end: Target,
    seg: Sequence[Target],
):
    """key[start + m] == seg[m] for m in [0, end - start)."""
    for i in range(MAX_KEY_NIBBLES):
        ge = b.logic_not(small_lt(b, b.constant(i), start))
        lt = small_lt(b, b.constant(i), end)
        active = b.logic_and(ge, lt)
        idx = b.mul(active, b.sub(b.constant(i), start))
        v = value_at(b, seg, idx)
        b.connect(b.mul(active, b.sub(key[i], v)), b.zero())


def compact_nibbles(path_item: bytes) -> List[int]:
    """Host decode of a hex-prefix compact path (trie.hex_prefix inverse)."""
    hi0 = path_item[0] >> 4
    nibs = [path_item[0] & 15] if hi0 & 1 else []
    for byte in path_item[1:]:
        nibs.extend((byte >> 4, byte & 15))
    return nibs


def host_key_nibbles(location: bytes, secure: bool = True) -> List[int]:
    from mp2_tpu_torch.utils.keccak import keccak256
    from mp2_tpu_torch.utils.trie import to_nibbles

    return to_nibbles(keccak256(location) if secure else location)


def host_leaf_s(leaf_body: bytes) -> int:
    """S (unconsumed-prefix length) exposed by a leaf proof."""
    from mp2_tpu_torch.utils import rlp as rlp_mod

    items = rlp_mod.decode(leaf_body)
    return MAX_KEY_NIBBLES - len(compact_nibbles(items[0]))


def _bits_to_u32s_be_bytes(b: CircuitBuilder, bits: Sequence[Target]) -> List[Target]:
    """256 keccak output bits (LSB-first per byte) -> 8 u32 targets packed
    byte-big-endian (the pack_bytes_be PI convention)."""
    out = []
    for w in range(0, len(bits), 32):
        acc = None
        for j in range(4):  # byte j within the word, big-endian weight
            for k in range(8):
                bit = bits[w + 8 * j + k]
                term = b.mul_const(1 << (8 * (3 - j) + k), bit)
                acc = term if acc is None else b.add(acc, term)
        out.append(acc)
    return out


def _extracted_ids(table_info, value_id: int, evm_word: int = 0):
    """Columns extracted from one storage word of the schema: every schema
    column living at that evm_word (single full-word tables reduce to
    [value_id])."""
    ids = [c.identifier for c in table_info if c.evm_word == evm_word]
    return ids or ([value_id] if evm_word == 0 else [])


def _decode_item(b: CircuitBuilder, arr, off: Target):
    """RLP item at `off`: single byte (< 0x80), short string (0x80-0xb7),
    or long string with ONE length byte (0xb8) — the forms MPT node items
    and embedded account bodies take (rlp.rs decode_header subset).
    Returns (payload_off, payload_len, total_len)."""
    from mp2_tpu_torch.circuit.gadgets.bytes import index_one_hot

    b0 = value_at(b, arr, off)
    is_single = small_lt(b, b0, b.constant(0x80))
    is_long = b.logic_not(small_lt(b, b0, b.constant(0xB8)))
    # long-string length byte: lenient indexing (off+1 may touch the array
    # boundary when the item is short/single and sits at the very end)
    oh = index_one_hot(b, b.add_const(off, 1), len(arr), assert_in_range=False)
    llen = b.zero()
    for bit, v in zip(oh, arr):
        llen = b.mul_add(bit, v, llen)
    plen_short = b.sub(b0, b.constant(0x80))
    plen = b.select(is_single, b.one(), b.select(is_long, llen, plen_short))
    poff = b.select(
        is_single, off,
        b.select(is_long, b.add_const(off, 2), b.add_const(off, 1)),
    )
    total = b.select(
        is_single, b.one(),
        b.select(is_long, b.add_const(plen, 2), b.add_const(plen, 1)),
    )
    return poff, plen, total


def _decode_list_at(b: CircuitBuilder, arr, off: Target) -> Target:
    """Payload start of an RLP list at `off`: short list (0xc0-0xf7) ->
    off+1; long list 0xf8+k -> off+1+k."""
    b0 = value_at(b, arr, off)
    is_short = small_lt(b, b0, b.constant(0xF8))
    extra = b.sub(b0, b.constant(0xF7))
    return b.add(off, b.select(is_short, b.one(), b.add_const(extra, 1)))


def _decode_list_start(b: CircuitBuilder, arr) -> Target:
    """Payload start of the top-level RLP list at offset 0."""
    b0 = arr[0]
    is_short = small_lt(b, b0, b.constant(0xF8))
    extra = b.sub(b0, b.constant(0xF7))
    return b.select(is_short, b.one(), b.add_const(extra, 1))


@dataclass
class MptCircuit:
    data: CircuitData
    node_targets: List[Target]
    len_target: Target
    assign: callable


def _register_mpt_pis(b, h_u32, dv, dm, n, key=None, s=None):
    b.register_public_inputs(h_u32)
    b.register_public_inputs(curve_to_pi_targets(b, dv))
    b.register_public_inputs(curve_to_pi_targets(b, dm))
    b.register_public_input(n)
    if key is not None:
        b.register_public_inputs(key)
        b.register_public_input(s)


def mpt_pi_values(
    node_hash: bytes, dv, dm, n: int,
    key_nibbles: Optional[Sequence[int]] = None, s: Optional[int] = None,
) -> List[int]:
    from mp2_tpu_torch.utils.u256 import pack_bytes_be

    vals = pack_bytes_be(node_hash) + dv.to_fields() + dm.to_fields() + [n]
    if key_nibbles is not None:
        vals += [int(x) for x in key_nibbles] + [int(s)]
    return vals


def build_leaf_single_circuit(
    table_info: Sequence[ColumnInfo],
    value_id: int,
    config: Optional[CircuitConfig] = None,
    max_len: int = MAX_LEAF_LEN,
    evm_word: int = 0,
    device="cuda",
) -> MptCircuit:
    """values_extraction leaf for one storage word of a simple/struct slot
    (leaf_single.rs:39-60 with the schema baked; the MPT key is baked to
    nibbles(keccak(pad32(slot + evm_word))) so the proof can only speak
    about its own storage word)."""
    from mp2_tpu_torch.extraction.storage_key import simple_slot_location

    b = CircuitBuilder(config or test_config())
    node = add_byte_inputs(b, max_len)
    nlen = b.add_input()

    h_bits = keccak256_variable(b, node, nlen, max_len)
    h_u32 = _bits_to_u32s_be_bytes(b, h_bits)

    ps = _decode_list_start(b, node)
    path_off, path_len, path_total = _decode_item(b, node, ps)
    val_off, val_len, _ = _decode_item(b, node, b.add(path_off, path_len))
    # the second item holds rlp(value): decode once more
    v_off, v_len, v_total = _decode_item(b, node, val_off)
    # full consumption: the node ends exactly after the value
    b.connect(b.add(val_off, val_len), nlen)
    b.connect(b.add(v_off, v_len), nlen)
    # value fits a 32-byte word
    b.connect(small_lt(b, v_len, b.constant(33)), b.one())

    raw = extract_subarray(b, node, v_off, 32)
    masked = [
        b.mul(raw[j], small_lt(b, b.constant(j), v_len)) for j in range(32)
    ]
    value32 = left_pad32(b, masked, v_len)

    # DV = (sum over extracted columns of D(id || extracted)) * row_id;
    # the column gadget slices each schema column's bits out of the word
    # (full-word single columns reduce to one map_to_curve)
    from mp2_tpu_torch.extraction.column_gadget import column_values_digest_circuit

    extracted = _extracted_ids(table_info, value_id, evm_word)
    col_digest = column_values_digest_circuit(b, table_info, extracted, value32)
    row_id = compute_row_id(row_unique_data_for_single_leaf(), len(table_info))
    h0, h1 = row_id & ((1 << 64) - 1), row_id >> 64
    dv = curve_scalar_mul_hash128(
        b, b.constant(h0), b.constant(h1), col_digest
    )
    dm = curve_constant(b, metadata_digest(table_info))

    # key BAKED to this word's storage location; the compact path must be
    # the key's TAIL (mpt_sequential MPTKeyWire init); S = 64 - path nibbles
    slots = {c.slot for c in table_info}
    assert len(slots) == 1, "single-table schema spans one slot"
    key_nibs = host_key_nibbles(simple_slot_location(slots.pop(), evm_word))
    key = [b.constant(int(v)) for v in key_nibs]
    tail, t = _compact_key_tail(b, node, path_off, path_len, flag_base=2)
    s = b.sub(b.constant(MAX_KEY_NIBBLES), t)
    _enforce_key_segment(b, key, s, b.constant(MAX_KEY_NIBBLES), tail)
    _register_mpt_pis(b, h_u32, dv, dm, b.one(), key, s)

    def assign(inputs: Dict, node_bytes: bytes,
               key_nibbles: Optional[Sequence[int]] = None):
        assert len(node_bytes) <= max_len
        if key_nibbles is not None:
            assert list(key_nibbles) == key_nibs, (
                "leaf node is not at this slot's storage location"
            )
        for t_, v in zip(node, node_bytes):
            inputs[t_] = v
        for t_ in node[len(node_bytes):]:
            inputs[t_] = 0
        inputs[nlen] = len(node_bytes)

    return MptCircuit(data=b.build(device), node_targets=node, len_target=nlen,
                      assign=assign)


def build_leaf_mapping_body(
    b: CircuitBuilder,
    table_info: Sequence[ColumnInfo],
    value_id: int,
    slot: int,
    key_id: int,
    max_len: int = MAX_LEAF_LEN,
):
    """values_extraction mapping leaf (leaf_mapping.rs, evm_word=0): the
    mapping key is witnessed, the storage location keccak(pad32(key) ||
    pad32(slot)) and the trie key nibbles(keccak(location)) are recomputed
    IN-CIRCUIT, so the leaf is fully bound to its claimed mapping entry —
    no free key inputs.  DV = row_id(key) * (D(value_id || value) +
    D(key_id || key)); DM adds the key-column digest
    (compute_leaf_mapping_metadata_digest)."""
    from mp2_tpu_torch.circuit.gadgets.keccak import keccak256_fixed

    node = add_byte_inputs(b, max_len)
    nlen = b.add_input()
    h_bits = keccak256_variable(b, node, nlen, max_len)
    h_u32 = _bits_to_u32s_be_bytes(b, h_bits)

    ps = _decode_list_start(b, node)
    path_off, path_len, _ = _decode_item(b, node, ps)
    val_off, val_len, _ = _decode_item(b, node, b.add(path_off, path_len))
    v_off, v_len, _ = _decode_item(b, node, val_off)
    b.connect(b.add(val_off, val_len), nlen)
    b.connect(b.add(v_off, v_len), nlen)
    b.connect(small_lt(b, v_len, b.constant(33)), b.one())
    raw = extract_subarray(b, node, v_off, 32)
    masked = [
        b.mul(raw[j], small_lt(b, b.constant(j), v_len)) for j in range(32)
    ]
    value32 = left_pad32(b, masked, v_len)

    # witnessed mapping key (already left-padded to 32 bytes)
    key32 = add_byte_inputs(b, 32)
    packed_key = pack_u32_be(b, key32)

    # location = keccak(pad32(key) || pad32(slot)); trie key =
    # nibbles(keccak(location)) — storage_key.rs:409-480 in-circuit
    slot_bytes = [b.constant(v) for v in (slot).to_bytes(32, "big")]
    loc_bits = keccak256_fixed(b, list(key32) + slot_bytes)
    loc_bytes = []
    for i in range(32):
        byte = b.zero()
        for k in range(8):
            byte = b.mul_add(loc_bits[8 * i + k], b.constant(1 << k), byte)
        loc_bytes.append(byte)
    trie_bits = keccak256_fixed(b, loc_bytes)
    key = []
    for i in range(32):
        hi = b.zero()
        lo = b.zero()
        for k in range(4):
            lo = b.mul_add(trie_bits[8 * i + k], b.constant(1 << k), lo)
            hi = b.mul_add(trie_bits[8 * i + 4 + k], b.constant(1 << k), hi)
        key.extend((hi, lo))

    # the compact path must be the derived key's tail
    tail, t = _compact_key_tail(b, node, path_off, path_len, flag_base=2)
    s = b.sub(b.constant(MAX_KEY_NIBBLES), t)
    _enforce_key_segment(b, key, s, b.constant(MAX_KEY_NIBBLES), tail)

    # digests
    from mp2_tpu_torch.extraction.column_gadget import column_values_digest_circuit

    vd = column_values_digest_circuit(
        b, table_info, _extracted_ids(table_info, value_id), value32
    )
    key_d = map_to_curve_point_circuit(b, [b.constant(key_id)] + packed_key)
    vd = curve_add(b, vd, key_d)
    rud = b.hash_no_pad(packed_key)
    num_actual = len(table_info) + 1
    rid_h = b.hash_no_pad(list(rud) + [b.constant(num_actual)])
    dv = curve_scalar_mul_hash128(b, rid_h[0], rid_h[1], vd)
    dm = curve_constant(
        b, compute_leaf_mapping_metadata_digest(table_info, slot, key_id)
    )
    _register_mpt_pis(b, h_u32, dv, dm, b.one(), key, s)

    def assign(inputs: Dict, node_bytes: bytes, mapping_key32: bytes):
        assert len(node_bytes) <= max_len
        assert len(mapping_key32) == 32
        for t_, v in zip(node, node_bytes):
            inputs[t_] = v
        for t_ in node[len(node_bytes):]:
            inputs[t_] = 0
        inputs[nlen] = len(node_bytes)
        for t_, v in zip(key32, mapping_key32):
            inputs[t_] = v

    return assign


def build_branch_circuit(
    n_children: int,
    child_pis_fn,
    config: Optional[CircuitConfig] = None,
    max_len: int = 532,
):
    """Branch circuit body (branch.rs:30-48): to be used inside a
    RecursionFramework aggregation member — `child_pis_fn(k)` returns the
    k-th verified child's PI targets.  Returns (builder_fn) that, given a
    builder, emits the circuit and returns the assign function."""

    def build(b: CircuitBuilder, children_pis: List[List[Target]]):
        node = add_byte_inputs(b, max_len)
        nlen = b.add_input()
        h_bits = keccak256_variable(b, node, nlen, max_len)
        h_u32 = _bits_to_u32s_be_bytes(b, h_bits)

        ps = _decode_list_start(b, node)
        # walk the 17 items, recording each payload offset/len
        offs, lens = [], []
        cur = ps
        for _ in range(17):
            poff, plen, total = _decode_item(b, node, cur)
            offs.append(poff)
            lens.append(plen)
            cur = b.add(poff, plen)
        b.connect(cur, nlen)  # fully consumed

        dv = None
        dm_pis = None
        n_total = None
        slots = []
        # common MPT key (branch.rs:34 common_prefix): every child agrees
        # on S and the first S-1 nibbles; the child's consumed nibble
        # key[S-1] is its RLP item slot
        key = add_key_nibbles(b)
        s0 = children_pis[0][95]
        b.connect(b.is_equal(s0, b.zero()), b.zero())  # S >= 1
        p = b.sub(s0, b.one())
        for k in range(n_children):
            pis = children_pis[k]
            # child slot: witnessed nibble index in [0, 16)
            slot = b.add_input()
            slots.append(slot)
            b.connect(small_lt(b, slot, b.constant(16)), b.one())
            # payload at that slot must be a 32-byte hash equal to the
            # child's H PIs
            sel_off = value_at(b, offs, slot)
            sel_len = value_at(b, lens, slot)
            b.connect(sel_len, b.constant(32))
            child_bytes = extract_subarray(b, node, sel_off, 32)
            child_u32 = pack_u32_be(b, child_bytes)
            for a, c in zip(child_u32, pis[0:8]):
                b.connect(a, c)
            # key chain: same S, slot == child key nibble at p, shared
            # prefix below p
            child_key = pis[31:95]
            b.connect(pis[95], s0)
            b.connect(value_at(b, child_key, p), slot)
            for i in range(MAX_KEY_NIBBLES):
                active = small_lt(b, b.constant(i), p)
                b.connect(
                    b.mul(active, b.sub(child_key[i], key[i])), b.zero()
                )
            from mp2_tpu_torch.circuit.gadgets.curve import curve_from_pi_targets

            c_dv = curve_from_pi_targets(b, pis[8:19])
            dv = c_dv if dv is None else curve_add(b, dv, c_dv)
            if dm_pis is None:
                dm_pis = pis[19:30]
            else:
                for a, c in zip(dm_pis, pis[19:30]):
                    b.connect(a, c)  # children agree on the metadata digest
            n_total = pis[30] if n_total is None else b.add(n_total, pis[30])
        # distinct child slots
        for i in range(n_children):
            for j in range(i + 1, n_children):
                b.connect(
                    b.is_zero(b.sub(slots[i], slots[j])), b.zero()
                )
        from mp2_tpu_torch.circuit.gadgets.curve import curve_from_pi_targets

        dm = curve_from_pi_targets(b, dm_pis)
        _register_mpt_pis(b, h_u32, dv, dm, n_total, key, p)

        def assign(inputs: Dict, node_bytes: bytes, child_slots: List[int],
                   key_nibbles: Sequence[int]):
            assert len(node_bytes) <= max_len
            for t, v in zip(node, node_bytes):
                inputs[t] = v
            for t in node[len(node_bytes):]:
                inputs[t] = 0
            inputs[nlen] = len(node_bytes)
            for t, v in zip(slots, child_slots):
                inputs[t] = v
            for t, v in zip(key, key_nibbles):
                inputs[t] = int(v)

        return assign

    return build


def build_extension_circuit_body(
    b: CircuitBuilder, child_pis: List[Target], max_len: int = 69
):
    """Extension node: [compact_path, 32-byte child hash] — passes the
    child's digests through unchanged (mpt_sequential leaf_or_extension)."""
    node = add_byte_inputs(b, max_len)
    nlen = b.add_input()
    h_bits = keccak256_variable(b, node, nlen, max_len)
    h_u32 = _bits_to_u32s_be_bytes(b, h_bits)

    ps = _decode_list_start(b, node)
    path_off, path_len, _ = _decode_item(b, node, ps)
    c_off, c_len, _ = _decode_item(b, node, b.add(path_off, path_len))
    b.connect(c_len, b.constant(32))
    b.connect(b.add(c_off, c_len), nlen)
    child_bytes = extract_subarray(b, node, c_off, 32)
    child_u32 = pack_u32_be(b, child_bytes)
    for a, c in zip(child_u32, child_pis[0:8]):
        b.connect(a, c)
    from mp2_tpu_torch.circuit.gadgets.curve import curve_from_pi_targets

    dv = curve_from_pi_targets(b, child_pis[8:19])
    dm = curve_from_pi_targets(b, child_pis[19:30])
    # key chain: consume the extension's path nibbles — they must equal
    # key[S - t .. S); expose S' = S - t with the child key passed through
    child_key = list(child_pis[31:95])
    s_child = child_pis[95]
    tail, t = _compact_key_tail(b, node, path_off, path_len, flag_base=0)
    s_new = b.sub(s_child, t)
    _enforce_key_segment(b, child_key, s_new, s_child, tail)
    _register_mpt_pis(b, h_u32, dv, dm, child_pis[30], child_key, s_new)

    def assign(inputs: Dict, node_bytes: bytes):
        assert len(node_bytes) <= max_len
        for t, v in zip(node, node_bytes):
            inputs[t] = v
        for t in node[len(node_bytes):]:
            inputs[t] = 0
        inputs[nlen] = len(node_bytes)

    return assign


# ---------------------------------------------------------------------------
# the values-extraction circuit set (recursive)
# ---------------------------------------------------------------------------

NUM_MPT_PIS = 31 + MAX_KEY_NIBBLES + 1  # H|DV|DM|N|key(64)|S


class ValuesExtractionCircuits:
    """leaf_single / extension / branch1 / branch2 as a RecursionFramework
    set: branch members verify their children IN-CIRCUIT and check the
    child hashes appear inside the parent node's RLP — the recursive map
    phase of mp2-v1/src/values_extraction/api.rs with a fixed VK.

    `max_branch_len`: 532 matches the reference bound; tests use smaller
    tries to keep CPU circuit sizes down."""

    def __init__(
        self,
        table_info: Sequence[ColumnInfo],
        value_id: int,
        config: Optional[CircuitConfig] = None,
        max_branch_len: int = 272,
        max_leaf_len: int = MAX_LEAF_LEN,
        mapping: Optional[tuple] = None,
        branch_arities: Sequence[int] = (1, 2),
        mapping_of_mappings: Optional[tuple] = None,
        device="cuda",
    ):
        """`mapping=(slot, key_id)` builds the set for a mapping table: the
        leaf member becomes `leaf_mapping` (storage location + trie key
        recomputed in-circuit from the witnessed mapping key).
        `mapping_of_mappings`: the reference's nested-mapping leaf
        (leaf_mapping_of_mappings.rs), not ported, so any value but None
        raises instead of leaving that member out.
        `branch_arities`: which branch members to instantiate (the
        reference picks the smallest fitting arity out of 2/9/16,
        values_extraction/api.rs:371)."""
        from mp2_tpu_torch.recursion.runtime import RecursionFramework

        if mapping_of_mappings is not None:
            raise NotImplementedError(
                "the mapping-of-mappings leaf member waits for ROADMAP Queue 1 "
                "item 3b.5")
        cfg = config or test_config()
        self._table_info = list(table_info)
        self._value_id = value_id
        self._mapping = mapping
        n_leaves = (
            1 if mapping
            else max(1, len({c.evm_word for c in table_info}))
        )
        n_members = n_leaves + 1 + len(tuple(branch_arities))
        set_height = max(1, (n_members - 1).bit_length())
        self.fw = RecursionFramework(cfg, NUM_MPT_PIS, set_height=set_height,
                                     device=device)

        def leaf_build(b, evm_word=0):
            from mp2_tpu_torch.extraction.storage_key import simple_slot_location

            node = add_byte_inputs(b, max_leaf_len)
            nlen = b.add_input()
            h_bits = keccak256_variable(b, node, nlen, max_leaf_len)
            h_u32 = _bits_to_u32s_be_bytes(b, h_bits)
            ps = _decode_list_start(b, node)
            path_off, path_len, _ = _decode_item(b, node, ps)
            val_off, val_len, _ = _decode_item(b, node, b.add(path_off, path_len))
            v_off, v_len, _ = _decode_item(b, node, val_off)
            b.connect(b.add(val_off, val_len), nlen)
            b.connect(b.add(v_off, v_len), nlen)
            b.connect(small_lt(b, v_len, b.constant(33)), b.one())
            raw = extract_subarray(b, node, v_off, 32)
            masked = [
                b.mul(raw[j], small_lt(b, b.constant(j), v_len))
                for j in range(32)
            ]
            value32 = left_pad32(b, masked, v_len)
            from mp2_tpu_torch.extraction.column_gadget import (
                column_values_digest_circuit,
            )

            col_digest = column_values_digest_circuit(
                b, table_info,
                _extracted_ids(table_info, value_id, evm_word), value32,
            )
            row_id = compute_row_id(
                row_unique_data_for_single_leaf(), len(table_info)
            )
            dv = curve_scalar_mul_hash128(
                b, b.constant(row_id & ((1 << 64) - 1)),
                b.constant(row_id >> 64), col_digest,
            )
            dm = curve_constant(b, metadata_digest(table_info))
            # the key is BAKED to nibbles(keccak(pad32(slot + evm_word))):
            # a leaf_single proof can only speak about ITS storage word
            # (leaf_single.rs slot->MPT key check; storage_key.rs:209)
            slots = {c.slot for c in table_info}
            assert len(slots) == 1, "single-table schema spans one slot"
            key_nibs = host_key_nibbles(
                simple_slot_location(slots.pop(), evm_word)
            )
            key = [b.constant(int(v)) for v in key_nibs]
            tail, t = _compact_key_tail(b, node, path_off, path_len,
                                        flag_base=2)
            s = b.sub(b.constant(MAX_KEY_NIBBLES), t)
            _enforce_key_segment(b, key, s, b.constant(MAX_KEY_NIBBLES), tail)
            _register_mpt_pis(b, h_u32, dv, dm, b.one(), key, s)

            def assign(inputs, node_bytes, key_nibbles=None):
                if key_nibbles is not None:
                    assert list(key_nibbles) == key_nibs, (
                        "leaf node is not at this slot's storage location"
                    )
                for t_, v in zip(node, node_bytes):
                    inputs[t_] = v
                for t_ in node[len(node_bytes):]:
                    inputs[t_] = 0
                inputs[nlen] = len(node_bytes)

            return assign

        if mapping is not None:
            m_slot, m_key_id = mapping
            self.fw.add_leaf_circuit(
                "leaf_mapping",
                lambda b: build_leaf_mapping_body(
                    b, self._table_info, value_id, m_slot, m_key_id,
                    max_leaf_len,
                ),
            )
        else:
            # one leaf member per storage word of the schema (struct slots
            # span several EVM words; each word is its own trie leaf)
            self._words = sorted({c.evm_word for c in table_info}) or [0]
            for w in self._words:
                name = "leaf_single" if w == 0 else f"leaf_single_w{w}"
                self.fw.add_leaf_circuit(
                    name, lambda b, w=w: leaf_build(b, w)
                )

        def ext_build(b, children):
            return build_extension_circuit_body(
                b, children[0].public_inputs(), max_leaf_len
            )

        self.fw.add_aggregation_circuit("extension", 1, ext_build)

        self._branch_arities = tuple(sorted(branch_arities))
        for arity in self._branch_arities:
            body = build_branch_circuit(arity, None, max_len=max_branch_len)

            def make(body=body):
                def branch_build(b, children):
                    return body(b, [c.public_inputs() for c in children])

                return branch_build

            self.fw.add_aggregation_circuit(f"branch{arity}", arity, make())
        self.fw.finalize()

    def _leaf_single_job(self, node_bytes: bytes, key_nibbles, evm_word=0):
        """(member, assign args, claimed PIs) for one simple-slot leaf."""
        from mp2_tpu_torch.utils.keccak import keccak256
        from mp2_tpu_torch.utils.u256 import left_pad32 as lp32
        from mp2_tpu_torch.utils import rlp as rlp_mod

        items = rlp_mod.decode(node_bytes)
        value = lp32(rlp_mod.decode(items[1]))
        # single-column schema: digest conventions from the host layer
        dv = self._leaf_dv(value, evm_word)
        dm = self._dm
        pis = mpt_pi_values(
            keccak256(node_bytes), dv, dm, 1, key_nibbles,
            host_leaf_s(node_bytes),
        )
        name = "leaf_single" if evm_word == 0 else f"leaf_single_w{evm_word}"
        return name, (node_bytes, key_nibbles), pis

    def prove_leaf(self, node_bytes: bytes, key_nibbles: Sequence[int],
                   evm_word: int = 0):
        name, args, pis = self._leaf_single_job(
            node_bytes, key_nibbles, evm_word
        )
        return self.fw.prove_leaf(name, args, pis), pis

    def _leaf_mapping_job(self, node_bytes: bytes, mapping_key: bytes):
        """(member, args, PIs) for a mapping leaf; the trie key is derived
        host-side for the PI claim and re-derived in-circuit from the
        witnessed key."""
        from mp2_tpu_torch.extraction import storage_key as SKmod
        from mp2_tpu_torch.extraction import values as Vmod
        from mp2_tpu_torch.utils.keccak import keccak256
        from mp2_tpu_torch.utils.u256 import left_pad32 as lp32
        from mp2_tpu_torch.utils import rlp as rlp_mod

        m_slot, m_key_id = self._mapping
        items = rlp_mod.decode(node_bytes)
        value = lp32(rlp_mod.decode(items[1]))
        dv = Vmod.compute_leaf_mapping_values_digest(
            self._table_info, _extracted_ids(self._table_info, self._value_id), value, mapping_key, 0,
            m_key_id,
        )
        dm = compute_leaf_mapping_metadata_digest(
            self._table_info, m_slot, m_key_id
        )
        loc = SKmod.mapping_location(m_slot, mapping_key)
        key_nibbles = host_key_nibbles(loc)
        pis = mpt_pi_values(
            keccak256(node_bytes), dv, dm, 1, key_nibbles,
            host_leaf_s(node_bytes),
        )
        return "leaf_mapping", (node_bytes, lp32(mapping_key)), pis

    def prove_leaf_mapping(self, node_bytes: bytes, mapping_key: bytes):
        name, args, pis = self._leaf_mapping_job(node_bytes, mapping_key)
        return self.fw.prove_leaf(name, args, pis), pis

    def prove_branch(self, node_bytes: bytes, children, child_pis, slots):
        from mp2_tpu_torch.field.ecgfp5 import Point
        from mp2_tpu_torch.utils.keccak import keccak256

        assert len(children) in self._branch_arities, (
            f"no branch member of arity {len(children)} "
            f"(instantiated: {self._branch_arities})"
        )
        dv = Point.neutral()
        n = 0
        for piv in child_pis:
            dv = dv + Point.from_fields(piv[8:19])
            n += piv[30]
        dm = Point.from_fields(child_pis[0][19:30])
        key = [int(x) for x in child_pis[0][31:95]]
        s_new = int(child_pis[0][95]) - 1
        pis = mpt_pi_values(keccak256(node_bytes), dv, dm, n, key, s_new)
        env = self.fw.prove_aggregation(
            f"branch{len(children)}", children, (node_bytes, slots, key), pis
        )
        return env, pis

    def prove_extension(self, node_bytes: bytes, child_env, child_piv):
        """Extension node above an already-proven child: digests/count pass
        through, path nibbles consumed (leaf_or_extension.rs role)."""
        from mp2_tpu_torch.field.ecgfp5 import Point
        from mp2_tpu_torch.utils import rlp as rlp_mod
        from mp2_tpu_torch.utils.keccak import keccak256

        items = rlp_mod.decode(node_bytes)
        assert len(items) == 2, "extension node must be a 2-item list"
        s_new = int(child_piv[95]) - len(compact_nibbles(items[0]))
        pis = mpt_pi_values(
            keccak256(node_bytes),
            Point.from_fields(child_piv[8:19]),
            Point.from_fields(child_piv[19:30]),
            int(child_piv[30]),
            [int(x) for x in child_piv[31:95]],
            s_new,
        )
        env = self.fw.prove_aggregation(
            "extension", [child_env], (node_bytes,), pis
        )
        return env, pis

    def prove_trie(self, paths: Dict, leaf_args: Dict):
        """Prove an arbitrary storage-trie shape bottom-up.

        `paths`: entry -> root-first node list (MPT.get_proof output);
        `leaf_args`: entry -> args for the leaf prover (mapping key bytes
        for mapping sets, key nibbles for simple-slot sets).  Unproven
        siblings stay as raw hash bytes inside their parent nodes.  Returns
        (root envelope, root PIs) — the map-reduce over one trie
        (values_extraction/api.rs:214-340 role)."""
        from mp2_tpu_torch.utils import rlp as rlp_mod
        from mp2_tpu_torch.utils.keccak import keccak256

        node_of: Dict[bytes, bytes] = {}
        parent_of: Dict[bytes, bytes] = {}
        for nodes in paths.values():
            hs = [keccak256(nb) for nb in nodes]
            for h, nb in zip(hs, nodes):
                node_of[h] = nb
            for c, p in zip(hs[1:], hs):
                assert parent_of.get(c, p) == p, "inconsistent proof paths"
                parent_of[c] = p

        # one (member, args, claimed PIs) job per distinct leaf node
        jobs: Dict[bytes, tuple] = {}
        for entry, nodes in paths.items():
            leaf = nodes[-1]
            h = keccak256(leaf)
            if h in jobs:
                continue
            if self._mapping is not None:
                jobs[h] = self._leaf_mapping_job(leaf, leaf_args[entry])
            else:
                args = leaf_args[entry]
                if (
                    isinstance(args, tuple) and len(args) == 2
                    and isinstance(args[1], int)
                    and not isinstance(args[0], int)
                ):  # (key_nibbles, evm_word) for struct words
                    jobs[h] = self._leaf_single_job(leaf, args[0], args[1])
                else:
                    jobs[h] = self._leaf_single_job(leaf, args)

        proven: Dict[bytes, tuple] = {}
        import os as _os

        batch = len(jobs) > 1 and bool(_os.environ.get("MP2_BATCH_LEAVES"))
        if batch:
            # the map phase proper: same-member leaves proved B-per-dispatch
            # through the batched prover at every stage incl. the wraps
            by_member: Dict[str, List[bytes]] = {}
            for h, (name, _, _) in jobs.items():
                by_member.setdefault(name, []).append(h)
            for name, hs in by_member.items():
                envs = self.fw.prove_leaves_batch(
                    name, [jobs[h][1] for h in hs], [jobs[h][2] for h in hs]
                )
                for h, env in zip(hs, envs):
                    proven[h] = (env, jobs[h][2])
        else:
            for h, (name, args, pis) in jobs.items():
                proven[h] = (self.fw.prove_leaf(name, args, pis), pis)

        kids: Dict[bytes, set] = {}
        for c, p in parent_of.items():
            kids.setdefault(p, set()).add(c)
        pending = set(kids)
        while pending:
            ready = [
                h for h in pending
                if all(c in proven for c in kids[h])
            ]
            assert ready, "trie proof graph is not connected"
            for h in ready:
                nb = node_of[h]
                items = rlp_mod.decode(nb)
                if len(items) == 17:
                    slot_of = {
                        c: next(
                            i for i, it in enumerate(items[:16]) if it == c
                        )
                        for c in kids[h]
                    }
                    cs = sorted(kids[h], key=slot_of.__getitem__)
                    proven[h] = self.prove_branch(
                        nb,
                        [proven[c][0] for c in cs],
                        [proven[c][1] for c in cs],
                        [slot_of[c] for c in cs],
                    )
                else:
                    (c,) = kids[h]
                    proven[h] = self.prove_extension(nb, *proven[c])
                pending.discard(h)

        root_h = keccak256(next(iter(paths.values()))[0])
        return proven[root_h]

    def verify(self, env) -> bool:
        return self.fw.verify(env)

    @property
    def _dm(self):
        return metadata_digest(self._table_info)

    def _leaf_dv(self, value, evm_word: int = 0):
        from mp2_tpu_torch.extraction import values as V

        return V.compute_leaf_single_values_digest(
            self._table_info,
            _extracted_ids(self._table_info, self._value_id, evm_word),
            value,
        )
