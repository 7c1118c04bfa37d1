"""Byte-array wire gadgets: random access, subarrays, comparisons, and
VARIABLE-length keccak over padded byte vectors.

Role of the reference's `array`/`Vector` wires (mp2-common/src/array.rs:
45-569: `value_at`, `extract_array`, `VectorWire`) and the variable-length
keccak wires (keccak.rs:30-291) — the workhorse layer for byte-level MPT /
RLP parsing in circuits.  Arrays are fixed-capacity lists of byte targets
(each range-checked at creation) with the REAL length as a witness.

A jax-free copy of `mp2_tpu/circuit/gadgets/bytes.py`: only the
imports change.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.keccak import RATE_BYTES, bytes_to_bits, keccak_f
from mp2_tpu_torch.field.goldilocks import P


def add_byte_inputs(b: CircuitBuilder, n: int) -> List[Target]:
    """n byte witnesses, each range-checked to 8 bits."""
    ts = b.add_inputs(n)
    for t in ts:
        b.decompose_bits(t, 8)
    return ts


def index_one_hot(
    b: CircuitBuilder, idx: Target, n: int, assert_in_range: bool = True
) -> List[Target]:
    """One-hot of idx over [0, n); constrains idx < n when requested."""
    oh = [b.is_equal(idx, b.constant(j)) for j in range(n)]
    if assert_in_range:
        acc = oh[0]
        for t in oh[1:]:
            acc = b.add(acc, t)
        b.connect(acc, b.one())
    return oh


def value_at(b: CircuitBuilder, arr: Sequence[Target], idx: Target) -> Target:
    """arr[idx] via a one-hot mux (array.rs value_at role)."""
    oh = index_one_hot(b, idx, len(arr))
    acc = b.zero()
    for bit, v in zip(oh, arr):
        acc = b.mul_add(bit, v, acc)
    return acc


def extract_subarray(
    b: CircuitBuilder, arr: Sequence[Target], offset: Target, length: int
) -> List[Target]:
    """arr[offset : offset+length] with a variable offset (extract_array).

    One shared one-hot of `offset`; element j is then a shifted dot
    product — length * |arr| mul_adds total."""
    n = len(arr)
    oh = index_one_hot(b, offset, n)
    out = []
    for j in range(length):
        acc = b.zero()
        for s, bit in enumerate(oh):
            if s + j < n:
                acc = b.mul_add(bit, arr[s + j], acc)
        out.append(acc)
    return out


def small_lt(b: CircuitBuilder, x: Target, y: Target, bits: int = 10) -> Target:
    """x < y for values < 2^bits (decompose x - y + 2^bits; the top bit is
    the not-borrow).  bits=10 covers MPT node offsets/lengths (<= 532)."""
    d = b.add_const(b.sub(x, y), 1 << bits)
    dec = b.decompose_bits(d, bits + 1)
    return b.logic_not(dec[bits])


def byte_lt(b: CircuitBuilder, x: Target, y: Target) -> Target:
    return small_lt(b, x, y, 10)


def byte_le(b: CircuitBuilder, x: Target, y: Target) -> Target:
    return b.logic_not(byte_lt(b, y, x))


def pack_u32_be(b: CircuitBuilder, byte_ts: Sequence[Target]) -> List[Target]:
    """Bytes -> u32 targets, 4 bytes big-endian each (pack_bytes_be)."""
    out = []
    for i in range(0, len(byte_ts), 4):
        acc = None
        for j in range(4):
            t = byte_ts[i + j] if i + j < len(byte_ts) else b.zero()
            term = b.mul_const(1 << (8 * (3 - j)), t)
            acc = term if acc is None else b.add(acc, term)
        out.append(acc)
    return out


def left_pad32(
    b: CircuitBuilder, data: Sequence[Target], real_len: Target
) -> List[Target]:
    """Right-align `data[0:real_len]` into a 32-byte word, zero padding on
    the left (utils left_pad32): out[31 - i] = data[real_len - 1 - i]."""
    n = len(data)
    assert n <= 32
    # out[j] = data[j - (32 - real_len)] when j >= 32 - real_len else 0
    # equivalently out[j] = value at (real_len - 32 + j) with OOB -> 0
    oh = index_one_hot(b, real_len, n + 1)  # real_len in [0, n]
    out = []
    for j in range(32):
        acc = b.zero()
        for L, bit in enumerate(oh):
            src = L - 32 + j
            if 0 <= src < n:
                acc = b.mul_add(bit, data[src], acc)
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# variable-length keccak256 over a padded byte vector
# ---------------------------------------------------------------------------


def keccak256_variable(
    b: CircuitBuilder,
    arr: Sequence[Target],
    real_len: Target,
    max_len: int,
) -> List[Target]:
    """keccak256(arr[0:real_len]) for a witness length <= max_len: bytes
    beyond real_len are masked off, the 0x01 pad lands at position
    real_len, 0x80 closes the active block; runs ceil((max_len+1)/136)
    permutations and selects the state after the real block count
    (keccak.rs KeccakCircuit role).  Returns 256 output bits."""
    n_blocks = (max_len // RATE_BYTES) + 1
    padded = n_blocks * RATE_BYTES
    arr = list(arr) + [b.zero()] * (padded - len(arr))

    # masks: lt[i] = (i < real_len)
    lt = []
    for i in range(padded):
        lt.append(byte_lt(b, b.constant(i) if i else b.zero(), real_len)
                  if i < max_len + 1 else b.zero())
    eq = index_one_hot(b, real_len, max_len + 1, assert_in_range=True)
    eq_full = [eq[i] if i <= max_len else b.zero() for i in range(padded)]

    # last byte index of the ACTIVE block region: block k covers bytes
    # [0, 136(k+1)); active blocks = floor(real_len/136) + 1
    # 0x80 goes at position 136*active - 1
    msg = []
    for i in range(padded):
        kept = b.mul(lt[i], arr[i]) if i < len(arr) else b.zero()
        v = b.add(kept, b.mul_const(0x01, eq_full[i]))
        msg.append(v)
    # add 0x80 at each block end IF that block is the closing one:
    # block k closes iff 136k <= real_len < 136(k+1)
    block_flags = []
    for k in range(n_blocks):
        lo = b.logic_not(byte_lt(b, real_len, b.constant(RATE_BYTES * k))) \
            if k else b.one()
        hi = byte_lt(b, real_len, b.constant(RATE_BYTES * (k + 1)))
        block_flags.append(b.logic_and(lo, hi))
        end = RATE_BYTES * (k + 1) - 1
        msg[end] = b.add(msg[end], b.mul_const(0x80, block_flags[k]))

    bits = bytes_to_bits(b, msg)
    zero = b.zero()
    state = [[[zero] * 64 for _ in range(5)] for _ in range(5)]
    outs = []
    for blk in range(n_blocks):
        block = bits[blk * 1088 : (blk + 1) * 1088]
        for i in range(17):
            x, y = i % 5, i // 5
            lane = block[i * 64 : (i + 1) * 64]
            if blk == 0:
                state[x][y] = list(lane)
            else:
                state[x][y] = [
                    b.logic_xor(s, m) for s, m in zip(state[x][y], lane)
                ]
        state = keccak_f(b, state)
        out_bits = []
        for i in range(4):
            x, y = i % 5, i // 5
            out_bits.extend(state[x][y])
        outs.append(out_bits)

    # select the digest of the closing block
    if n_blocks == 1:
        return outs[0]
    res = []
    for z in range(256):
        acc = b.zero()
        for k in range(n_blocks):
            acc = b.mul_add(block_flags[k], outs[k][z], acc)
        res.append(acc)
    return res
