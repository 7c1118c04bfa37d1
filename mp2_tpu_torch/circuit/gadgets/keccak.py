"""In-circuit Keccak-256: keccak-f[1600] over boolean wires.

Role of the reference's keccak wires (mp2-common/src/keccak.rs:30-291 over
plonky2_crypto's sponge gates): the hash that binds every MPT node and
block header.  Representation: 25 lanes x 64 boolean targets; linear layers
(theta) use the PARITY trick — k-way xor = LSB of the bit-sum, via one
shared bit-decompose slot instead of xor chains; rho/pi are free rewirings;
chi is the only nonlinear layer (2 muls/bit).

Cost: ~6.5k rows per permutation — binary hashing is inherently expensive
over a 64-bit prime field (the reference pays the same through
plonky2_crypto); MPT path circuits batch several permutations per node.

A jax-free copy of `mp2_tpu/circuit/gadgets/keccak.py`: only the
imports change.
"""

from __future__ import annotations

from typing import List, Sequence

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.field.goldilocks import P

RATE_BYTES = 136  # keccak-256 rate (1088 bits)

# rotation offsets r[x][y] and round constants (fixed by the Keccak spec)
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

Lane = List[Target]  # 64 bits, LSB first
State = List[List[Lane]]  # [x][y]


def _parity(b: CircuitBuilder, bits: Sequence[Target]) -> Target:
    """XOR of k boolean targets as the LSB of their integer sum."""
    bits = list(bits)
    if len(bits) == 1:
        return bits[0]
    if len(bits) == 2:
        return b.logic_xor(bits[0], bits[1])
    acc = bits[0]
    for t in bits[1:]:
        acc = b.add(acc, t)
    width = len(bits).bit_length()
    return b.decompose_bits(acc, width)[0]


def _rot(lane: Lane, r: int) -> Lane:
    """Rotate left by r: free (rewiring only)."""
    r %= 64
    return lane[-r:] + lane[:-r] if r else list(lane)


def keccak_f(b: CircuitBuilder, state: State) -> State:
    a = [[list(state[x][y]) for y in range(5)] for x in range(5)]
    for rnd in range(24):
        # theta
        c = [
            [_parity(b, [a[x][y][z] for y in range(5)]) for z in range(64)]
            for x in range(5)
        ]
        d = [
            [
                b.logic_xor(c[(x - 1) % 5][z], c[(x + 1) % 5][(z - 1) % 64])
                for z in range(64)
            ]
            for x in range(5)
        ]
        a = [
            [
                [b.logic_xor(a[x][y][z], d[x][z]) for z in range(64)]
                for y in range(5)
            ]
            for x in range(5)
        ]
        # rho + pi
        bmat: State = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                bmat[y][(2 * x + 3 * y) % 5] = _rot(a[x][y], _ROT[x][y])
        # chi: a = b ^ (~b[x+1] & b[x+2])
        a = [
            [
                [
                    b.logic_xor(
                        bmat[x][y][z],
                        b.sub(
                            bmat[(x + 2) % 5][y][z],
                            b.mul(bmat[(x + 1) % 5][y][z], bmat[(x + 2) % 5][y][z]),
                        ),
                    )
                    for z in range(64)
                ]
                for y in range(5)
            ]
            for x in range(5)
        ]
        # iota
        rc = _RC[rnd]
        for z in range(64):
            if (rc >> z) & 1:
                a[0][0][z] = b.logic_not(a[0][0][z])
    return a


def bytes_to_bits(b: CircuitBuilder, byte_targets: Sequence[Target]) -> List[Target]:
    """Decompose byte targets (range-checked to 8 bits) into bits, LSB
    first per byte (keccak's bit ordering within bytes)."""
    bits: List[Target] = []
    for t in byte_targets:
        bits.extend(b.decompose_bits(t, 8))
    return bits


def bits_to_u32s(b: CircuitBuilder, bits: Sequence[Target]) -> List[Target]:
    """Pack bits (LSB-first within each 32-bit word) into u32 targets —
    the reference's packed OutputHash convention."""
    out = []
    for i in range(0, len(bits), 32):
        acc = None
        for k, bit in enumerate(bits[i : i + 32]):
            term = b.mul_const(1 << k, bit)
            acc = term if acc is None else b.add(acc, term)
        out.append(acc)
    return out


def keccak256_fixed(
    b: CircuitBuilder, message_bytes: Sequence[Target]
) -> List[Target]:
    """Keccak-256 of a FIXED-length byte message (known at circuit build):
    returns 256 output bits (LSB-first per byte).  Padding (pad10*1 with
    the 0x01 keccak domain byte) is applied structurally."""
    n = len(message_bytes)
    msg_bits = bytes_to_bits(b, message_bytes)
    zero, one = b.zero(), b.one()

    # build padded blocks of 1088 bits
    n_blocks = (n // RATE_BYTES) + 1
    padded_len = n_blocks * RATE_BYTES
    pad_bits: List[Target] = []
    for i in range(n, padded_len):
        byte = 0
        if i == n:
            byte |= 0x01
        if i == padded_len - 1:
            byte |= 0x80
        for k in range(8):
            pad_bits.append(one if (byte >> k) & 1 else zero)
    all_bits = msg_bits + pad_bits

    state: State = [[[zero] * 64 for _ in range(5)] for _ in range(5)]
    for blk in range(n_blocks):
        block = all_bits[blk * 1088 : (blk + 1) * 1088]
        # absorb: xor block lanes into state (lane order: y*5 + x)
        for i in range(17):  # 17 lanes of 64 bits = 1088
            x, y = i % 5, i // 5
            lane_bits = block[i * 64 : (i + 1) * 64]
            if blk == 0:
                state[x][y] = list(lane_bits)
            else:
                state[x][y] = [
                    b.logic_xor(s, m) for s, m in zip(state[x][y], lane_bits)
                ]
        state = keccak_f(b, state)

    out_bits: List[Target] = []
    for i in range(4):  # first 4 lanes = 256 bits
        x, y = i % 5, i // 5
        out_bits.extend(state[x][y])
    return out_bits


def set_bytes(inputs: dict, byte_targets: Sequence[Target], data: bytes):
    for t, v in zip(byte_targets, data):
        inputs[t] = v
