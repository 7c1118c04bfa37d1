"""Keccak-256 (host witness generation path).

Pure-python keccak-f[1600] golden model.  Matches Ethereum's keccak256
(original Keccak padding 0x01, not SHA-3's 0x06).

A jax-free copy of `mp2_tpu/utils/keccak.py` without the loader of the
reference's optional native library: `keccak256` is the Python sponge.  The
host hashes a few dozen nodes per trie.
"""

from __future__ import annotations

from typing import List

_ROUNDS = 24
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
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(state: List[int]) -> List[int]:
    """25 lanes of 64 bits, lane (x, y) at index x + 5*y."""
    a = list(state)
    for rnd in range(_ROUNDS):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y] & _M64) & b[(x + 2) % 5 + 5 * y]
                )
        # iota
        a[0] ^= _RC[rnd]
    return a


def _keccak256_py(data: bytes) -> bytes:
    rate = 136  # 1088 bits
    state = [0] * 25
    # pad: 0x01 ... 0x80 (keccak, not sha3)
    padded = bytearray(data)
    pad_len = rate - (len(data) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


def keccak256(data: bytes) -> bytes:
    return _keccak256_py(data)
