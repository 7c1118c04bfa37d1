"""RLP encoding/decoding (host side; the circuits decode RLP with the byte
gadgets, extraction/mpt_circuits.py).  Reference behavior:
mp2-common/src/rlp.rs.

A jax-free copy of `mp2_tpu/utils/rlp.py`: only the imports change.
"""

from __future__ import annotations

from typing import List, Tuple, Union

RlpItem = Union[bytes, List["RlpItem"]]


def encode(item: RlpItem) -> bytes:
    if isinstance(item, (bytes, bytearray)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _len_prefix(len(b), 0x80) + b
    payload = b"".join(encode(x) for x in item)
    return _len_prefix(len(payload), 0xC0) + payload


def _len_prefix(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def encode_int(v: int) -> bytes:
    if v == 0:
        return encode(b"")
    return encode(v.to_bytes((v.bit_length() + 7) // 8, "big"))


def decode(data: bytes) -> RlpItem:
    item, rest = _decode_one(memoryview(data))
    assert len(rest) == 0, "trailing bytes after RLP item"
    return item


def _decode_one(data) -> Tuple[RlpItem, memoryview]:
    assert len(data) > 0
    b0 = data[0]
    if b0 < 0x80:
        return bytes(data[0:1]), data[1:]
    if b0 < 0xB8:  # short string
        n = b0 - 0x80
        return bytes(data[1 : 1 + n]), data[1 + n :]
    if b0 < 0xC0:  # long string
        ln = b0 - 0xB7
        n = int.from_bytes(bytes(data[1 : 1 + ln]), "big")
        return bytes(data[1 + ln : 1 + ln + n]), data[1 + ln + n :]
    if b0 < 0xF8:  # short list
        n = b0 - 0xC0
        return _decode_list(data[1 : 1 + n]), data[1 + n :]
    ln = b0 - 0xF7
    n = int.from_bytes(bytes(data[1 : 1 + ln]), "big")
    return _decode_list(data[1 + ln : 1 + ln + n]), data[1 + ln + n :]


def _decode_list(data) -> List[RlpItem]:
    out = []
    while len(data):
        item, data = _decode_one(data)
        out.append(item)
    return out
