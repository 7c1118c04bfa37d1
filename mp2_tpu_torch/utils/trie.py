"""Ethereum Merkle-Patricia trie (host): build tries, produce proofs.

Test-fixture and witness-side equivalent of the reference's use of `eth_trie`
and Anvil (mp2-test/src/mpt_sequential.rs generates tries for circuit tests;
mp2-common/src/eth.rs fetches real proofs).  This is a from-scratch MPT with
the standard node encodings:

  leaf      [hex-prefix(key_rest, true), value]
  extension [hex-prefix(shared, false), child]
  branch    [c0, ..., c15, value]

Children < 32 bytes RLP-encoded are inlined, else referenced by keccak hash.
`get_proof` returns the list of RLP node bodies from root to leaf — the
input format of the extraction circuits (one proof node per circuit layer).

A jax-free copy of `mp2_tpu/utils/trie.py`: only the imports change.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from mp2_tpu_torch.utils.keccak import keccak256
from mp2_tpu_torch.utils.rlp import encode as rlp_encode


def to_nibbles(key: bytes) -> List[int]:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0xF)
    return out


def hex_prefix(nibbles: List[int], is_leaf: bool) -> bytes:
    flag = 2 if is_leaf else 0
    if len(nibbles) % 2:
        data = [flag + 1] + nibbles
    else:
        data = [flag, 0] + nibbles
    return bytes(
        (data[i] << 4) | data[i + 1] for i in range(0, len(data), 2)
    )


class _TrieNode:
    pass


class _Leaf(_TrieNode):
    def __init__(self, nibbles, value):
        self.nibbles = nibbles
        self.value = value


class _Ext(_TrieNode):
    def __init__(self, nibbles, child):
        self.nibbles = nibbles
        self.child = child


class _Branch(_TrieNode):
    def __init__(self):
        self.children: List[Optional[_TrieNode]] = [None] * 16
        self.value: bytes = b""


class MPT:
    """Build-only MPT (no deletion) with proof extraction."""

    def __init__(self, secure: bool = True):
        self.root: Optional[_TrieNode] = None
        self.secure = secure  # keccak the keys (storage/state tries do)

    def insert(self, key: bytes, value: bytes):
        if self.secure:
            key = keccak256(key)
        nib = to_nibbles(key)
        self.root = self._insert(self.root, nib, value)

    def _insert(self, node, nib, value):
        if node is None:
            return _Leaf(nib, value)
        if isinstance(node, _Leaf):
            if node.nibbles == nib:
                node.value = value
                return node
            common = _common_len(node.nibbles, nib)
            branch = _Branch()
            old_rest = node.nibbles[common:]
            new_rest = nib[common:]
            if not old_rest:
                branch.value = node.value
            else:
                branch.children[old_rest[0]] = _Leaf(old_rest[1:], node.value)
            if not new_rest:
                branch.value = value
            else:
                branch.children[new_rest[0]] = _Leaf(new_rest[1:], value)
            if common:
                return _Ext(nib[:common], branch)
            return branch
        if isinstance(node, _Ext):
            common = _common_len(node.nibbles, nib)
            if common == len(node.nibbles):
                node.child = self._insert(node.child, nib[common:], value)
                return node
            # split the extension
            branch = _Branch()
            ext_rest = node.nibbles[common:]
            sub = (
                node.child
                if len(ext_rest) == 1
                else _Ext(ext_rest[1:], node.child)
            )
            branch.children[ext_rest[0]] = sub
            new_rest = nib[common:]
            if not new_rest:
                branch.value = value
            else:
                branch.children[new_rest[0]] = _Leaf(new_rest[1:], value)
            if common:
                return _Ext(nib[:common], branch)
            return branch
        assert isinstance(node, _Branch)
        if not nib:
            node.value = value
            return node
        node.children[nib[0]] = self._insert(node.children[nib[0]], nib[1:], value)
        return node

    # -- encoding -----------------------------------------------------------
    def _node_body(self, node) -> bytes:
        """RLP encoding of the node's full body."""
        if isinstance(node, _Leaf):
            return rlp_encode([hex_prefix(node.nibbles, True), node.value])
        if isinstance(node, _Ext):
            return rlp_encode([hex_prefix(node.nibbles, False), self._ref(node.child)])
        items = []
        for c in node.children:
            items.append(b"" if c is None else self._ref(c))
        items.append(node.value)
        return rlp_encode(items)

    def _ref(self, node):
        """Child reference: inline if < 32 bytes, else keccak hash."""
        body = self._node_body(node)
        if len(body) < 32:
            from mp2_tpu_torch.utils.rlp import decode as rlp_decode

            return rlp_decode(body)  # inline as a structured item
        return keccak256(body)

    def root_hash(self) -> bytes:
        if self.root is None:
            return keccak256(rlp_encode(b""))
        body = self._node_body(self.root)
        return keccak256(body)

    # -- proofs -------------------------------------------------------------
    def get_proof(self, key: bytes) -> List[bytes]:
        """RLP node bodies from root to the node holding the key.

        Inlined (sub-32-byte) nodes do not appear as separate proof items,
        matching eth_getProof semantics.
        """
        if self.secure:
            key = keccak256(key)
        nib = to_nibbles(key)
        proof: List[bytes] = []
        node = self.root
        pending_inline = False
        while node is not None:
            body = self._node_body(node)
            if not pending_inline:
                proof.append(body)
            if isinstance(node, _Leaf):
                assert node.nibbles == nib, "key not present"
                return proof
            if isinstance(node, _Ext):
                assert nib[: len(node.nibbles)] == node.nibbles
                nib = nib[len(node.nibbles) :]
                nxt = node.child
            else:
                if not nib:
                    return proof
                nxt = node.children[nib[0]]
                assert nxt is not None, "key not present"
                nib = nib[1:]
            pending_inline = len(self._node_body(nxt)) < 32
            node = nxt
        raise KeyError("key not present")

    def get(self, key: bytes) -> Optional[bytes]:
        if self.secure:
            key = keccak256(key)
        nib = to_nibbles(key)
        node = self.root
        while node is not None:
            if isinstance(node, _Leaf):
                return node.value if node.nibbles == nib else None
            if isinstance(node, _Ext):
                if nib[: len(node.nibbles)] != node.nibbles:
                    return None
                nib = nib[len(node.nibbles) :]
                node = node.child
            else:
                if not nib:
                    return node.value or None
                node = node.children[nib[0]]
                if node is None:
                    return None
                nib = nib[1:]
        return None


def _common_len(a, b) -> int:
    n = 0
    while n < len(a) and n < len(b) and a[n] == b[n]:
        n += 1
    return n


def verify_proof(root_hash: bytes, key: bytes, proof: List[bytes], secure=True) -> Optional[bytes]:
    """Walk a proof (list of RLP node bodies) and return the value."""
    from mp2_tpu_torch.utils.rlp import decode as rlp_decode

    if secure:
        key = keccak256(key)
    nib = to_nibbles(key)
    expected = root_hash
    i = 0
    item = None
    while i < len(proof):
        body = proof[i]
        assert keccak256(body) == expected, f"hash mismatch at proof node {i}"
        item = rlp_decode(body)
        i += 1
        # walk inline nodes within this proof item
        while True:
            if len(item) == 2:
                hp = item[0]
                flag = hp[0] >> 4
                is_leaf = flag >= 2
                odd = flag % 2 == 1
                nibs = []
                if odd:
                    nibs.append(hp[0] & 0xF)
                for b in hp[1:]:
                    nibs.append(b >> 4)
                    nibs.append(b & 0xF)
                assert nib[: len(nibs)] == nibs, "path mismatch"
                nib = nib[len(nibs) :]
                if is_leaf:
                    assert not nib
                    return item[1]
                nxt = item[1]
            else:
                assert len(item) == 17
                if not nib:
                    return item[16]
                nxt = item[nib[0]]
                nib = nib[1:]
            if isinstance(nxt, bytes) and len(nxt) == 32:
                expected = nxt
                break  # next proof node
            assert isinstance(nxt, list), "dangling path"
            item = nxt
    raise AssertionError("proof exhausted before reaching the key")
