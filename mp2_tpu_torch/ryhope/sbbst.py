"""Saturated balanced BST keyed by consecutive integers (block numbers).

Host-side tree topology with closed-form parent/child arithmetic — the
append-only index-tree shape of the verifiable DB (role of ryhope's
`tree::sbbst`, the reference's ryhope/src/tree/sbbst.rs:1-47: a node's layer
is the 2-adic valuation of its index; parents differ by +-2^layer; the
unsaturated case follows the saturated lineage until it re-enters the tree).

Keys are 1-based inner indices shifted by `shift` (user keys are
`shift + inner`): an `EpochTree` uses shift = first_block - 1.
Appending node n+1 dirties only its ascendance path: O(log n) nodes.

A jax-free copy of `mp2_tpu/ryhope/sbbst.py`: only the imports change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple


def _level(n: int) -> int:
    """2-adic valuation (layer index)."""
    assert n >= 1
    return (n & -n).bit_length() - 1


def _parent_saturated(n: int) -> int:
    t = _level(n)
    rank = (n - (1 << t)) >> (t + 1)
    return n + (1 << t) if rank % 2 == 0 else n - (1 << t)


class Sbbst:
    """Topology + mutation over inner indices 1..max (0 = empty)."""

    def __init__(self, shift: int = 0, n: int = 0):
        self.shift = shift
        self.n = n  # number of nodes (max inner index)

    # -- key translation ----------------------------------------------------
    def to_inner(self, key: int) -> int:
        return key - self.shift

    def to_user(self, inner: int) -> int:
        return inner + self.shift

    # -- topology (inner indices) ------------------------------------------
    def root_inner(self) -> int:
        assert self.n >= 1
        # highest power of two <= n
        return 1 << (self.n.bit_length() - 1)

    def parent_inner(self, k: int) -> Optional[int]:
        assert 1 <= k <= self.n
        if k == self.root_inner():
            return None
        p = _parent_saturated(k)
        while p > self.n:
            p = _parent_saturated(p)
        return p

    def children_inner(self, k: int) -> Tuple[Optional[int], Optional[int]]:
        t = _level(k)
        if t == 0:
            return (None, None)
        left = k - (1 << (t - 1))
        right = k + (1 << (t - 1))
        # left always <= k - 1 <= n; right may overflow: descend its left
        # lineage in the saturated tree until it re-enters the tree
        while right > self.n:
            tt = _level(right)
            if tt == 0:
                return (left, None)
            right = right - (1 << (tt - 1))
        if right <= k:
            return (left, None)
        return (left, right)

    def ascendance_inner(self, k: int) -> List[int]:
        """Path from k (inclusive) to the root."""
        out = [k]
        p = self.parent_inner(k)
        while p is not None:
            out.append(p)
            p = self.parent_inner(p)
        return out

    def depth_inner(self, k: int) -> int:
        return len(self.ascendance_inner(k)) - 1

    # -- user-key facade ----------------------------------------------------
    def root(self) -> int:
        return self.to_user(self.root_inner())

    def parent(self, key: int) -> Optional[int]:
        p = self.parent_inner(self.to_inner(key))
        return None if p is None else self.to_user(p)

    def children(self, key: int) -> Tuple[Optional[int], Optional[int]]:
        l, r = self.children_inner(self.to_inner(key))
        return (
            None if l is None else self.to_user(l),
            None if r is None else self.to_user(r),
        )

    def contains(self, key: int) -> bool:
        return 1 <= self.to_inner(key) <= self.n

    def keys(self) -> Iterator[int]:
        return (self.to_user(i) for i in range(1, self.n + 1))

    def size(self) -> int:
        return self.n

    def ascendance(self, key: int) -> List[int]:
        return [self.to_user(i) for i in self.ascendance_inner(self.to_inner(key))]

    # -- mutation -----------------------------------------------------------
    def insert(self, key: int) -> List[int]:
        """Append-only insert; key must be max+1.  Returns the dirtied keys
        (the new node's ascendance in the post-insert tree)."""
        inner = self.to_inner(key)
        if self.n == 0 and inner != 1:
            # first insertion fixes the shift
            self.shift = key - 1
            inner = 1
        assert inner == self.n + 1, f"sbbst is append-only (got {key})"
        self.n += 1
        return self.ascendance(key)
