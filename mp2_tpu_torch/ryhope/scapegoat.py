"""Scapegoat BST keyed by arbitrary ordered keys (the rows-tree shape).

Role of ryhope's `tree::scapegoat` (the reference's ryhope/src/tree/
scapegoat.rs:19-40): a BST over the secondary index with tunable balance
alpha in [0.5, 1]; an insert deeper than log_{1/alpha}(size) triggers a
rebuild at the scapegoat ancestor (the first alpha-weight-unbalanced one);
deletions rebuild the whole tree when size < alpha * max_size.  mp2 tables
use alpha = 0.8 (reference tests/common/table.rs:252).

Rebuilds are deterministic (median split), so tree shape — and therefore
every node hash — is a pure function of the operation sequence.

A jax-free copy of `mp2_tpu/ryhope/scapegoat.py`: only the imports change.
"""

from __future__ import annotations

import math
from typing import Dict, Generic, Hashable, List, Optional, Tuple, TypeVar

K = TypeVar("K")


class _Node:
    __slots__ = ("left", "right", "parent")

    def __init__(self):
        self.left: Optional[K] = None
        self.right: Optional[K] = None
        self.parent: Optional[K] = None


class Scapegoat(Generic[K]):
    def __init__(self, alpha: float = 0.8):
        assert 0.5 <= alpha < 1.0
        self.alpha = alpha
        self.nodes: Dict[K, _Node] = {}
        self.root: Optional[K] = None
        self.max_size = 0

    # ------------------------------------------------------------- topology
    def size(self) -> int:
        return len(self.nodes)

    def contains(self, key: K) -> bool:
        return key in self.nodes

    def parent(self, key: K) -> Optional[K]:
        return self.nodes[key].parent

    def children(self, key: K) -> Tuple[Optional[K], Optional[K]]:
        n = self.nodes[key]
        return (n.left, n.right)

    def ascendance(self, key: K) -> List[K]:
        out = [key]
        p = self.nodes[key].parent
        while p is not None:
            out.append(p)
            p = self.nodes[p].parent
        return out

    def keys(self):
        return self.nodes.keys()

    def subtree_keys(self, key: K) -> List[K]:
        """In-order keys of the subtree rooted at key."""
        out: List[K] = []
        stack = [(key, False)]
        while stack:
            k, visited = stack.pop()
            if k is None:
                continue
            n = self.nodes[k]
            if visited:
                out.append(k)
            else:
                stack.append((n.right, False))
                stack.append((k, True))
                stack.append((n.left, False))
        return out

    def _depth_limit(self) -> int:
        if self.size() <= 1:
            return 0
        return int(math.floor(math.log(self.size()) / math.log(1 / self.alpha)))

    # ------------------------------------------------------------- mutation
    def insert(self, key: K) -> List[K]:
        """Insert; returns the set of dirtied keys (path + any rebuilt
        subtree)."""
        assert key not in self.nodes
        self.nodes[key] = _Node()
        if self.root is None:
            self.root = key
            self.max_size = max(self.max_size, 1)
            return [key]
        # BST descent
        path: List[K] = []
        cur = self.root
        while True:
            path.append(cur)
            n = self.nodes[cur]
            if key < cur:
                if n.left is None:
                    n.left = key
                    self.nodes[key].parent = cur
                    break
                cur = n.left
            else:
                if n.right is None:
                    n.right = key
                    self.nodes[key].parent = cur
                    break
                cur = n.right
        self.max_size = max(self.max_size, self.size())
        depth = len(path)
        if depth > self._depth_limit():
            sg = self._find_scapegoat(path + [key])
            if sg is not None:
                rebuilt = self._rebuild_at(sg)
                return sorted(set(self.ascendance(key)) | set(rebuilt), key=self._sort_key)
        return self.ascendance(key)

    def remove(self, key: K) -> List[K]:
        """Standard BST delete; whole-tree rebuild when size shrinks below
        alpha * max_size.  Returns dirtied keys (in the new tree)."""
        n = self.nodes[key]
        dirtied_parent = n.parent
        if n.left is not None and n.right is not None:
            # replace with in-order successor
            succ = n.right
            while self.nodes[succ].left is not None:
                succ = self.nodes[succ].left
            sp = self.nodes[succ].parent
            dirtied_parent = sp if sp != key else succ
            self._detach(succ)
            # put succ in key's place
            self._replace(key, succ)
        else:
            child = n.left if n.left is not None else n.right
            self._splice(key, child)
        del self.nodes[key]
        if self.root is None:
            self.max_size = 0
            return []
        if self.size() < self.alpha * self.max_size:
            out = self._rebuild_at(self.root)
            self.max_size = self.size()
            return out
        if dirtied_parent is None or dirtied_parent not in self.nodes:
            return [self.root] if self.root is not None else []
        return self.ascendance(dirtied_parent)

    def _sort_key(self, k):
        return k

    def _detach(self, key: K):
        """Remove a node with at most a right child from its parent."""
        n = self.nodes[key]
        assert n.left is None
        self._splice(key, n.right)

    def _splice(self, key: K, child: Optional[K]):
        n = self.nodes[key]
        p = n.parent
        if child is not None:
            self.nodes[child].parent = p
        if p is None:
            self.root = child
        else:
            pn = self.nodes[p]
            if pn.left == key:
                pn.left = child
            else:
                pn.right = child
        n.parent = None
        n.left = None
        n.right = None

    def _replace(self, old: K, new: K):
        """Put `new` (detached) where `old` sits."""
        on = self.nodes[old]
        nn = self.nodes[new]
        nn.left, nn.right, nn.parent = on.left, on.right, on.parent
        if nn.left is not None:
            self.nodes[nn.left].parent = new
        if nn.right is not None:
            self.nodes[nn.right].parent = new
        if nn.parent is None:
            self.root = new
        else:
            pn = self.nodes[nn.parent]
            if pn.left == old:
                pn.left = new
            else:
                pn.right = new

    def _subtree_size(self, key: K) -> int:
        return len(self.subtree_keys(key))

    def _find_scapegoat(self, path: List[K]) -> Optional[K]:
        """First ancestor (walking up from the inserted leaf) whose on-path
        child exceeds the alpha-weight bound; falls back to the root."""
        for i in range(len(path) - 1, 0, -1):
            child, anc = path[i], path[i - 1]
            if self._subtree_size(child) > self.alpha * self._subtree_size(anc):
                return anc
        return path[0]

    def _rebuild_at(self, key: K) -> List[K]:
        """Rebuild the subtree at key to perfect median balance; returns the
        rebuilt keys."""
        parent = self.nodes[key].parent
        keys = self.subtree_keys(key)
        # detach
        for k in keys:
            n = self.nodes[k]
            n.left = n.right = n.parent = None

        def build(lo: int, hi: int, par: Optional[K]) -> Optional[K]:
            if lo > hi:
                return None
            mid = (lo + hi + 1) // 2
            k = keys[mid]
            n = self.nodes[k]
            n.parent = par
            n.left = build(lo, mid - 1, k)
            n.right = build(mid + 1, hi, k)
            return k

        new_root = build(0, len(keys) - 1, parent)
        if parent is None:
            self.root = new_root
        else:
            pn = self.nodes[parent]
            # reattach on the correct side
            if new_root < parent:
                pn.left = new_root
            else:
                pn.right = new_root
        return keys
