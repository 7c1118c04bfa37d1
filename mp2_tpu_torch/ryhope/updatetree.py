"""UpdateTree: the proving workplan — the reference's entire distributed-
scheduling abstraction (ryhope/src/storage/updatetree.rs:19-162; SURVEY.md
§2.9).

An UpdateTree is the union of the ascendance paths of all dirtied keys after
a transaction.  `into_workplan()` yields keys only when all their (in-plan)
children are done — siblings run in parallel, parents are blocked on
children.  The map-reduce scheduler (mp2_tpu_torch.parallel) consumes ready
batches level by level and dispatches them to device proof kernels.

A jax-free copy of `mp2_tpu/ryhope/updatetree.py`: only the imports change.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (
    Dict,
    Generic,
    Hashable,
    List,
    Optional,
    Sequence,
    Set,
    TypeVar,
    Union,
)

K = TypeVar("K", bound=Hashable)


@dataclass
class UpdateTree(Generic[K]):
    """Arena tree over the dirtied keys."""

    root: Optional[K]
    children_map: Dict[K, List[K]]  # key -> dirtied children (possibly empty)
    parent_map: Dict[K, Optional[K]]
    # keys that were the *dirtied end* of an inserted ascendance path (vs
    # pure pass-through ancestors); the reference's `is_path_end`
    path_ends: Set[K] = field(default_factory=set)

    @staticmethod
    def from_paths(paths: Sequence[Sequence[K]]) -> "UpdateTree[K]":
        """Build from ascendance paths (each leaf-to-root, root last)."""
        parent_map: Dict[K, Optional[K]] = {}
        path_ends: Set[K] = set()
        root: Optional[K] = None
        for path in paths:
            if not path:
                continue
            if root is None:
                root = path[-1]
            else:
                assert path[-1] == root, "paths must share the root"
            path_ends.add(path[0])
            for i, k in enumerate(path):
                parent_map[k] = path[i + 1] if i + 1 < len(path) else None
        children_map: Dict[K, List[K]] = {k: [] for k in parent_map}
        for k, p in parent_map.items():
            if p is not None:
                children_map[p].append(k)
        for v in children_map.values():
            v.sort(key=repr)
        return UpdateTree(root=root, children_map=children_map,
                          parent_map=parent_map, path_ends=path_ends)

    def keys(self) -> Set[K]:
        return set(self.parent_map.keys())

    def __len__(self):
        return len(self.parent_map)

    def into_workplan(self) -> "UpdatePlan[K]":
        return UpdatePlan(self)

    def into_batched_workplan(self, subtree_size: int) -> "BatchedUpdatePlan[K]":
        """Subtree-granular workplan (updatetree.rs:362-430): work items
        are whole COMPLETE pending subtrees of up to `subtree_size` nodes,
        so a worker can prove a B-sized batch bottom-up in one lease
        instead of one node per round trip.  `subtree_size=1` degenerates
        to single-node items (leaf-first traversal)."""
        assert subtree_size >= 1
        return BatchedUpdatePlan(self, subtree_size)


class UpdatePlan(Generic[K]):
    """Dependency-ordered iterator: `next_ready()` returns a batch of keys
    whose children are all done; `done(key)` releases parents.

    Equivalent to the reference's UpdatePlan with Next::{Ready, NotYet}
    (updatetree.rs:154-162), exposed batch-style for device dispatch.
    """

    def __init__(self, tree: UpdateTree[K]):
        self.tree = tree
        self._pending: Dict[K, int] = {
            k: len(cs) for k, cs in tree.children_map.items()
        }
        self._done: Set[K] = set()
        self._issued: Set[K] = set()

    def next_ready(self) -> List[K]:
        out = [
            k
            for k, cnt in self._pending.items()
            if cnt == 0 and k not in self._issued and k not in self._done
        ]
        out.sort(key=repr)
        self._issued.update(out)
        return out

    def done(self, key: K):
        assert key in self._issued and key not in self._done
        self._done.add(key)
        p = self.tree.parent_map.get(key)
        if p is not None:
            self._pending[p] -= 1

    def completed(self) -> bool:
        return len(self._done) == len(self.tree.parent_map)

    def __iter__(self):
        """Sequential iteration in a valid order (children before parents)."""
        while not self.completed():
            batch = self.next_ready()
            assert batch, "workplan deadlock"
            for k in batch:
                yield k
                self.done(k)


@dataclass
class WorkItem(Generic[K]):
    """One leased unit of a batched workplan (WorkplanItem role,
    updatetree.rs:371-385): either a single node or a complete pending
    subtree rooted at `key` (listed bottom-up, children before parents,
    so a worker proves `order` front to back)."""

    key: K
    subtree: Optional[UpdateTree[K]]  # None for single-node items
    order: List[K]  # valid bottom-up proving order (len 1 for nodes)
    is_path_end: bool = False

    @property
    def is_subtree(self) -> bool:
        return self.subtree is not None

    def __len__(self):
        return len(self.order)


class BatchedUpdatePlan(Generic[K]):
    """Subtree-granular dependency iterator (updatetree.rs UpdatePlan with
    WorkplanItem::Subtree).

    Anchors (= nodes whose pending children are all complete) expand
    upward to the furthest ancestor whose *entire pending subtree* (a)
    fits in `subtree_size` nodes and (b) contains no in-flight item —
    that subtree is spun off as one `WorkItem`.  `done(key)` completes
    an item and may promote its parent to an anchor."""

    def __init__(self, tree: UpdateTree[K], subtree_size: int):
        self.tree = tree
        self.size = subtree_size
        self._remaining: Set[K] = set(tree.parent_map.keys())
        # pending-children count per key, over remaining ∪ in-flight
        self._blockers: Dict[K, int] = {
            k: len(cs) for k, cs in tree.children_map.items()
        }
        self._inflight: Set[K] = set()  # spin-off roots leased, not done
        self._leased: Dict[K, List[K]] = {}  # root -> its item's nodes
        self._done: Set[K] = set()

    # ---- helpers over the remaining forest ------------------------------
    def _subtree_nodes(self, root: K, limit: int) -> Optional[List[K]]:
        """Remaining nodes under `root` bottom-up, or None if > limit or
        if the subtree overlaps an in-flight item (its nodes are already
        out of `_remaining` but not done — the parent must wait)."""
        out: List[K] = []

        def visit(k: K) -> bool:
            for c in self.tree.children_map.get(k, []):
                if c in self._done:
                    continue
                if c not in self._remaining:
                    return False  # in-flight below: not spinnable yet
                if not visit(c):
                    return False
            out.append(k)
            return len(out) <= limit

        return out if visit(root) else None

    def next_ready(self) -> List[WorkItem[K]]:
        """All currently-ready work items (each ≤ subtree_size nodes)."""
        anchors = [
            k for k in self._remaining
            if self._blockers.get(k, 0) == 0
        ]
        anchors.sort(key=repr)
        items: List[WorkItem[K]] = []
        for a in anchors:
            if a not in self._remaining:
                continue  # swallowed by an earlier anchor's subtree
            # climb to the furthest ancestor whose pending subtree fits
            spin = a
            while True:
                p = self.tree.parent_map.get(spin)
                if p is None or p in self._done or p not in self._remaining:
                    break
                if self._subtree_nodes(p, self.size) is None:
                    break
                spin = p
            order = self._subtree_nodes(spin, self.size)
            if order is None:  # anchor alone exceeds? only if size<1
                order = [spin]
            self._remaining.difference_update(order)
            self._inflight.add(spin)
            self._leased[spin] = list(order)
            if self.size == 1 or len(order) == 1:
                items.append(WorkItem(
                    key=spin, subtree=None, order=list(order),
                    is_path_end=spin in self.tree.path_ends,
                ))
            else:
                sub_parent: Dict[K, Optional[K]] = {}
                in_sub = set(order)
                for k in order:
                    p = self.tree.parent_map.get(k)
                    sub_parent[k] = p if (p in in_sub) else None
                sub_children: Dict[K, List[K]] = {k: [] for k in order}
                for k, p in sub_parent.items():
                    if p is not None:
                        sub_children[p].append(k)
                for v in sub_children.values():
                    v.sort(key=repr)
                items.append(WorkItem(
                    key=spin,
                    subtree=UpdateTree(
                        root=spin, children_map=sub_children,
                        parent_map=sub_parent,
                        path_ends=self.tree.path_ends & in_sub,
                    ),
                    order=list(order),
                    is_path_end=spin in self.tree.path_ends,
                ))
        return items

    def done(self, key: K):
        """Complete the item rooted at `key` (all its subtree nodes)."""
        assert key in self._inflight, f"{key!r} not in flight"
        self._inflight.discard(key)
        self._done.update(self._leased.pop(key))
        p = self.tree.parent_map.get(key)
        if p is not None:
            self._blockers[p] -= 1

    def completed(self) -> bool:
        return len(self._done) == len(self.tree.parent_map)

    def __iter__(self):
        """Sequential drain in a valid order, yielding WorkItems."""
        while not self.completed():
            batch = self.next_ready()
            assert batch, "batched workplan deadlock"
            for item in batch:
                yield item
                self.done(item.key)
