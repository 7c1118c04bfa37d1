"""MerkleTreeKvDb: epoch-versioned Merkle tree store with transactional
updates producing proving workplans.

Role of ryhope's `MerkleTreeKvDb` facade (the reference's ryhope/src/lib.rs:
104-630): every committed transaction
  1. mutates the tree topology (sbbst append / scapegoat insert-remove),
  2. re-aggregates payloads bottom-up over the dirtied keys
     (`NodePayload::aggregate` hook, lib.rs:66-82),
  3. snapshots the new epoch (epoch-versioned reads: view_at / root_at /
     lineage_at),
  4. returns the `UpdateTree` of dirtied lineage — the proving workplan
     (commit_transaction, lib.rs:567-581).

Storage is a pluggable BACKEND behind one facade (the reference's
`MerkleTreeKvDb<T, V, S: storage>` shape, lib.rs:119): `MemoryBackend`
(storage::memory role) keeps per-epoch snapshots in RAM;
`mp2_tpu_torch.ryhope.pgsql.SqlBackend` (storage::pgsql role) persists the COW
row-versioned SQL layout with a bounded read cache (CachedDbStore role,
storage/pgsql/storages.rs).  Tree semantics (commit, aggregation,
workplans, views, rollback, diff) live HERE once; backends only move
epochs in and out.

A jax-free copy of `mp2_tpu/ryhope/kvdb.py`: only the imports change.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Generic, List, Optional, Tuple, TypeVar

from mp2_tpu_torch.ryhope.updatetree import UpdateTree

K = TypeVar("K")
V = TypeVar("V")

# aggregate(key, payload, child_payloads: [left, right]) -> new payload
AggregateFn = Callable[[K, V, List[Optional[V]]], V]


@dataclass
class TreeView(Generic[K, V]):
    """Read-only projection of the DB at one epoch."""

    tree: object
    payloads: Dict[K, V]
    epoch: int

    def root(self) -> Optional[K]:
        return _tree_root(self.tree)

    def payload(self, key: K) -> V:
        return self.payloads[key]

    def try_payload(self, key: K) -> Optional[V]:
        return self.payloads.get(key)

    def children(self, key: K):
        return self.tree.children(key)

    def parent(self, key: K):
        return self.tree.parent(key)

    def lineage(self, key: K) -> List[K]:
        return self.tree.ascendance(key)

    def size(self) -> int:
        return self.tree.size()

    def keys(self):
        return list(self.tree.keys())


def _tree_root(tree):
    if hasattr(tree, "root_inner"):
        return tree.root() if tree.size() else None
    return tree.root


class Transaction(Generic[K, V]):
    def __init__(self):
        self.stores: Dict[K, V] = {}
        self.removals: List[K] = []

    def store(self, key: K, payload: V):
        self.stores[key] = payload

    def remove(self, key: K):
        self.removals.append(key)


class MemoryBackend(Generic[K, V]):
    """storage::memory role: one (tree, payloads) snapshot per epoch."""

    def __init__(self):
        self._snapshots: List[Tuple[object, Dict[K, V]]] = []

    def store_epoch(self, epoch: int, tree, payloads: Dict[K, V],
                    changed: Dict[K, V], removed: List[K], root,
                    user_epoch: Optional[int] = None) -> None:
        assert epoch == len(self._snapshots)
        self._snapshots.append((copy.deepcopy(tree), dict(payloads)))

    def load_epoch(self, epoch: int):
        t, p = self._snapshots[epoch]
        return t, p

    def diff_at(self, epoch: int):
        _, cur = self._snapshots[epoch]
        prev = self._snapshots[epoch - 1][1] if epoch > 0 else {}
        changed = {
            k: v for k, v in cur.items()
            if k not in prev or prev[k] is not v
        }
        removed = [k for k in prev if k not in cur]
        return changed, removed

    def rollback_to(self, epoch: int):
        del self._snapshots[epoch + 1:]
        t, p = self._snapshots[epoch]
        return copy.deepcopy(t), dict(p)


class TeeBackend(Generic[K, V]):
    """Write to every backend, read from the first (the attach_pgsql
    mirroring discipline: memory stays authoritative, SQL is persisted)."""

    def __init__(self, backends):
        self.backends = list(backends)

    def store_epoch(self, *a, **kw):
        for b in self.backends:
            b.store_epoch(*a, **kw)

    def load_epoch(self, epoch: int):
        return self.backends[0].load_epoch(epoch)

    def diff_at(self, epoch: int):
        return self.backends[0].diff_at(epoch)

    def rollback_to(self, epoch: int):
        out = None
        for b in self.backends:
            r = b.rollback_to(epoch)
            out = out or r
        return out


class MerkleTreeKvDb(Generic[K, V]):
    def __init__(self, tree, aggregate: AggregateFn, backend=None):
        self.tree = tree
        self.aggregate = aggregate
        self.payloads: Dict[K, V] = {}
        self.epoch = -1
        self.backend = backend if backend is not None else MemoryBackend()

    # ------------------------------------------------------------- reads
    def current_view(self) -> TreeView:
        return TreeView(self.tree, self.payloads, self.epoch)

    def view_at(self, epoch: int) -> TreeView:
        assert 0 <= epoch <= self.epoch
        t, p = self.backend.load_epoch(epoch)
        return TreeView(t, p, epoch)

    def root(self) -> Optional[K]:
        return _tree_root(self.tree)

    def root_at(self, epoch: int) -> Optional[K]:
        return self.view_at(epoch).root()

    def root_payload(self) -> Optional[V]:
        r = self.root()
        return None if r is None else self.payloads[r]

    def payload(self, key: K) -> V:
        return self.payloads[key]

    def try_payload(self, key: K) -> Optional[V]:
        return self.payloads.get(key)

    def lineage_at(self, key: K, epoch: int) -> List[K]:
        return self.view_at(epoch).lineage(key)

    def wide_lineage_between(self, epoch: int, keys) -> Dict[K, V]:
        """Bulk-fetch the union of the ascendance paths of `keys` at an
        epoch, with payloads (reference: ryhope lib.rs:435 — the query
        planner's one-shot touched-nodes fetch)."""
        view = self.view_at(epoch)
        out: Dict[K, V] = {}
        for k in keys:
            if not view.tree.contains(k):
                continue
            for a in view.lineage(k):
                if a not in out:
                    out[a] = view.payload(a)
        return out

    def size(self) -> int:
        return self.tree.size()

    def contains(self, key: K) -> bool:
        return key in self.payloads

    # ------------------------------------------------------------- writes
    def in_transaction(self, fn: Callable[[Transaction], None]) -> UpdateTree:
        tx = Transaction()
        fn(tx)
        return self._commit(tx)

    def _commit(self, tx: Transaction) -> UpdateTree:
        dirtied: set = set()
        for key in tx.removals:
            assert key in self.payloads, f"removing unknown key {key}"
            del self.payloads[key]
            dirtied.update(self.tree.remove(key))
            dirtied.discard(key)
        for key, payload in tx.stores.items():
            if key not in self.payloads:
                path = self.tree.insert(key)
                dirtied.update(path)
            else:
                dirtied.update(self.tree.ascendance(key))
            self.payloads[key] = payload
        # removals may have dirtied keys later removed or re-added; keep only
        # keys still in the tree
        dirtied = {k for k in dirtied if self.tree.contains(k)}
        # ascendance closure (a dirtied child re-aggregates all ancestors)
        closure = set()
        for k in dirtied:
            closure.update(self.tree.ascendance(k))
        paths = [self.tree.ascendance(k) for k in sorted(closure, key=repr)]
        ut = UpdateTree.from_paths(paths)
        # bottom-up re-aggregation in workplan order.  Aggregate on a copy:
        # payload objects are shared with earlier epoch snapshots and must
        # stay immutable once snapshotted.
        for key in ut.into_workplan():
            l, r = self.tree.children(key)
            childs = [
                self.payloads.get(l) if l is not None else None,
                self.payloads.get(r) if r is not None else None,
            ]
            self.payloads[key] = self.aggregate(
                key, copy.copy(self.payloads[key]), childs
            )
        # persist the epoch through the backend seam
        self.epoch += 1
        changed = {
            k: self.payloads[k]
            for k in set(tx.stores) | {kk for kk in closure}
            if k in self.payloads
        }
        removed = [k for k in tx.removals if k not in self.payloads]
        self.backend.store_epoch(
            self.epoch, self.tree, self.payloads, changed, removed,
            self.root(), user_epoch=getattr(tx, "user_epoch", None),
        )
        return ut

    def diff_at(self, epoch: int):
        """(changed, removed) at `epoch` vs the previous epoch (the
        reference's `diff_at`, ryhope/src/lib.rs)."""
        assert 0 <= epoch <= self.epoch
        return self.backend.diff_at(epoch)

    def rollback_to(self, epoch: int):
        """Reference: storage/mod.rs:430-480."""
        assert 0 <= epoch <= self.epoch
        t, p = self.backend.rollback_to(epoch)
        self.tree = t
        self.payloads = dict(p)
        self.epoch = epoch
