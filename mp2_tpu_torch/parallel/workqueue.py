"""Multi-host proof work queue: the DCN-side distribution layer.

The reference has no in-repo distribution — leaf/aggregation proof jobs are
farmed to the external Lagrange worker network as serialized `CircuitInput`
bytes and come back as stateless `ProofWithVK` envelopes
(mp2-v1/src/api.rs:154-212, mp2-common/src/proof.rs:42); the only ordering
constraint is the ryhope `UpdateTree` workplan (children before parents,
ryhope/src/storage/updatetree.rs:154-162).

This module is the TPU-pod equivalent: one coordinator per proving job
drains the workplan and LEASES ready items to worker hosts over TCP (the
data-center network between TPU hosts; intra-host parallelism is the
device mesh; in the port, each worker host's cards).  Every message is a
JSON line; every payload is opaque serialized bytes (base64) so workers are
stateless, like the reference's worker protocol.

Failure model (SURVEY.md §5 "recovery is architectural"): a worker that
dies mid-lease simply never completes it; the coordinator re-queues the
item after `lease_timeout`.  Completed proofs are idempotent — a late
duplicate completion is accepted if byte-identical, rejected otherwise.

A copy of `mp2_tpu/parallel/workqueue.py` (which imports nothing of its
package): `api.generate_proof` on the card is the port's `prove`.
"""

from __future__ import annotations

import base64
import json
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Tuple


def _encode(obj) -> bytes:
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


@dataclass
class _Item:
    key: str
    circuit: str
    payload: bytes
    deps: List[str]
    leased_at: Optional[float] = None
    worker: Optional[str] = None
    done: bool = False
    result: Optional[bytes] = None


@dataclass
class QueueStats:
    leased: int = 0
    completed: int = 0
    requeued: int = 0
    rejected: int = 0


class WorkQueue:
    """Dependency-aware lease queue (the UpdateTree discipline over DCN).

    Items are (key, circuit, payload, deps): an item becomes READY when all
    its deps are completed.  `lease(worker)` hands out up to `max_batch`
    ready items; `complete(key, result)` marks one done.  Leases expire
    after `lease_timeout` seconds and the item is re-queued (failure
    recovery)."""

    def __init__(self, lease_timeout: float = 30.0, max_batch: int = 8):
        self.lease_timeout = lease_timeout
        self.max_batch = max_batch
        self._items: Dict[str, _Item] = {}
        self._lock = threading.Lock()
        self.stats = QueueStats()

    # ----------------------------------------------------------- producer
    def add(self, key: str, circuit: str, payload: bytes,
            deps: List[str] = ()) -> None:
        with self._lock:
            assert key not in self._items, f"duplicate item {key}"
            for d in deps:
                assert d in self._items, f"unknown dep {d} of {key}"
            self._items[key] = _Item(key, circuit, payload, list(deps))

    def add_update_tree(self, tree,
                        classify: Callable[[Hashable], Tuple[str, bytes]]):
        """Load a ryhope UpdateTree: every dirtied key becomes an item
        whose deps are its dirtied children (children-before-parents, the
        into_workplan discipline)."""
        order: List[Hashable] = []

        def visit(k):
            for c in tree.children_map.get(k, []):
                visit(c)
            order.append(k)

        if tree.root is not None:
            visit(tree.root)
        for key in order:
            circuit, payload = classify(key)
            deps = [str(c) for c in tree.children_map.get(key, [])]
            self.add(str(key), circuit, payload, deps)

    def add_batched_workplan(
        self, tree, subtree_size: int,
        classify: Callable[[Hashable], Tuple[str, bytes]],
    ) -> int:
        """Load a ryhope UpdateTree at SUBTREE granularity
        (into_batched_workplan, updatetree.rs:362-430): each queue item is
        a complete pending subtree of <= subtree_size nodes, leased as one
        unit so a worker proves a B-sized batch bottom-up per round trip.

        The item payload is a JSON envelope:
          {"root": key, "order": [keys bottom-up],
           "nodes": {key: {"circuit": .., "payload": b64,
                           "children": [keys]}}}
        where `children` lists the node's dirtied children in the FULL
        update tree (possibly owned by dependency items).  Returns the
        number of items queued."""
        plan = tree.into_batched_workplan(subtree_size)
        items = list(plan)  # sequential drain fixes the partition
        owner: Dict[str, str] = {}
        for item in items:
            for k in item.order:
                owner[str(k)] = str(item.key)
        for item in items:
            in_item = {str(k) for k in item.order}
            deps = set()
            nodes = {}
            for k in item.order:
                circuit, payload = classify(k)
                kids = [str(c) for c in tree.children_map.get(k, [])]
                nodes[str(k)] = {
                    "circuit": circuit, "payload": _b64(payload),
                    "children": kids,
                }
                for c in kids:
                    if c not in in_item:
                        deps.add(owner[c])
            env = json.dumps({
                "root": str(item.key),
                "order": [str(k) for k in item.order],
                "nodes": nodes,
            }).encode()
            self.add(str(item.key), "subtree", env, sorted(deps))
        return len(items)

    # ----------------------------------------------------------- consumer
    def _ready(self, it: _Item, now: float) -> bool:
        if it.done:
            return False
        if it.leased_at is not None:
            if now - it.leased_at < self.lease_timeout:
                return False
            it.leased_at = None  # lease expired: re-queue
            it.worker = None
            self.stats.requeued += 1
        return all(self._items[d].done for d in it.deps)

    def lease(self, worker: str) -> List[dict]:
        now = time.monotonic()
        out = []
        with self._lock:
            for it in self._items.values():
                if len(out) >= self.max_batch:
                    break
                if self._ready(it, now):
                    it.leased_at = now
                    it.worker = worker
                    self.stats.leased += 1
                    out.append(
                        {"key": it.key, "circuit": it.circuit,
                         "payload": _b64(it.payload)}
                    )
        return out

    def complete(self, key: str, result: bytes) -> bool:
        with self._lock:
            it = self._items[key]
            if it.done:
                ok = it.result == result
                if not ok:
                    self.stats.rejected += 1
                return ok  # idempotent duplicate
            it.done = True
            it.result = result
            it.leased_at = None
            self.stats.completed += 1
            return True

    def pending(self) -> int:
        with self._lock:
            return sum(1 for it in self._items.values() if not it.done)

    def results(self) -> Dict[str, bytes]:
        with self._lock:
            return {
                k: it.result for k, it in self._items.items() if it.done
            }


# --------------------------------------------------------------- TCP layer


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        q: WorkQueue = self.server.queue  # type: ignore[attr-defined]
        for line in self.rfile:
            try:
                msg = json.loads(line)
                op = msg["op"]
                if op == "lease":
                    items = q.lease(msg.get("worker", "?"))
                    resp = {"ok": True, "items": items,
                            "pending": q.pending()}
                elif op == "complete":
                    ok = q.complete(msg["key"], _unb64(msg["result"]))
                    resp = {"ok": ok, "pending": q.pending()}
                elif op == "status":
                    resp = {"ok": True, "pending": q.pending(),
                            "stats": vars(q.stats)}
                else:
                    resp = {"ok": False, "error": f"unknown op {op}"}
            except Exception as e:  # malformed request: report, keep serving
                resp = {"ok": False, "error": str(e)}
            self.wfile.write(_encode(resp))
            self.wfile.flush()


class Coordinator:
    """Serves a WorkQueue over TCP.  One per proving job; workers on other
    hosts connect with `WorkerClient`."""

    def __init__(self, queue: WorkQueue, host: str = "127.0.0.1",
                 port: int = 0):
        self.queue = queue
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        self._srv.daemon_threads = True
        self._srv.queue = queue  # type: ignore[attr-defined]
        self.address = self._srv.server_address
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


class WorkerClient:
    """A proving worker: lease -> prove -> complete loop.

    `prove(circuit_name, payload_bytes) -> result_bytes` is the host's
    batched prover entry (typically wrapping prover.batch over the local
    device mesh)."""

    def __init__(self, address, name: str = "worker"):
        self.name = name
        self._sock = socket.create_connection(address)
        self._rfile = self._sock.makefile("rb")

    def _rpc(self, msg: dict) -> dict:
        self._sock.sendall(_encode(msg))
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("coordinator closed the connection")
        return json.loads(line)

    def lease(self) -> List[dict]:
        r = self._rpc({"op": "lease", "worker": self.name})
        assert r["ok"], r
        return r["items"]

    def complete(self, key: str, result: bytes) -> bool:
        r = self._rpc({"op": "complete", "key": key,
                       "result": _b64(result)})
        return bool(r["ok"])

    def pending(self) -> int:
        return int(self._rpc({"op": "status"})["pending"])

    def run(self, prove: Callable[[str, bytes], bytes],
            die_after: Optional[int] = None) -> int:
        """Drain the queue; returns the number of items proved.
        `die_after`: abandon after N completions WITHOUT completing the
        last lease (fault-injection hook for tests)."""
        done = 0
        while True:
            items = self.lease()
            if not items:
                if self.pending() == 0:
                    return done
                time.sleep(0.01)  # blocked on other workers' items
                continue
            for it in items:
                result = prove(it["circuit"], _unb64(it["payload"]))
                if die_after is not None and done >= die_after:
                    return done  # crash mid-lease: item must be re-queued
                self.complete(it["key"], result)
                done += 1

    def close(self):
        self._sock.close()
