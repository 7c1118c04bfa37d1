"""The port's work queue (`parallel/workqueue.py`) against mp2_tpu on the CPU.

The cases of tests/test_workqueue.py and tests/test_batched_workplan.py run
on the port's copy over the port's ryhope trees: dependency-ordered leasing
over TCP, several workers sharing one queue, a dead worker's lease expiring
and being re-queued, idempotent completion, subtree-granular workplans and
their leases, and real worker processes (which import only
`mp2_tpu_torch.parallel.workqueue`) with one killed mid-lease.  Where both
packages run the same case deterministically (one worker), the order in
which items are leased and the results must be equal.  The tolerance is 0:
every compared value is a key, a byte string or a count.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import pytest

import mp2_tpu.parallel.workqueue as jworkqueue
import mp2_tpu.ryhope.sbbst as jsbbst
import mp2_tpu.ryhope.updatetree as jupdatetree
import mp2_tpu_torch.parallel.workqueue as workqueue
import mp2_tpu_torch.ryhope.sbbst as sbbst
import mp2_tpu_torch.ryhope.updatetree as updatetree

PKGS = {"port": SimpleNamespace(wq=workqueue, Sbbst=sbbst.Sbbst, UT=updatetree.UpdateTree),
        "ref": SimpleNamespace(wq=jworkqueue, Sbbst=jsbbst.Sbbst, UT=jupdatetree.UpdateTree)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _prove(circuit: str, payload: bytes) -> bytes:
    return hashlib.sha256(circuit.encode() + payload).digest()


def _subtree_prove(circuit: str, payload: bytes) -> bytes:
    """Prove a whole leased subtree bottom-up; the result binds every node."""
    assert circuit == "subtree"
    env = json.loads(payload)
    acc = b""
    for k in env["order"]:
        node = env["nodes"][k]
        acc = hashlib.sha256(acc + node["circuit"].encode() + node["payload"].encode()).digest()
    return acc


def _tree(pkg, n=31, step=2):
    m = PKGS[pkg]
    t = m.Sbbst(n=n)
    return t, m.UT.from_paths([t.ascendance(k) for k in range(1, n + 1, step)])


def _queue(pkg, n=15, **kw):
    """tests/test_workqueue.py's queue: an update tree over every other key
    of an n-node sbbst, each key an item."""
    t, ut = _tree(pkg, n)
    q = PKGS[pkg].wq.WorkQueue(**kw)

    def classify(key):
        l, r = t.children(key)
        return ("leaf" if l is None and r is None else "node"), str(key).encode()

    q.add_update_tree(ut, classify)
    return q, ut


def _drain_one_worker(pkg):
    q, ut = _queue(pkg)
    coord = PKGS[pkg].wq.Coordinator(q)
    seen = []

    def prove(circuit, payload):
        seen.append((circuit, payload.decode()))
        return _prove(circuit, payload)

    w = PKGS[pkg].wq.WorkerClient(coord.address, "w0")
    done = w.run(prove)
    w.close()
    coord.close()
    return q, ut, done, seen


def test_single_worker_drains_in_dependency_order_as_reference():
    q, ut, done, seen = _drain_one_worker("port")
    _, _, jdone, jseen = _drain_one_worker("ref")
    assert done == jdone == len(ut) and q.pending() == 0
    pos = {k: i for i, (_, k) in enumerate(seen)}
    for parent, kids in ut.children_map.items():
        for c in kids:
            assert pos[str(c)] < pos[str(parent)]
    assert seen == jseen
    res = q.results()
    assert len(res) == len(ut)
    assert res == {k: _prove(c, k.encode()) for c, k in seen}


def test_multiple_workers_share_the_queue():
    q, ut = _queue("port", n=31, max_batch=2)
    coord = workqueue.Coordinator(q)
    counts = {}

    def run(name):
        w = workqueue.WorkerClient(coord.address, name)
        counts[name] = w.run(_prove)
        w.close()

    threads = [threading.Thread(target=run, args=(f"w{i}",)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert q.pending() == 0
    assert sum(counts.values()) == len(ut)
    coord.close()


def test_dead_worker_lease_requeued():
    q, ut = _queue("port", lease_timeout=0.2)
    coord = workqueue.Coordinator(q)
    w0 = workqueue.WorkerClient(coord.address, "dies")
    w0.run(_prove, die_after=3)  # abandons a lease
    w0.close()
    assert q.pending() > 0
    w1 = workqueue.WorkerClient(coord.address, "finisher")
    w1.run(_prove)
    w1.close()
    assert q.pending() == 0 and q.stats.requeued >= 1
    assert len(q.results()) == len(ut)
    coord.close()


def _duplicates(pkg):
    wq = PKGS[pkg].wq
    q = wq.WorkQueue()
    q.add("a", "leaf", b"x")
    coord = wq.Coordinator(q)
    w = wq.WorkerClient(coord.address, "w")
    items = w.lease()
    r = _prove("leaf", b"x")
    out = [items, w.complete("a", r), w.complete("a", r), w.complete("a", b"bad"),
           vars(q.stats), w.pending()]
    w.close()
    coord.close()
    return out


def test_duplicate_completion_idempotent_as_reference():
    out = _duplicates("port")
    assert out == _duplicates("ref")
    items, first, dup, bad, stats, pending = out
    assert [it["key"] for it in items] == ["a"]
    assert first and dup and not bad
    assert stats["rejected"] == 1 and pending == 0


# ------------------------------------------------------------ plan semantics


def _items(pkg, size):
    _, ut = _tree(pkg)
    return ut, list(ut.into_batched_workplan(size))


def _plan(items):
    return [(it.key, list(it.order), it.is_subtree, it.is_path_end) for it in items]


def test_batch_size_one_is_node_traversal():
    ut, items = _items("port", 1)
    assert all(not it.is_subtree and len(it.order) == 1 for it in items)
    flat = [it.key for it in items]
    assert set(flat) == ut.keys() and len(flat) == len(ut)
    pos = {k: i for i, k in enumerate(flat)}
    for parent, kids in ut.children_map.items():
        for c in kids:
            assert pos[c] < pos[parent]
    assert _plan(items) == _plan(_items("ref", 1)[1])


@pytest.mark.parametrize("size", [2, 3, 4, 8, 64, 10_000])
def test_subtree_items_partition_and_respect_size(size):
    ut, items = _items("port", size)
    seen = []
    for it in items:
        assert 1 <= len(it.order) <= size
        pos = {k: i for i, k in enumerate(it.order)}
        for k in it.order:
            for c in ut.children_map.get(k, []):
                if c in pos:
                    assert pos[c] < pos[k]
        assert it.order[-1] == it.key
        if it.is_subtree:
            assert it.subtree.root == it.key
            assert set(it.subtree.parent_map) == set(it.order)
        seen.extend(it.order)
    assert len(seen) == len(set(seen)) == len(ut)
    done = set()
    for it in items:
        for k in it.order:
            for c in ut.children_map.get(k, []):
                assert c in done or c in it.order
        done.update(it.order)
    if size == 10_000:
        assert len(items) == 1 and items[0].key == ut.root
    assert _plan(items) == _plan(_items("ref", size)[1])


def test_concurrent_leasing_blocks_parent_until_done():
    _, ut = _tree("port")
    plan = ut.into_batched_workplan(4)
    first = plan.next_ready()
    assert first
    assert plan.next_ready() == []
    total = {k for it in first for k in it.order}
    in_flight = list(first)
    while not plan.completed():
        it = in_flight.pop(0)
        plan.done(it.key)
        more = plan.next_ready()
        for m in more:
            for k in m.order:
                for c in ut.children_map.get(k, []):
                    assert c in plan._done or c in m.order
            total.update(m.order)
        in_flight.extend(more)
    assert total == ut.keys()


def test_path_ends_tracked():
    t, ut = _tree("port", n=15, step=2)
    dirtied = {t.ascendance(k)[0] for k in range(1, 16, 2)}
    assert ut.path_ends == dirtied
    ends = {it.key for it in ut.into_batched_workplan(1) if it.is_path_end}
    assert ends == dirtied


# ------------------------------------------------- queue-level subtree lease


def _subtree_queue(pkg):
    _, ut = _tree(pkg)
    q = PKGS[pkg].wq.WorkQueue(max_batch=4)
    n_items = q.add_batched_workplan(ut, 4, lambda k: ("node", str(k).encode()))
    coord = PKGS[pkg].wq.Coordinator(q)
    w = PKGS[pkg].wq.WorkerClient(coord.address, "w0")
    leased = []

    def prove(circuit, payload):
        leased.append(json.loads(payload)["root"])
        return _subtree_prove(circuit, payload)

    done = w.run(prove)
    w.close()
    coord.close()
    return ut, q, n_items, done, leased


def test_queue_leases_subtrees_as_reference():
    ut, q, n_items, done, leased = _subtree_queue("port")
    _, jq, jn_items, jdone, jleased = _subtree_queue("ref")
    assert 1 < n_items < len(ut)
    assert done == n_items and q.pending() == 0
    assert (n_items, done, leased) == (jn_items, jdone, jleased)
    assert q.results() == jq.results()


# ------------------------------------------- multi-PROCESS workers + a kill

_WORKER_SRC = textwrap.dedent("""
    import hashlib, json, os, sys, time
    sys.path.insert(0, {repo!r})
    from mp2_tpu_torch.parallel.workqueue import WorkerClient

    host, port, name, die_after = (
        sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
    )

    def prove(circuit, payload):
        env = json.loads(payload)
        acc = b""
        for k in env["order"]:
            node = env["nodes"][k]
            acc = hashlib.sha256(
                acc + node["circuit"].encode() + node["payload"].encode()
            ).digest()
        time.sleep(0.01)  # make leases overlap across processes
        return acc

    w = WorkerClient((host, port), name)
    n = w.run(prove, die_after=None if die_after < 0 else die_after)
    print(f"proved={{n}} jax={{'jax' in sys.modules}}", flush=True)
    if die_after >= 0:
        os._exit(1)  # hard death mid-lease, no cleanup
""")


def test_multiprocess_workers_with_midlease_kill(tmp_path):
    _, ut = _tree("port", n=63, step=1)
    q = workqueue.WorkQueue(lease_timeout=0.5, max_batch=2)
    n_items = q.add_batched_workplan(ut, 4, lambda k: ("node", str(k).encode()))
    coord = workqueue.Coordinator(q)
    host, port = coord.address
    script = tmp_path / "worker.py"
    script.write_text(_WORKER_SRC.format(repo=REPO))

    def spawn(name, die_after):
        return subprocess.Popen([sys.executable, str(script), host, str(port), name,
                                 str(die_after)], stdout=subprocess.PIPE, text=True)

    procs = [spawn("victim", 1), spawn("w1", -1), spawn("w2", -1)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert procs[0].returncode == 1
    assert q.pending() == 0, "survivors must finish after the kill"
    assert all(o.split()[1] == "jax=False" for o in outs)
    proved = sum(int(o.split()[0].split("=")[1]) for o in outs)
    assert proved >= n_items - 1
    assert q.stats.requeued >= 1 or proved >= n_items
    assert len(q.results()) == n_items
    want = {}
    for item in ut.into_batched_workplan(4):
        nodes = {str(k): {"circuit": "node", "payload": workqueue._b64(str(k).encode())}
                 for k in item.order}
        want[str(item.key)] = _subtree_prove("subtree", json.dumps(
            {"order": [str(k) for k in item.order], "nodes": nodes}).encode())
    assert q.results() == want
    coord.close()
