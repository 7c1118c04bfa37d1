"""The port's verifiable-DB host layer against mp2_tpu on the CPU.

The port carries jax-free copies of the curve stack (`field/gfp5`,
`field/ecgfp5`, `field/sswu`), the U256 limb packing, the ryhope trees and
transactional store (`ryhope/{sbbst,scapegoat,updatetree,kvdb}`) and the
verifiable-DB golden model (`vdb/digests`, `vdb/trees`).  Here the same
inputs, drawn from numpy with a seed, go through both packages, and every
output (field elements, curve points as their 11 fields, hashes, tree
shapes, update plans, payloads) must be equal.
"""

import numpy as np
import pytest

from mp2_tpu.field import ecgfp5 as jec
from mp2_tpu.field import gfp5 as jgfp5
from mp2_tpu.field import sswu as jsswu
from mp2_tpu.hash import poseidon2_host as jp2h
from mp2_tpu.ryhope import sbbst as jsbbst
from mp2_tpu.utils import u256 as ju256
from mp2_tpu.vdb import circuits as JC
from mp2_tpu.vdb import digests as JD
from mp2_tpu.vdb import trees as JT
from mp2_tpu_torch.field import ecgfp5 as ec
from mp2_tpu_torch.field import gfp5
from mp2_tpu_torch.field import sswu
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.ryhope import sbbst
from mp2_tpu_torch.utils import u256
from mp2_tpu_torch.vdb import circuits as C
from mp2_tpu_torch.vdb import digests as D
from mp2_tpu_torch.vdb import trees as T


def _quints(seed, k):
    rows = np.random.default_rng(seed).integers(0, P, size=(k, 5), dtype=np.uint64)
    return [tuple(int(v) for v in row) for row in rows]


def _u256s(rng, k):
    return [int.from_bytes(rng.bytes(32), "big") for _ in range(k)]


def _fields(pt):
    return [int(v) for v in pt.to_fields()]


def test_gfp5_matches_reference():
    qs = _quints(1, 12)
    for a, b in zip(qs[::2], qs[1::2]):
        for name in ("add", "sub", "mul", "div"):
            assert getattr(gfp5, name)(a, b) == getattr(jgfp5, name)(a, b), name
        for name in ("neg", "square", "inv", "norm", "is_square", "sgn0", "frobenius"):
            assert getattr(gfp5, name)(a) == getattr(jgfp5, name)(a), name
        sq = gfp5.square(a)
        assert gfp5.sqrt(sq) == jgfp5.sqrt(sq)
        assert gfp5.scalar_mul(a[0], b) == jgfp5.scalar_mul(a[0], b)
        assert gfp5.pow_int(a, b[1]) == jgfp5.pow_int(a, b[1])
        assert gfp5.frobenius(a, 3) == jgfp5.frobenius(a, 3)


def test_sswu_and_curve_ops_match_reference():
    """map_to_curve (SSWU), add, double, negation, scalar multiplication,
    encode/decode and the 11-field form."""
    rng = np.random.default_rng(2)
    us = _quints(3, 6)
    pts = [sswu.simple_swu(u) for u in us]
    jpts = [jsswu.simple_swu(u) for u in us]
    assert [_fields(p) for p in pts] == [_fields(p) for p in jpts]
    assert all(p.is_valid() for p in pts)
    for (p, q), (jp, jq) in zip(zip(pts, pts[1:]), zip(jpts, jpts[1:])):
        k = int.from_bytes(rng.bytes(16), "little")
        assert _fields(p + q) == _fields(jp + jq)
        assert _fields(p - q) == _fields(jp - jq)
        assert _fields(p.double()) == _fields(jp.double())
        assert _fields(p.scalar_mul(k)) == _fields(jp.scalar_mul(k))
        assert p.encode() == jp.encode()
        assert _fields(ec.Point.decode(p.encode())) == _fields(jec.Point.decode(jp.encode()))
        assert _fields(ec.Point.from_fields(p.to_fields())) == _fields(p)
    assert _fields(ec.NEUTRAL) == _fields(jec.NEUTRAL)
    assert _fields(pts[0] + ec.NEUTRAL) == _fields(pts[0])
    assert _fields(ec.add_points(pts)) == _fields(jec.add_points(jpts))


def test_map_to_curve_point_and_u256_match_reference():
    rng = np.random.default_rng(4)
    for v in _u256s(rng, 4) + [0, (1 << 256) - 1]:
        assert u256.u256_to_fields(v) == ju256.u256_to_fields(v)
        assert u256.u256_from_fields(u256.u256_to_fields(v)) == v
        vals = [7] + u256.u256_to_fields(v)
        assert _fields(p2h.map_to_curve_point(vals)) == _fields(jp2h.map_to_curve_point(vals))
    data = rng.bytes(44)
    assert u256.pack_bytes_be(data) == ju256.pack_bytes_be(data)
    assert u256.pack_bytes_le(data) == ju256.pack_bytes_le(data)


def test_digests_match_reference():
    rng = np.random.default_rng(5)
    ident, value, other = 17, *_u256s(rng, 2)
    h1, h2, rud = (tuple(int(x) for x in rng.integers(0, P, size=4, dtype=np.uint64))
                   for _ in range(3))
    assert D.EMPTY_HASH == JD.EMPTY_HASH
    assert _fields(D.cell_values_digest(ident, value)) == \
        _fields(JD.cell_values_digest(ident, value))
    for lh, rh in ((None, None), (h1, None), (h1, h2)):
        assert D.cells_node_hash(lh, rh, ident, value) == JD.cells_node_hash(lh, rh, ident, value)
        assert D.row_node_hash(lh, rh, value, other, ident, value, h2) == \
            JD.row_node_hash(lh, rh, value, other, ident, value, h2)
    assert D.row_id_individual(rud, 3) == JD.row_id_individual(rud, 3)
    pt, jpt = D.cell_values_digest(1, other), JD.cell_values_digest(1, other)
    split = D.SplitDigest.from_single(pt, False).accumulate(D.SplitDigest.from_single(pt, True))
    jsplit = JD.SplitDigest.from_single(jpt, False).accumulate(
        JD.SplitDigest.from_single(jpt, True))
    for mult in (False, True):
        got = D.row_digest(ident, value, mult, rud, split, 2, 1)
        want = JD.row_digest(ident, value, mult, rud, jsplit, 2, 1)
        assert got.multiplier_cnt == want.multiplier_cnt
        assert _fields(got.individual_vd) == _fields(want.individual_vd)
        assert _fields(got.multiplier_vd) == _fields(want.multiplier_vd)
        assert _fields(D.compute_final_digest(mult, pt, pt.double(), 3)) == \
            _fields(JD.compute_final_digest(mult, jpt, jpt.double(), 3))
    assert _fields(D.compute_index_digest([1, 2], pt)) == \
        _fields(JD.compute_index_digest([1, 2], jpt))


@pytest.mark.parametrize("n", range(1, 9))
def test_sbbst_shape_matches_reference(n):
    ours, ref = sbbst.Sbbst(n=n), jsbbst.Sbbst(n=n)
    assert ours.root_inner() == ref.root_inner()
    for k in range(1, n + 1):
        assert ours.children_inner(k) == ref.children_inner(k)
        assert ours.parent_inner(k) == ref.parent_inner(k)


def _cells(pkg, rng, k, mult_at=None):
    ids = [int(v) for v in rng.integers(1, 1 << 32, size=k)]
    return [pkg.Cell(i, v, j == mult_at) for j, (i, v) in enumerate(zip(ids, _u256s(rng, k)))]


def _same_cells_tree(res, jres):
    assert res.root_hash == jres.root_hash
    assert (res.individual_cnt, res.multiplier_cnt) == (jres.individual_cnt, jres.multiplier_cnt)
    assert _fields(res.split.individual) == _fields(jres.split.individual)
    assert _fields(res.split.multiplier) == _fields(jres.split.multiplier)
    assert sorted(res.nodes) == sorted(jres.nodes)
    for k, node in res.nodes.items():
        jnode = jres.nodes[k]
        assert node.hash == jnode.hash
        assert _fields(node.split.individual) == _fields(jnode.split.individual)
        assert res.tree.children_inner(k) == jres.tree.children_inner(k)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_build_cells_tree_matches_reference(k):
    res = T.build_cells_tree(_cells(T, np.random.default_rng(10 + k), k, mult_at=1))
    jres = JT.build_cells_tree(_cells(JT, np.random.default_rng(10 + k), k, mult_at=1))
    _same_cells_tree(res, jres)
    assert C.cells_pi_values(res.root_hash, res.split, res.individual_cnt,
                             res.multiplier_cnt) == \
        JC.cells_pi_values(jres.root_hash, jres.split, jres.individual_cnt,
                           jres.multiplier_cnt)


def _rows(pkg, seed, count, columns=3):
    """`count` rows of a table with `columns` value columns: U256 secondary
    index values and cells from numpy, row keys (secondary value, 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        (sec,) = _u256s(rng, 1)
        rud = tuple(int(v) for v in rng.integers(0, P, size=4, dtype=np.uint64))
        cells = pkg.build_cells_tree(
            [pkg.Cell(11 + j, v) for j, v in enumerate(_u256s(rng, columns))])
        out.append(((sec, 0), pkg.RowPayload(secondary=pkg.Cell(10, sec),
                                              row_unique_data=rud, cells=cells)))
    return out


def _drain(plan):
    levels = []
    while not plan.completed():
        ready = plan.next_ready()
        levels.append(ready)
        for key in ready:
            plan.done(key)
    return levels


def _same_row_payload(p, jp):
    assert (p.hash, p.min_value, p.max_value, p.multiplier_cnt) == \
        (jp.hash, jp.min_value, jp.max_value, jp.multiplier_cnt)
    assert _fields(p.individual_vd) == _fields(jp.individual_vd)
    assert _fields(p.multiplier_vd) == _fields(jp.multiplier_vd)
    assert C.rows_pi_values(p) == JC.rows_pi_values(jp)


@pytest.mark.parametrize("count", [1, 2, 3, 5, 8])
def test_row_tree_inserts_match_reference(count):
    """Rows inserted in one transaction, then 2 more rows and an update of
    the first row in a second: the update trees, their workplans' levels,
    the tree shape and every payload equal the reference's."""
    db, jdb = T.new_row_tree(), JT.new_row_tree()
    rows, jrows = _rows(T, count, count + 2), _rows(JT, count, count + 2)

    def first(tx, rs):
        for key, payload in rs[:count]:
            tx.store(key, payload)

    def second(tx, rs):
        for key, payload in rs[count:]:
            tx.store(key, payload)
        tx.store(rs[0][0], rs[-1][1])

    for step in (first, second):
        ut = db.in_transaction(lambda tx: step(tx, rows))
        jut = jdb.in_transaction(lambda tx: step(tx, jrows))
        assert ut.root == jut.root == db.root() == jdb.root()
        assert ut.children_map == jut.children_map
        assert ut.parent_map == jut.parent_map
        assert ut.path_ends == jut.path_ends
        assert _drain(ut.into_workplan()) == _drain(jut.into_workplan())
        assert sorted(db.payloads) == sorted(jdb.payloads)
        for key in db.payloads:
            assert db.tree.children(key) == jdb.tree.children(key)
            _same_row_payload(db.payload(key), jdb.payload(key))
