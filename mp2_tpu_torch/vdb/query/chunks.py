"""Row-chunk aggregation + revelation circuits over the universal query
circuit (reference: verifiable-db/src/query/{row_chunk_processing.rs,
chunk_aggregation.rs}, revelation/revelation_without_results_tree.rs).

Shape:
  row        — the witness-driven universal query circuit as a framework
               member (ONE VK for all queries); in TREE-BOUND mode the row
               member additionally recomputes the row's cells-tree root from
               the column values, walks a neighbors-aware Merkle path up the
               rows tree and the index (block) tree, and exposes the index
               root + the row's boundary info (predecessor/successor data in
               both trees — row_chunk_processing.rs RowProcessingGadget);
  chunk_pair / chunk_single — aggregate 1-2 ROW proofs (cross-set): checks
               all rows ran the SAME query (equal computational hash) with
               the SAME placeholder bindings, that adjacent rows are
               CONSECUTIVE under the query bounds (consecutive_rows.rs),
               and folds outputs per the committed aggregation function;
  chunk_merge — aggregates 2 chunk proofs (same set), checking the right
               boundary of the left chunk is consecutive with the left
               boundary of the right chunk (chunk_aggregation.rs:90-130);
  revelation  — verifies the chunk root (cross-set) + the IVC proof
               (cross-set from the verifiable-DB stack), recomputes the
               placeholder hash from witnessed placeholder values
               (revelation/placeholders_check.rs), pins the chunk's query
               bounds to those values, checks the extreme boundaries cover
               the whole range (no in-range row before the first / after
               the last proven row), binds the chunk's index root to the
               IVC block-tree root, applies the final AVG division, and
               exposes (computational hash, placeholder hash, block-tree
               root, results, count).

Completeness argument (tree-bound mode): every proven row carries its
predecessor/successor info in the rows tree and index tree; chunk circuits
enforce adjacent proven rows are consecutive, and the revelation enforces
the first row has no in-range predecessor and the last row no in-range
successor — so the proven set is exactly the rows of the committed trees
within the query bounds.  Secondary-index bounds (QueryBounds min/max
secondary, query/utils.rs:131-199) are committed in the placeholder hash
and enforced as SOFT predicate gating inside eval_row: this stack proves
ALL rows of every in-range block (completeness by superset) and lets the
predicate reject out-of-secondary-range rows, so chain consecutiveness
always runs over the FULL secondary range — a deliberate deviation from
row_chunk_gadgets, which skips out-of-range rows and needs a rows-tree
non-existence member for empty secondary ranges (here an empty secondary
range is just a proven all-rows chunk chain with zero matches).

A jax-free copy of `mp2_tpu/vdb/query/chunks.py`: only the imports change.
`QueryCircuits` takes the device its three sets are compiled for and proved
on (`device="cuda"` unless the caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.bytes import small_lt
from mp2_tpu_torch.circuit.gadgets.u256 import (
    U256Target,
    add_virtual_u256,
    set_u256,
    u256_add,
    u256_equal,
    u256_less_than,
    u256_lte,
    u256_select,
)
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.prover.config import CircuitConfig
from mp2_tpu_torch.recursion.runtime import RecursionFramework, WrappedEnvelope
from mp2_tpu_torch.ryhope.sbbst import Sbbst
from mp2_tpu_torch.utils.u256 import U256_MAX, u256_to_fields
from mp2_tpu_torch.vdb import digests as D
from mp2_tpu_torch.vdb.query.merkle_path import (
    BOUNDARY_ROW_LEN,
    BoundaryRowTargets,
    NeighborInfoTargets,
    add_merkle_path_with_neighbors,
    are_consecutive_rows,
    host_neighbor_path_from_tree,
    node_info_fields,
    set_merkle_path_with_neighbors,
)
from mp2_tpu_torch.vdb.query.ops import AggregationOperation
from mp2_tpu_torch.vdb.query.universal import (
    UniversalQueryParams,
    build_universal_query_circuit,
)

N_AGG = 6  # AggregationOperation enum size


def _row_base_width(p: UniversalQueryParams) -> int:
    return 14 + p.num_outputs + 8 * p.num_outputs


def _chunk_base_width(p: UniversalQueryParams) -> int:
    return 9 + 9 * p.num_outputs


def _pi_width(p: UniversalQueryParams, bind: bool) -> int:
    if not bind:
        return _row_base_width(p)
    # chunk layout dominates: base + index_root(4) + 4 bounds (32) +
    # left/right boundary (128)
    return _chunk_base_width(p) + 4 + 32 + 2 * BOUNDARY_ROW_LEN


@dataclass
class _RowPis:
    comp: List[Target]
    ph: List[Target]
    cc: List[Target]
    pred: Target
    overflow: Target
    agg_ids: List[Target]
    outputs: List[U256Target]
    index_root: Optional[List[Target]] = None
    boundary: Optional[BoundaryRowTargets] = None
    primary: Optional[U256Target] = None
    secondary: Optional[U256Target] = None

    @staticmethod
    def parse(p, pis, bind=False):
        no = p.num_outputs
        outs = [
            U256Target(tuple(pis[14 + no + 8 * j : 14 + no + 8 * (j + 1)]))
            for j in range(no)
        ]
        r = _RowPis(
            comp=list(pis[0:4]), ph=list(pis[4:8]), cc=list(pis[8:12]),
            pred=pis[12], overflow=pis[13],
            agg_ids=list(pis[14 : 14 + no]), outputs=outs,
        )
        if bind:
            base = _row_base_width(p)
            r.index_root = list(pis[base : base + 4])
            r.boundary = BoundaryRowTargets.from_targets(
                pis[base + 4 : base + 4 + BOUNDARY_ROW_LEN]
            )
            r.primary = _u256_at(pis, base + 4 + BOUNDARY_ROW_LEN)
            r.secondary = _u256_at(pis, base + 12 + BOUNDARY_ROW_LEN)
        return r


def _u256_at(pis, off) -> U256Target:
    return U256Target(tuple(pis[off : off + 8]))


@dataclass
class _ChunkPis:
    comp: List[Target]
    ph: List[Target]
    agg_ids: List[Target]
    outputs: List[U256Target]
    count: Target
    index_root: Optional[List[Target]] = None
    min_p: Optional[U256Target] = None
    max_p: Optional[U256Target] = None
    min_s: Optional[U256Target] = None
    max_s: Optional[U256Target] = None
    left_b: Optional[BoundaryRowTargets] = None
    right_b: Optional[BoundaryRowTargets] = None

    @staticmethod
    def parse(p, pis, bind=False):
        no = p.num_outputs
        outs = [
            U256Target(tuple(pis[8 + no + 8 * j : 8 + no + 8 * (j + 1)]))
            for j in range(no)
        ]
        c = _ChunkPis(
            comp=list(pis[0:4]), ph=list(pis[4:8]),
            agg_ids=list(pis[8 : 8 + no]), outputs=outs,
            count=pis[8 + no + 8 * no],
        )
        if bind:
            base = _chunk_base_width(p)
            c.index_root = list(pis[base : base + 4])
            c.min_p = _u256_at(pis, base + 4)
            c.max_p = _u256_at(pis, base + 12)
            c.min_s = _u256_at(pis, base + 20)
            c.max_s = _u256_at(pis, base + 28)
            c.left_b = BoundaryRowTargets.from_targets(
                pis[base + 36 : base + 36 + BOUNDARY_ROW_LEN]
            )
            c.right_b = BoundaryRowTargets.from_targets(
                pis[base + 36 + BOUNDARY_ROW_LEN : base + 36 + 2 * BOUNDARY_ROW_LEN]
            )
        return c


def _u256_const(b, v: int) -> U256Target:
    return U256Target(tuple(b.constant(x) for x in u256_to_fields(v)))


def _agg_onehot(b, agg_id: Target) -> List[Target]:
    # generators FIRST: witness generation is a single pass in creation
    # order, so the one-hot bits must be generated before the arithmetic
    # ops below read them
    oh = []
    for k in range(N_AGG):
        t = b.add_input()
        b.add_generator(t, lambda read, k=k, a=agg_id: 1 if read(a) == k else 0)
        oh.append(t)
    acc = None
    idx = b.zero()
    for k, t in enumerate(oh):
        b.connect(b.mul(t, t), t)
        acc = t if acc is None else b.add(acc, t)
        idx = b.mul_add(t, b.constant(k), idx)
    b.connect(acc, b.one())
    b.connect(idx, agg_id)
    return oh


def _row_contribution(b, pred: Target, out: U256Target, oh) -> U256Target:
    """Per-row identity-padded contribution for each aggregation kind."""
    zero = _u256_const(b, 0)
    mx = _u256_const(b, U256_MAX)
    gated = u256_select(b, pred, out, zero)          # SUM/AVG/MAX
    gated_min = u256_select(b, pred, out, mx)        # MIN
    count = U256Target(tuple([b.zero()] * 7 + [pred]))  # COUNT
    v = u256_select(b, oh[int(AggregationOperation.MIN)], gated_min, gated)
    v = u256_select(b, oh[int(AggregationOperation.COUNT)], count, v)
    return v


def _combine(b, a: U256Target, c: U256Target, oh) -> U256Target:
    added, _ = u256_add(b, a, c)
    mn = u256_select(b, u256_less_than(b, a, c), a, c)
    mx = u256_select(b, u256_less_than(b, a, c), c, a)
    v = u256_select(b, oh[int(AggregationOperation.MIN)], mn, added)
    v = u256_select(b, oh[int(AggregationOperation.MAX)], mx, v)
    return v


def _connect_lists(b, xs, ys):
    for x, y in zip(xs, ys):
        b.connect(x, y)


def _cells_root_circuit(
    b: CircuitBuilder, ids: Sequence[Target], values: Sequence[U256Target]
) -> List[Target]:
    """Recompute the cells-tree root from column wires (fixed sbbst topology
    over the n non-indexed cells — trees.build_cells_tree)."""
    n = len(ids)
    empty = [b.constant(v) for v in D.EMPTY_HASH]
    if n == 0:
        return empty
    tree = Sbbst(n=n)

    def rec(k):
        l, r = tree.children_inner(k)
        lh = rec(l) if l is not None else empty
        rh = rec(r) if r is not None else empty
        return b.hash_no_pad(
            list(lh) + list(rh) + [ids[k - 1]] + list(values[k - 1].limbs)
        )

    return rec(tree.root_inner())


def _enforce_no_inrange_pred(b, info: NeighborInfoTargets, min_b: U256Target):
    """Predecessor must be absent or store a value < min_b."""
    in_range = b.logic_and(u256_lte(b, min_b, info.value), info.is_found)
    b.connect(in_range, b.zero())


def _enforce_no_inrange_succ(b, info: NeighborInfoTargets, max_b: U256Target):
    """Successor must be absent or store a value > max_b."""
    in_range = b.logic_and(u256_lte(b, info.value, max_b), info.is_found)
    b.connect(in_range, b.zero())


# --------------------------------------------------------------------- host


def build_chunk_from_rows(b, p, W, bind, foreign):
    """Chunk circuit body over 1-2 verified row proofs: same query, output
    folding, and (tree-bound) row consecutiveness + bounds exposure."""
    rows = [_RowPis.parse(p, f.public_inputs(), bind) for f in foreign]
    r0 = rows[0]
    count = r0.pred
    for r in rows[1:]:
        _connect_lists(b, r.comp, r0.comp)
        _connect_lists(b, r.ph, r0.ph)
        _connect_lists(b, r.agg_ids, r0.agg_ids)
        count = b.add(count, r.pred)
    outs = []
    for j in range(p.num_outputs):
        oh = _agg_onehot(b, r0.agg_ids[j])
        acc = _row_contribution(b, rows[0].pred, rows[0].outputs[j], oh)
        for r in rows[1:]:
            c = _row_contribution(b, r.pred, r.outputs[j], oh)
            acc = _combine(b, acc, c, oh)
        outs.append(acc)
    pis = (
        list(r0.comp) + list(r0.ph) + list(r0.agg_ids)
        + [l for o in outs for l in o.limbs] + [count]
    )
    if bind:
        bounds_t = [add_virtual_u256(b) for _ in range(4)]
        min_p, max_p, min_s, max_s = bounds_t
        for r in rows[1:]:
            _connect_lists(b, r.index_root, r0.index_root)
        # chain consecutiveness runs over the FULL secondary range: this
        # stack proves ALL rows of every in-range block (completeness by
        # superset — the witnessed secondary bounds only gate the
        # predicate), so out-of-secondary-range rows are legitimate chain
        # members (deviation from row_chunk_gadgets, which skips them)
        full_lo = _u256_const(b, 0)
        full_hi = _u256_const(b, U256_MAX)
        for a, c in zip(rows, rows[1:]):
            ok = are_consecutive_rows(
                b, a.boundary, c.boundary, min_p, max_p, full_lo, full_hi
            )
            b.connect(ok, b.one())
        pis += list(r0.index_root)
        for t in bounds_t:
            pis += list(t.limbs)
        pis += rows[0].boundary.to_targets()
        pis += rows[-1].boundary.to_targets()

        def assign(inputs, qb4):
            for t, v in zip(bounds_t, qb4):
                set_u256(inputs, t, v)

    else:
        assign = None
    pis += [b.zero()] * (W - len(pis))
    b.register_public_inputs(pis)
    return assign


def _select_boundary(b, flag, x: BoundaryRowTargets, y: BoundaryRowTargets):
    """flag ? x : y over the 64 boundary targets (BoundaryRowDataTarget::
    select, row_chunk_gadgets/mod.rs)."""
    xs, ys = x.to_targets(), y.to_targets()
    return BoundaryRowTargets.from_targets(
        [b.select(flag, a, c) for a, c in zip(xs, ys)]
    )


def build_chunk_merge(b, p, W, bind, children):
    """Chunk-merge body over NUM_CHUNKS >= 2 chunk proofs
    (chunk_aggregation.rs:50-135): the first chunk is pinned non-dummy;
    each further chunk carries a witnessed is_non_dummy flag — dummy
    slots repeat a real proof and contribute identity values, so one
    circuit covers every partial top level.  Tree-bound mode checks each
    non-dummy chunk is consecutive with the accumulated right boundary
    and that all chunks agree on the index root + query bounds.

    Returns assign(inputs, n_real)."""
    chunks = [
        _ChunkPis.parse(p, c.public_inputs(), bind) for c in children
    ]
    l = chunks[0]
    nd_flags = []
    for _ in chunks[1:]:
        t = b.add_input()
        b.connect(b.mul(t, t), t)
        nd_flags.append(t)

    zero_u = _u256_const(b, 0)
    outs = []
    ohs = []
    for j in range(p.num_outputs):
        ohs.append(_agg_onehot(b, l.agg_ids[j]))
    count = l.count
    right_b = l.right_b if bind else None
    acc = [l.outputs[j] for j in range(p.num_outputs)]
    for r, nd in zip(chunks[1:], nd_flags):
        _connect_lists(b, r.comp, l.comp)
        _connect_lists(b, r.ph, l.ph)
        _connect_lists(b, r.agg_ids, l.agg_ids)
        count = b.mul_add(nd, r.count, count)
        for j in range(p.num_outputs):
            ident = _row_contribution(b, b.zero(), zero_u, ohs[j])
            contrib = u256_select(b, nd, r.outputs[j], ident)
            acc[j] = _combine(b, acc[j], contrib, ohs[j])
        if bind:
            _connect_lists(b, r.index_root, l.index_root)
            for a, c in (
                (l.min_p, r.min_p), (l.max_p, r.max_p),
                (l.min_s, r.min_s), (l.max_s, r.max_s),
            ):
                _connect_lists(b, a.limbs, c.limbs)
            # full secondary range for chain purposes (see build_row_chunk)
            ok = are_consecutive_rows(
                b, right_b, r.left_b, l.min_p, l.max_p,
                _u256_const(b, 0), _u256_const(b, U256_MAX),
            )
            # consecutive required only for non-dummy chunks
            b.connect(b.mul(nd, ok), nd)
            right_b = _select_boundary(b, nd, r.right_b, right_b)
    outs = acc
    pis = (
        list(l.comp) + list(l.ph) + list(l.agg_ids)
        + [lm for o in outs for lm in o.limbs] + [count]
    )
    if bind:
        pis += list(l.index_root)
        for t in (l.min_p, l.max_p, l.min_s, l.max_s):
            pis += list(t.limbs)
        pis += l.left_b.to_targets()
        pis += right_b.to_targets()
    pis += [b.zero()] * (W - len(pis))
    b.register_public_inputs(pis)

    def assign(inputs, n_real=None):
        n = len(children) if n_real is None else n_real
        for i, t in enumerate(nd_flags):
            inputs[t] = 1 if (i + 1) < n else 0

    return assign


def build_row_chunk(
    b: CircuitBuilder,
    p: UniversalQueryParams,
    W: int,
    num_rows: int,
    row_tree_depth: int,
    index_tree_depth: int,
):
    """ROW-CHUNK circuit (row_chunk_processing.rs): NUM_ROWS tree-bound
    row gadgets embedded in ONE circuit, sharing a single query-structure
    instance (selectors + computational/placeholder hash built once —
    the reference's UniversalQueryHashInputs split).  Row i > 0 carries a
    witnessed non-dummy flag; dummy rows are host-side COPIES of the last
    real row (so paths/range checks hold) whose predicate is forced 0 and
    whose consecutiveness check is skipped.  Produces CHUNK-layout PIs,
    so chunk_merge and the revelation consume row chunks directly.

    Returns assign(inputs, pis, column_ids, rows, placeholders, bounds,
    bindings) accepting 1..num_rows real rows."""
    from mp2_tpu_torch.vdb.query.universal import build_query_structure, eval_row

    st = build_query_structure(b, p)
    min_p, max_p = st.bound_min, st.bound_max
    min_s, max_s = st.bound_min_s, st.bound_max_s
    agg_ids = st.agg_ids(b)

    row_wires = []
    for i in range(num_rows):
        columns = [add_virtual_u256(b) for _ in range(p.num_columns)]
        if i == 0:
            non_dummy = b.one()  # first row must be real
        else:
            non_dummy = b.add_input()
            b.connect(b.mul(non_dummy, non_dummy), non_dummy)
        ev = eval_row(b, st, columns, non_dummy)
        # primary-index range membership is HARD for every proven row
        # (universal_query_gadget.rs:1336-1342)
        b.connect(u256_lte(b, min_p, columns[0]), b.one())
        b.connect(u256_lte(b, columns[0], max_p), b.one())
        cells_root = _cells_root_circuit(b, st.column_ids[2:], columns[2:])
        row_path = add_merkle_path_with_neighbors(
            b, st.column_ids[1], columns[1], cells_root, row_tree_depth
        )
        index_path = add_merkle_path_with_neighbors(
            b, st.column_ids[0], columns[0], row_path.root, index_tree_depth
        )
        boundary = BoundaryRowTargets(row=row_path.node, index=index_path.node)
        row_wires.append(
            dict(columns=columns, non_dummy=non_dummy, ev=ev,
                 boundary=boundary, row_path=row_path, index_path=index_path)
        )

    r0 = row_wires[0]
    # all rows prove membership against the SAME index root (dummy rows
    # are copies of real rows, so this holds for them too)
    for rw in row_wires[1:]:
        _connect_lists(b, rw["index_path"].root, r0["index_path"].root)

    count = r0["ev"].pred
    right_b = r0["boundary"]
    accs = None
    ohs = [_agg_onehot(b, agg_ids[j]) for j in range(p.num_outputs)]
    accs = [
        _row_contribution(b, r0["ev"].pred, r0["ev"].out_values[j], ohs[j])
        for j in range(p.num_outputs)
    ]
    for rw in row_wires[1:]:
        nd = rw["non_dummy"]
        count = b.add(count, rw["ev"].pred)  # pred already gated by nd
        for j in range(p.num_outputs):
            c = _row_contribution(b, rw["ev"].pred, rw["ev"].out_values[j],
                                  ohs[j])
            accs[j] = _combine(b, accs[j], c, ohs[j])
        # FULL secondary range for the chain: all rows of an in-range
        # block are proven (superset completeness); the witnessed
        # secondary bounds gate only the predicate (eval_row)
        ok = are_consecutive_rows(
            b, right_b, rw["boundary"], min_p, max_p,
            _u256_const(b, 0), _u256_const(b, U256_MAX),
        )
        b.connect(b.mul(nd, ok), nd)  # consecutive unless dummy
        right_b = _select_boundary(b, nd, rw["boundary"], right_b)

    pis = (
        list(st.comp_hash) + list(st.ph_hash) + list(agg_ids)
        + [lm for o in accs for lm in o.limbs] + [count]
        + list(r0["index_path"].root)
    )
    for t in (min_p, max_p, min_s, max_s):
        pis += list(t.limbs)
    pis += r0["boundary"].to_targets()
    pis += right_b.to_targets()
    pis += [b.zero()] * (W - len(pis))
    b.register_public_inputs(pis)

    def assign(inputs, pis_obj, column_ids_v, rows, placeholders, bounds,
               bindings):
        assert 1 <= len(rows) <= num_rows
        st.assign(inputs, pis_obj, column_ids_v, placeholders, bounds)
        last = len(rows) - 1
        for i, rw in enumerate(row_wires):
            real = i < len(rows)
            row = rows[i] if real else rows[last]
            bi = bindings[i] if real else bindings[last]
            for t, v in zip(rw["columns"], row):
                set_u256(inputs, t, v)
            if i > 0:
                inputs[rw["non_dummy"]] = 1 if real else 0
            set_merkle_path_with_neighbors(inputs, rw["row_path"], bi.row_w)
            set_merkle_path_with_neighbors(
                inputs, rw["index_path"], bi.index_w
            )

    return assign


def build_revelation(b, p, W, bind, chunk_uv, ivc_uv):
    """Revelation body: final AVG division + (tree-bound) placeholder-hash
    recomputation, bounds pinning, extreme-boundary completeness, and
    index-root == IVC block-tree-root binding
    (revelation_without_results_tree.rs + placeholders_check.rs)."""
    from mp2_tpu_torch.circuit.gadgets.u256 import u256_div_mod

    c = _ChunkPis.parse(p, chunk_uv.public_inputs(), bind)
    if ivc_uv is not None:
        block_root = list(ivc_uv.public_inputs()[0:4])
    else:
        block_root = [b.zero()] * 4
    assign = None
    if bind:
        (ph_hash, bound_min, bound_max, bound_min_s, bound_max_s,
         assign) = _placeholder_check(b, p)
        _connect_lists(b, ph_hash, c.ph)
        _connect_lists(b, c.min_p.limbs, bound_min.limbs)
        _connect_lists(b, c.max_p.limbs, bound_max.limbs)
        # secondary bounds pinned to the SAME witnessed values committed in
        # the placeholder hash (utils.rs QueryBounds secondary range)
        _connect_lists(b, c.min_s.limbs, bound_min_s.limbs)
        _connect_lists(b, c.max_s.limbs, bound_max_s.limbs)
        # extreme boundaries: nothing in range before the first / after
        # the last proven row
        _enforce_no_inrange_pred(b, c.left_b.row.predecessor, c.min_s)
        _enforce_no_inrange_pred(b, c.left_b.index.predecessor, c.min_p)
        _enforce_no_inrange_succ(b, c.right_b.row.successor, c.max_s)
        _enforce_no_inrange_succ(b, c.right_b.index.successor, c.max_p)
        # the proven rows live in the committed block tree
        if ivc_uv is not None:
            _connect_lists(b, c.index_root, block_root)

    count = c.count
    count_u = U256Target(tuple([b.zero()] * 7 + [count]))
    results = []
    for j in range(p.num_outputs):
        oh = _agg_onehot(b, c.agg_ids[j])
        avg, _ = u256_div_mod(b, c.outputs[j], count_u)
        v = u256_select(
            b, oh[int(AggregationOperation.AVG)], avg, c.outputs[j]
        )
        results.append(v)
    pis = (
        list(c.comp) + list(c.ph) + block_root
        + [lm for o in results for lm in o.limbs] + [count]
    )
    pis += [b.zero()] * (W - len(pis))
    b.register_public_inputs(pis)
    return assign


def _placeholder_check(b, p):
    """placeholders_check.rs CheckPlaceholderGadget: recompute the
    placeholder hash from witnessed (name-hash, value, active) triples
    prefixed by ALL FOUR query bounds (primary + secondary — the
    reference's QueryBound sources, utils.rs:131-199).  Returns (hash
    targets, the four bound u256 targets, assign closure)."""
    npl = p.num_placeholders
    ph_name_hs = b.add_inputs(npl)
    ph_values = [add_virtual_u256(b) for _ in range(npl)]
    ph_active = []
    for _ in range(npl):
        t = b.add_input()
        b.connect(b.mul(t, t), t)
        ph_active.append(t)
    bound_min = add_virtual_u256(b)
    bound_max = add_virtual_u256(b)
    bound_min_s = add_virtual_u256(b)
    bound_max_s = add_virtual_u256(b)
    ph_inputs: List[Target] = (
        list(bound_min.limbs) + list(bound_max.limbs)
        + list(bound_min_s.limbs) + list(bound_max_s.limbs)
    )
    for nh, pv, act in zip(ph_name_hs, ph_values, ph_active):
        ph_inputs.append(b.mul(act, nh))
        ph_inputs.extend(b.mul(act, lm) for lm in pv.limbs)
    ph_hash = b.hash_no_pad(ph_inputs)

    def assign(inputs, names, placeholders, bounds):
        name_h = {
            n: p2h.hash_no_pad([ord(ch) for ch in n])[0] for n in names
        }
        for k in range(npl):
            if k < len(names):
                inputs[ph_name_hs[k]] = name_h[names[k]]
                set_u256(inputs, ph_values[k], placeholders.get(names[k]))
                inputs[ph_active[k]] = 1
            else:
                inputs[ph_name_hs[k]] = 0
                set_u256(inputs, ph_values[k], 0)
                inputs[ph_active[k]] = 0
        set_u256(inputs, bound_min, bounds.min_block)
        set_u256(inputs, bound_max, bounds.max_block)
        set_u256(inputs, bound_min_s, getattr(bounds, "min_secondary", 0))
        set_u256(
            inputs, bound_max_s, getattr(bounds, "max_secondary", U256_MAX)
        )

    return ph_hash, bound_min, bound_max, bound_min_s, bound_max_s, assign


def _lex_lt_u256_arr(b, xs, ys) -> Target:
    """Strict lexicographic xs < ys over equal-length U256 tuples (the
    is_less_than_or_equal_to_u256_arr role, u256.rs:899)."""
    lt = b.zero()
    eq = b.one()
    for x, y in zip(xs, ys):
        lt = b.add(lt, b.mul(eq, u256_less_than(b, x, y)))
        eq = b.mul(eq, u256_equal(b, x, y))
    return lt


def build_row_dummy(b, p, W):
    """Padding member of the ROW set for the tabular revelation (the
    reference's generate_dummy_row_proof_inputs role,
    revelation_unproven_offset.rs:649): the matching flag is pinned to 0,
    so the revelation's per-row checks are all vacuous; the query hashes
    are witnessed so the dummy can agree with the real rows' query.

    Safety against misuse in the CHUNKED (completeness-proving) path,
    where any row-set member may appear: the dummy's boundary info and
    index root are constant ZERO.  are_consecutive_rows rejects a zero
    boundary in every position (the index-tree side requires found,
    in-range neighbors with matching hashes; a real node's hash is never
    zero), a single-dummy chunk exposes index_root = 0 which can never
    equal the IVC block-tree root the revelation pins, and chunk merges
    require equal index roots — so a dummy can pad ONLY the tabular
    revelation, where pred = 0 neutralizes it by construction."""
    comp = b.add_inputs(4)
    ph = b.add_inputs(4)
    pis = list(comp) + list(ph)
    pis += [b.zero()] * (W - len(pis))
    b.register_public_inputs(pis)

    def assign(inputs, comp_vals, ph_vals):
        for t, v in zip(comp, comp_vals):
            inputs[t] = int(v)
        for t, v in zip(ph, ph_vals):
            inputs[t] = int(v)

    return assign


def build_revelation_tabular(b, p, W, row_uvs, ivc_uv):
    """Tabular revelation (revelation_unproven_offset.rs): verifies up to
    L row proofs INDIVIDUALLY — no consecutive-rows argument, so the
    prover may CENSOR results (the unproven OFFSET) but cannot fake them:

      * matching rows occupy the initial slots (monotone flag chain);
      * every row ran the same query (equal computational/placeholder
        hashes) and every matching row lives in the committed block tree
        (index root == IVC root) with its primary index inside the
        recomputed query bounds;
      * DISTINCT: consecutive matching results strictly increasing
        lexicographically (which also forces them pairwise distinct);
      * num_results <= LIMIT.

    PIs: comp(4) | ph(4) | block_root(4) | num_results | limit | offset |
         distinct | L x num_outputs results (8 limbs each) | zero pad."""
    rows = [_RowPis.parse(p, uv.public_inputs(), bind=True) for uv in row_uvs]
    if ivc_uv is not None:
        block_root = list(ivc_uv.public_inputs()[0:4])
    else:
        block_root = [b.zero()] * 4
    r0 = rows[0]
    distinct = b.add_input()
    b.connect(b.mul(distinct, distinct), distinct)
    limit = b.add_input()
    offset = b.add_input()
    (ph_hash, bound_min, bound_max, bound_min_s, bound_max_s,
     assign_ph) = _placeholder_check(b, p)
    _connect_lists(b, ph_hash, r0.ph)

    only_matching = b.one()
    num_results = b.zero()
    prev = None
    for r in rows:
        is_m = r.pred
        # once a non-matching slot appears, all later slots are non-matching
        only_matching = b.mul(only_matching, is_m)
        b.connect(only_matching, is_m)
        num_results = b.add(num_results, is_m)
        _connect_lists(b, r.comp, r0.comp)
        _connect_lists(b, r.ph, r0.ph)
        for x, y in zip(r.index_root, block_root):
            b.connect(b.mul(is_m, b.sub(x, y)), b.zero())
        in_range = b.logic_and(
            u256_lte(b, bound_min, r.primary),
            u256_lte(b, r.primary, bound_max),
        )
        b.connect(b.mul(is_m, in_range), is_m)
        if prev is not None:
            lt = _lex_lt_u256_arr(b, prev.outputs, r.outputs)
            must = b.mul(is_m, distinct)
            b.connect(b.mul(must, lt), must)
        prev = r
    # num_results <= limit (both small scalars)
    b.connect(small_lt(b, limit, num_results), b.zero())

    pis = (
        list(r0.comp) + list(r0.ph) + block_root
        + [num_results, limit, offset, distinct]
    )
    for r in rows:
        for o in r.outputs:
            pis += list(o.limbs)
    pis += [b.zero()] * (W - len(pis))
    b.register_public_inputs(pis)

    def assign(inputs, names, placeholders, bounds, distinct_v, limit_v,
               offset_v):
        assign_ph(inputs, names, placeholders, bounds)
        inputs[distinct] = 1 if distinct_v else 0
        inputs[limit] = int(limit_v)
        inputs[offset] = int(offset_v)

    return assign


def build_non_existence(b, p, W, index_tree_depth):
    """Non-existence chunk member (query/circuits/non_existence.rs): proves
    the primary-index query range is EMPTY over the committed index tree.
    Witnesses ONE index-tree node whose value lies outside [min_p, max_p]
    with a neighbors-aware Merkle path to the index root, and enforces its
    predecessor/successor straddle the range — so no node of the committed
    tree has a value inside the bounds.  Exposes a chunk-layout PI set:
    count 0, identity outputs (0 / U256_MAX for MIN), the index root, and
    boundary rows carrying the bracketing node's info with dummy rows-tree
    info (is_found=0, so the revelation's extreme checks pass vacuously)."""
    comp = b.add_inputs(4)
    ph = b.add_inputs(4)
    agg_ids = b.add_inputs(p.num_outputs)
    bounds_t = [add_virtual_u256(b) for _ in range(4)]
    min_p, max_p, _min_s, _max_s = bounds_t

    ident = b.add_input()
    from mp2_tpu_torch.circuit.gadgets.u256 import u256_constant
    from mp2_tpu_torch.vdb.query.merkle_path import NodeInfoTargets

    value = add_virtual_u256(b, range_check=False)
    subtree = b.add_inputs(4)
    path = add_merkle_path_with_neighbors(
        b, ident, value, subtree, index_tree_depth
    )
    below = u256_less_than(b, value, min_p)
    above = u256_less_than(b, max_p, value)
    b.connect(b.logic_or(below, above), b.one())
    _enforce_no_inrange_pred(b, path.node.predecessor, min_p)
    _enforce_no_inrange_succ(b, path.node.successor, max_p)

    zero_u = _u256_const(b, 0)
    outs = []
    for j in range(p.num_outputs):
        oh = _agg_onehot(b, agg_ids[j])
        outs.append(_row_contribution(b, b.zero(), zero_u, oh))
    count = b.zero()

    e = [b.constant(v) for v in D.EMPTY_HASH]
    dummy_row = NodeInfoTargets(
        end_hash=list(e),
        predecessor=NeighborInfoTargets(
            is_found=b.zero(), is_in_path=b.zero(),
            value=u256_constant(b, 0), hash=list(e),
        ),
        successor=NeighborInfoTargets(
            is_found=b.zero(), is_in_path=b.zero(),
            value=u256_constant(b, U256_MAX), hash=list(e),
        ),
    )
    boundary = BoundaryRowTargets(row=dummy_row, index=path.node)

    pis = (
        list(comp) + list(ph) + list(agg_ids)
        + [l for o in outs for l in o.limbs] + [count]
        + list(path.root)
    )
    for t in bounds_t:
        pis += list(t.limbs)
    pis += boundary.to_targets()
    pis += boundary.to_targets()
    pis += [b.zero()] * (W - len(pis))
    b.register_public_inputs(pis)

    def assign(inputs, comp_vals, ph_vals, agg_vals, qb4, node_ident,
               index_w):
        for t, v in zip(comp, comp_vals):
            inputs[t] = int(v)
        for t, v in zip(ph, ph_vals):
            inputs[t] = int(v)
        for t, v in zip(agg_ids, agg_vals):
            inputs[t] = int(v)
        for t, v in zip(bounds_t, qb4):
            set_u256(inputs, t, v)
        inputs[ident] = int(node_ident)
        set_u256(inputs, value, index_w["end_value"])
        for t, v in zip(subtree, index_w["end_inner"]):
            inputs[t] = int(v)
        set_merkle_path_with_neighbors(inputs, path, index_w)

    return assign


def non_existence_boundary_fields(index_w: dict) -> List[int]:
    """Host PI fields of the non-existence boundary row (dummy rows-tree
    info + the bracketing index node's info)."""
    from mp2_tpu_torch.vdb.query.merkle_path import neighbor_info_fields

    dummy_row = (
        list(D.EMPTY_HASH)
        + neighbor_info_fields(
            dict(is_found=False, is_in_path=False, value=0,
                 hash=list(D.EMPTY_HASH))
        )
        + neighbor_info_fields(
            dict(is_found=False, is_in_path=False, value=U256_MAX,
                 hash=list(D.EMPTY_HASH))
        )
    )
    return dummy_row + node_info_fields(index_w)


def build_tree_bound_row(
    b: CircuitBuilder,
    params: UniversalQueryParams,
    row_tree_depth: int,
    index_tree_depth: int,
    pad_to: Optional[int] = None,
):
    """Universal query circuit + tree binding (row_chunk_processing.rs
    RowProcessingGadget): recompute the cells root from the column wires,
    path-verify the row into the rows tree and the rows tree into the
    index tree, expose index root + boundary info.  Returns the assign
    closure; registers base PIs + index_root(4) + boundary(64) [+ zero pad
    to `pad_to`]."""
    uc = build_universal_query_circuit(params, builder=b)
    cols = uc.wires["columns"]
    cids = uc.wires["column_ids"]
    cells_root = _cells_root_circuit(b, cids[2:], cols[2:])
    row_path = add_merkle_path_with_neighbors(
        b, cids[1], cols[1], cells_root, row_tree_depth
    )
    index_path = add_merkle_path_with_neighbors(
        b, cids[0], cols[0], row_path.root, index_tree_depth
    )
    extra = list(index_path.root) + (
        row_path.node.to_targets() + index_path.node.to_targets()
    )
    # index-column values (primary = block, secondary) after the boundary:
    # the tabular revelation range-checks matching rows against the query
    # bounds (revelation_unproven_offset.rs verifies them per row proof)
    extra += list(cols[0].limbs) + list(cols[1].limbs)
    if pad_to is not None:
        extra += [b.zero()] * (pad_to - _row_base_width(params) - len(extra))
    b.register_public_inputs(extra)

    def assign(inputs, pis, column_ids, row, placeholders, bounds,
               binding: "RowBinding"):
        uc.assign(inputs, pis, column_ids, row, placeholders, bounds)
        set_merkle_path_with_neighbors(inputs, row_path, binding.row_w)
        set_merkle_path_with_neighbors(inputs, index_path, binding.index_w)

    return assign


@dataclass
class RowBinding:
    """Host-side Merkle-path witnesses binding one row to the committed
    trees: `row_w` from the rows-tree view at the row's epoch, `index_w`
    from the (latest) block tree."""

    row_w: dict
    index_w: dict

    def boundary_fields(self) -> List[int]:
        return node_info_fields(self.row_w) + node_info_fields(self.index_w)


def make_row_binding(rows_view, row_key, block_view, block) -> RowBinding:
    return RowBinding(
        row_w=host_neighbor_path_from_tree(rows_view, row_key),
        index_w=host_neighbor_path_from_tree(block_view, block),
    )


class QueryCircuits:
    """The query-side circuit sets: row (universal) -> chunks -> revelation.

    `ivc_framework`: the finalized IVC set from VerifiableDbCircuits (the
    revelation circuit verifies an IVC proof against it); pass None to
    build a standalone query stack without database binding (testing).

    `row_tree_depth` / `index_tree_depth` > 0 enable TREE-BOUND mode: row
    proofs carry Merkle paths into the rows/index trees and the chunk
    stack enforces the consecutive-rows completeness argument."""

    def __init__(
        self,
        config: CircuitConfig,
        params: UniversalQueryParams = UniversalQueryParams(),
        ivc_framework: Optional[RecursionFramework] = None,
        row_tree_depth: int = 0,
        index_tree_depth: int = 0,
        tabular_rows: int = 0,
        num_rows_per_chunk: int = 3,
        chunk_fanin: int = 2,
        device="cuda",
    ):
        self.config = config
        self.params = params
        self.ivc_framework = ivc_framework
        self.bind = row_tree_depth > 0
        self.row_tree_depth = row_tree_depth
        self.index_tree_depth = index_tree_depth
        self.tabular_rows = tabular_rows
        self.num_rows_per_chunk = num_rows_per_chunk
        self.chunk_fanin = chunk_fanin
        W = _pi_width(params, self.bind)
        self.W = W
        bind = self.bind

        # --- row set: the universal query circuit, one VK for all queries
        self.row = RecursionFramework(config, W, set_height=1,
                                      device=device)

        def row_build(b):
            if not bind:
                uc = build_universal_query_circuit(params, builder=b)
                pad = [b.zero()] * (W - _row_base_width(params))
                b.register_public_inputs(pad)
                return uc.assign
            return build_tree_bound_row(
                b, params, row_tree_depth, index_tree_depth, pad_to=W
            )

        self.row.add_leaf_circuit("row", row_build)
        if tabular_rows:
            assert bind, "tabular revelation requires tree-bound mode"
            self.row.add_leaf_circuit(
                "row_dummy", lambda b: build_row_dummy(b, params, W)
            )
        self.row.finalize()

        # --- chunk set
        self.chunk = RecursionFramework(config, W, set_height=2,
                                        device=device)
        p = params

        if bind:
            # NUM_ROWS rows per chunk proof IN ONE CIRCUIT
            # (row_chunk_processing.rs) — no per-row recursion on this path
            self.chunk.add_leaf_circuit(
                "row_chunk",
                lambda b: build_row_chunk(
                    b, p, W, num_rows_per_chunk, row_tree_depth,
                    index_tree_depth,
                ),
            )
        else:
            # standalone (non-tree-bound) stack keeps the recursive
            # row-proof pairing
            def chunk_from_rows(n_rows):
                def build(b, children, foreign):
                    return build_chunk_from_rows(b, p, W, bind, foreign)

                return build

            self.chunk.add_aggregation_circuit(
                "chunk_pair", 0, chunk_from_rows(2),
                foreign=[self.row, self.row],
            )
            self.chunk.add_aggregation_circuit(
                "chunk_single", 0, chunk_from_rows(1), foreign=[self.row]
            )

        def merge_build(b, children):
            return build_chunk_merge(b, p, W, bind, children)

        self.chunk.add_aggregation_circuit(
            "chunk_merge", chunk_fanin, merge_build
        )
        if bind:
            self.chunk.add_leaf_circuit(
                "non_existence",
                lambda b: build_non_existence(b, p, W, index_tree_depth),
            )
        self.chunk.finalize()

        # --- revelation
        self.revelation = RecursionFramework(config, W, set_height=1,
                                             device=device)
        foreign = [self.chunk] + ([ivc_framework] if ivc_framework else [])

        def reveal_build(b, children, foreign_uvs):
            return build_revelation(
                b, p, W, bind, foreign_uvs[0],
                foreign_uvs[1] if len(foreign_uvs) > 1 else None,
            )

        self.revelation.add_aggregation_circuit(
            "revelation", 0, reveal_build, foreign=foreign
        )
        if tabular_rows:
            tab_foreign = [self.row] * tabular_rows + (
                [ivc_framework] if ivc_framework else []
            )

            def reveal_tab_build(b, children, foreign_uvs):
                return build_revelation_tabular(
                    b, p, W, foreign_uvs[:tabular_rows],
                    foreign_uvs[tabular_rows] if ivc_framework else None,
                )

            self.revelation.add_aggregation_circuit(
                "revelation_tabular", 0, reveal_tab_build, foreign=tab_foreign
            )
        self.revelation.finalize()

    # ---------------------------------------------------------------- prove
    def prove_row(
        self, pis, column_ids, row, placeholders, bounds,
        binding: Optional[RowBinding] = None,
    ):
        args = (pis, column_ids, row, placeholders, bounds)
        if self.bind:
            assert binding is not None, "tree-bound mode needs a RowBinding"
            args = args + (binding,)
        return self.row.prove_leaf(
            "row", args,
            self._row_pis(pis, column_ids, row, placeholders, bounds, binding),
        )

    def _row_pis(self, pis, column_ids, row, placeholders, bounds,
                 binding: Optional[RowBinding] = None):
        from mp2_tpu_torch.vdb.query.universal import UniversalQueryCircuit

        uc = UniversalQueryCircuit(params=self.params, data=None, assign=None)
        vals = uc.expected_public_inputs(
            pis, column_ids, row, placeholders, bounds
        )
        if self.bind:
            vals = (
                list(vals)
                + [int(v) for v in binding.index_w["root"]]
                + binding.boundary_fields()
                + u256_to_fields(row[0])
                + u256_to_fields(row[1])
            )
        return list(vals) + [0] * (self.W - len(vals))

    def _query_bounds4(self, bounds) -> Tuple[int, int, int, int]:
        """(min_primary, max_primary, min_secondary, max_secondary)."""
        return (
            bounds.min_block, bounds.max_block,
            getattr(bounds, "min_secondary", 0),
            getattr(bounds, "max_secondary", U256_MAX),
        )

    def prove_query(
        self, pis, column_ids, rows, placeholders, bounds, ivc_env=None,
        bindings: Optional[List[RowBinding]] = None,
        non_existence_witness=None,
    ) -> Tuple[WrappedEnvelope, List[int]]:
        """Prove every row, chunk them pairwise, merge, reveal.  Returns the
        revelation envelope + its user PIs.

        Tree-bound mode: `rows` must be ALL rows of the committed trees
        within the query bounds, in index order (block, then secondary
        value), with `bindings[i]` the Merkle-path witnesses of `rows[i]`.
        The predicate bit gates each row's contribution.  When NO row falls
        inside the primary bounds, pass `non_existence_witness=(node_ident,
        index_w)` — the bracketing index-tree node from the planner's
        find_node_for_non_existence, witnessed via
        host_neighbor_path_from_tree — to prove the range empty instead."""
        if self.bind and not rows:
            assert non_existence_witness is not None, (
                "empty range needs a non-existence witness"
            )
            return self._prove_empty_query(
                pis, column_ids, placeholders, bounds, ivc_env,
                non_existence_witness,
            )
        if self.bind:
            assert bindings is not None and len(bindings) == len(rows)
        else:
            bindings = [None] * len(rows)
        # non-bind mode recursively verifies per-row proofs; tree-bound
        # mode proves NUM_ROWS rows per row-chunk circuit instead
        row_envs = [] if self.bind else [
            self.prove_row(pis, column_ids, r, placeholders, bounds, bi)
            for r, bi in zip(rows, bindings)
        ]
        row_pi_vals = [
            self._row_pis(pis, column_ids, r, placeholders, bounds, bi)
            for r, bi in zip(rows, bindings)
        ]
        W = self.W
        qb4 = self._query_bounds4(bounds)
        qb4_fields = [f for v in qb4 for f in u256_to_fields(v)]

        no = self.params.num_outputs

        def u256_of(limbs):
            val = 0
            for l in limbs:
                val = (val << 32) | l
            return val

        def fold(agg, a, c):
            if agg == int(AggregationOperation.MIN):
                return min(a, c)
            if agg == int(AggregationOperation.MAX):
                return max(a, c)
            return (a + c) % (1 << 256)

        row_base = _row_base_width(self.params)

        def chunk_vals(pivs):
            """Host mirror of the in-circuit chunk aggregation."""
            comp, ph = pivs[0][0:4], pivs[0][4:8]
            aggs = pivs[0][14 : 14 + no]
            count = sum(pv[12] for pv in pivs)
            outs = []
            for j in range(no):
                agg = aggs[j]
                acc = None
                for pv in pivs:
                    pred = pv[12]
                    val = u256_of(pv[14 + no + 8 * j : 14 + no + 8 * (j + 1)])
                    if agg == int(AggregationOperation.MIN):
                        c = val if pred else U256_MAX
                    elif agg == int(AggregationOperation.COUNT):
                        c = pred
                    else:  # SUM / AVG / MAX / ID
                        c = val if pred else 0
                    acc = c if acc is None else fold(agg, acc, c)
                outs.append(acc)
            vals = (
                list(comp) + list(ph) + list(aggs)
                + [f for o in outs for f in u256_to_fields(o)] + [count]
            )
            if self.bind:
                vals += list(pivs[0][row_base : row_base + 4])  # index_root
                vals += qb4_fields
                vals += list(
                    pivs[0][row_base + 4 : row_base + 4 + BOUNDARY_ROW_LEN]
                )
                vals += list(
                    pivs[-1][row_base + 4 : row_base + 4 + BOUNDARY_ROW_LEN]
                )
            return vals + [0] * (W - len(vals))

        chunk_args = (qb4,) if self.bind else ()

        chunk_envs = []
        chunk_piv = []
        if self.bind:
            # NUM_ROWS rows per row-chunk LEAF proof
            # (row_chunk_processing.rs: no per-row recursion)
            R = self.num_rows_per_chunk
            for i in range(0, len(rows), R):
                grp = rows[i : i + R]
                grpb = bindings[i : i + R]
                piv = chunk_vals(row_pi_vals[i : i + len(grp)])
                env = self.chunk.prove_leaf(
                    "row_chunk",
                    (pis, column_ids, grp, placeholders, bounds, grpb),
                    piv,
                )
                chunk_envs.append(env)
                chunk_piv.append(piv)
        else:
            # standalone mode: pair recursive row proofs
            i = 0
            while i < len(row_envs):
                if i + 1 < len(row_envs):
                    piv = chunk_vals([row_pi_vals[i], row_pi_vals[i + 1]])
                    env = self.chunk.prove_aggregation(
                        "chunk_pair", [], chunk_args, piv,
                        foreign_children=[row_envs[i], row_envs[i + 1]],
                    )
                    i += 2
                else:
                    piv = chunk_vals([row_pi_vals[i]])
                    env = self.chunk.prove_aggregation(
                        "chunk_single", [], chunk_args, piv,
                        foreign_children=[row_envs[i]],
                    )
                    i += 1
                chunk_envs.append(env)
                chunk_piv.append(piv)

        chunk_base = _chunk_base_width(self.params)

        def merge_vals(pivs):
            """Host mirror of the fan-in-N chunk merge over REAL chunk
            PIs (dummy slots contribute identity values)."""
            a = pivs[0]
            aggs = a[8 : 8 + no]
            res = []
            for j in range(no):
                off = 8 + no + 8 * j
                acc = u256_of(a[off : off + 8])
                for bv in pivs[1:]:
                    acc = fold(aggs[j], acc, u256_of(bv[off : off + 8]))
                res.append(acc)
            count = sum(pv[8 + no + 8 * no] for pv in pivs)
            vals = (
                list(a[0:8]) + list(aggs)
                + [f for o in res for f in u256_to_fields(o)] + [count]
            )
            if self.bind:
                vals += list(a[chunk_base : chunk_base + 4])
                vals += qb4_fields
                vals += list(
                    a[chunk_base + 36 : chunk_base + 36 + BOUNDARY_ROW_LEN]
                )
                rb_off = chunk_base + 36 + BOUNDARY_ROW_LEN
                vals += list(pivs[-1][rb_off : rb_off + BOUNDARY_ROW_LEN])
            return vals + [0] * (W - len(vals))

        F = self.chunk_fanin
        while len(chunk_envs) > 1:
            nxt_envs, nxt_piv = [], []
            for i in range(0, len(chunk_envs), F):
                grp_envs = chunk_envs[i : i + F]
                grp_piv = chunk_piv[i : i + F]
                if len(grp_envs) == 1:
                    nxt_envs.append(grp_envs[0])
                    nxt_piv.append(grp_piv[0])
                    continue
                n_real = len(grp_envs)
                # dummy slots repeat the last real proof; the witnessed
                # non-dummy flags neutralize their contributions
                pad = grp_envs + [grp_envs[-1]] * (F - n_real)
                piv = merge_vals(grp_piv)
                env = self.chunk.prove_aggregation(
                    "chunk_merge", pad, (n_real,), piv,
                )
                nxt_envs.append(env)
                nxt_piv.append(piv)
            chunk_envs, chunk_piv = nxt_envs, nxt_piv

        root_piv = chunk_piv[0]
        no = self.params.num_outputs
        count = root_piv[8 + no + 8 * no]
        block_root = list(ivc_env.user_inputs[0:4]) if ivc_env else [0, 0, 0, 0]
        results = []
        for j in range(no):
            off = 8 + no + 8 * j
            val = 0
            for l in root_piv[off : off + 8]:
                val = (val << 32) | l
            if root_piv[8 + j] == int(AggregationOperation.AVG):
                val = val // count if count else 0
            results.append(val)
        reveal_piv = (
            list(root_piv[0:8]) + block_root
            + [f for o in results for f in u256_to_fields(o)] + [count]
        )
        reveal_piv += [0] * (W - len(reveal_piv))
        foreign_children = [chunk_envs[0]] + ([ivc_env] if ivc_env else [])
        reveal_args = ()
        if self.bind:
            reveal_args = (pis.placeholder_names, placeholders, bounds)
        env = self.revelation.prove_aggregation(
            "revelation", [], reveal_args, reveal_piv,
            foreign_children=foreign_children,
        )
        return env, reveal_piv

    def _prove_empty_query(
        self, pis, column_ids, placeholders, bounds, ivc_env,
        non_existence_witness,
    ) -> Tuple[WrappedEnvelope, List[int]]:
        """Empty primary range: one non_existence chunk + revelation."""
        from mp2_tpu_torch.vdb.query.universal import UniversalQueryCircuit

        node_ident, index_w = non_existence_witness
        p = self.params
        W = self.W
        no = p.num_outputs
        uc = UniversalQueryCircuit(params=p, data=None, assign=None)
        dummy = uc.expected_public_inputs(
            pis, column_ids, [0] * p.num_columns, placeholders, bounds
        )
        comp_vals, ph_vals = dummy[0:4], dummy[4:8]
        agg_vals = dummy[14 : 14 + no]
        qb4 = self._query_bounds4(bounds)
        qb4_fields = [f for v in qb4 for f in u256_to_fields(v)]

        outs = []
        for j in range(no):
            outs.append(
                U256_MAX
                if agg_vals[j] == int(AggregationOperation.MIN) else 0
            )
        piv = (
            list(comp_vals) + list(ph_vals) + list(agg_vals)
            + [f for o in outs for f in u256_to_fields(o)] + [0]
            + [int(v) for v in index_w["root"]] + qb4_fields
            + non_existence_boundary_fields(index_w)
            + non_existence_boundary_fields(index_w)
        )
        piv += [0] * (W - len(piv))
        chunk_env = self.chunk.prove_leaf(
            "non_existence",
            (comp_vals, ph_vals, agg_vals, qb4, node_ident, index_w),
            piv,
        )

        block_root = list(ivc_env.user_inputs[0:4]) if ivc_env else [0] * 4
        results = []
        for j in range(no):
            v = outs[j]
            if agg_vals[j] == int(AggregationOperation.AVG):
                v = 0
            results.append(v)
        reveal_piv = (
            list(comp_vals) + list(ph_vals) + block_root
            + [f for o in results for f in u256_to_fields(o)] + [0]
        )
        reveal_piv += [0] * (W - len(reveal_piv))
        foreign_children = [chunk_env] + ([ivc_env] if ivc_env else [])
        env = self.revelation.prove_aggregation(
            "revelation", [],
            (pis.placeholder_names, placeholders, bounds), reveal_piv,
            foreign_children=foreign_children,
        )
        return env, reveal_piv

    def prove_query_tabular(
        self, pis, column_ids, rows, placeholders, bounds, ivc_env=None,
        bindings: Optional[List[RowBinding]] = None,
    ) -> Tuple[WrappedEnvelope, List[int]]:
        """Tabular SELECT (no aggregation) through the unproven-offset
        revelation (revelation_unproven_offset.rs): `rows` are the source
        rows of the REVEALED results — already ordered (ascending result
        tuples when DISTINCT), offset-skipped and limit-truncated by the
        host; the circuit proves each revealed result is a true query
        result over the committed tree, not that the selection is
        complete.  Returns (revelation envelope, its user PIs)."""
        from mp2_tpu_torch.vdb.query.universal import UniversalQueryCircuit

        L = self.tabular_rows
        assert L > 0, "QueryCircuits built without tabular_rows"
        assert len(rows) <= L, f"more than {L} revealed rows"
        assert bindings is not None and len(bindings) == len(rows)
        p = self.params
        W = self.W
        no = p.num_outputs

        row_envs = []
        row_pivs = []
        for r, bi in zip(rows, bindings):
            row_envs.append(
                self.prove_row(pis, column_ids, r, placeholders, bounds, bi)
            )
            piv = self._row_pis(pis, column_ids, r, placeholders, bounds, bi)
            assert piv[12] == 1, "revealed row does not match the predicate"
            row_pivs.append(piv)

        if row_pivs:
            comp_vals, ph_vals = row_pivs[0][0:4], row_pivs[0][4:8]
        else:
            uc = UniversalQueryCircuit(params=p, data=None, assign=None)
            dummy = uc.expected_public_inputs(
                pis, column_ids, [0] * p.num_columns, placeholders, bounds
            )
            comp_vals, ph_vals = dummy[0:4], dummy[4:8]
        if len(rows) < L:
            dummy_piv = list(comp_vals) + list(ph_vals)
            dummy_piv += [0] * (W - len(dummy_piv))
            dummy_env = self.row.prove_leaf(
                "row_dummy", (comp_vals, ph_vals), dummy_piv
            )
            while len(row_envs) < L:
                row_envs.append(dummy_env)
                row_pivs.append(dummy_piv)

        limit_v = pis.limit if pis.limit is not None else L
        offset_v = pis.offset or 0
        distinct_v = bool(pis.result.distinct)
        block_root = list(ivc_env.user_inputs[0:4]) if ivc_env else [0] * 4
        reveal_piv = (
            list(comp_vals) + list(ph_vals) + block_root
            + [len(rows), limit_v, offset_v, int(distinct_v)]
        )
        for piv in row_pivs:
            reveal_piv += piv[14 + no : 14 + no + 8 * no]
        reveal_piv += [0] * (W - len(reveal_piv))
        env = self.revelation.prove_aggregation(
            "revelation_tabular", [],
            (pis.placeholder_names, placeholders, bounds, distinct_v,
             limit_v, offset_v),
            reveal_piv,
            foreign_children=row_envs + ([ivc_env] if ivc_env else []),
        )
        return env, reveal_piv

    def verify(self, env: WrappedEnvelope) -> bool:
        return self.revelation.verify(env)
