"""Verifiable-DB circuits: cells / rows / block / IVC with IN-CIRCUIT
digest accumulation and recursive child verification.

The proving counterpart of the host golden model in `vdb.trees` /
`vdb.digests` (reference: verifiable-db/src/{cells_tree,row_tree,
block_tree,ivc}): every node circuit

  * recomputes the node's Poseidon2 hash in-circuit,
  * accumulates EcGFp5 split digests in-circuit (curve gadgets — including
    the hash_to_int scalar-mul transforms),
  * VERIFIES its children's proofs in-circuit: same-set children through
    the universal verifier, the embedded lower layer (cells root inside a
    row, rows root inside a block leaf, block root inside IVC) through a
    cross-set verifier with the lower set's digest baked in — the layer
    chaining of verifiable-db/src/api.rs:93-115.

All four circuit sets share ONE wrapped proof shape (user PIs padded to a
common width), so one standard CommonData serves every verifier gadget.

PI layouts (within the padded width NUM_USER_PIS=43):
  cells: h(4) | individual_digest(11) | multiplier_digest(11)
         | individual_cnt | multiplier_cnt                      (= 28)
  rows:  h(4) | individual_vd(11) | multiplier_vd(11)
         | multiplier_cnt | min(8) | max(8)                     (= 43)
  block: h(4) | digest(11) | min(8) | max(8)                    (= 31)
  ivc:   block_root(4) | metadata(4) | latest_block(1)          (= 9)

A jax-free copy of `mp2_tpu/vdb/circuits.py`: only the imports change, and
`VerifiableDbCircuits` takes the device its circuits are compiled for and
proved on (`device="cuda"` unless the caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.circuit.gadgets.curve import (
    CurveTarget,
    curve_add,
    curve_from_pi_targets,
    curve_scalar_mul_hash128,
    curve_select,
    curve_to_pi_targets,
    curve_zero,
    map_to_curve_point_circuit,
)
from mp2_tpu_torch.circuit.gadgets.u256 import (
    U256Target,
    add_virtual_u256,
    set_u256,
    u256_less_than,
    u256_select,
)
from mp2_tpu_torch.prover.config import CircuitConfig
from mp2_tpu_torch.recursion.runtime import RecursionFramework, WrappedEnvelope
from mp2_tpu_torch.vdb import digests as D

NUM_USER_PIS = 43
EMPTY = list(D.EMPTY_HASH)


def _pad_pis(b: CircuitBuilder, pis: List[Target]) -> List[Target]:
    z = b.zero()
    return pis + [z] * (NUM_USER_PIS - len(pis))


def _pad_vals(vals: List[int]) -> List[int]:
    return [int(v) for v in vals] + [0] * (NUM_USER_PIS - len(vals))


def _bool_input(b: CircuitBuilder) -> Target:
    t = b.add_input()
    b.connect(b.mul(t, t), t)
    return t


def _u256_min(b, x: U256Target, y: U256Target) -> U256Target:
    return u256_select(b, u256_less_than(b, x, y), x, y)


def _u256_max(b, x: U256Target, y: U256Target) -> U256Target:
    return u256_select(b, u256_less_than(b, x, y), y, x)


# ---------------------------------------------------------------------------
# shared sub-gadgets
# ---------------------------------------------------------------------------


def _split_digest(b, digest: CurveTarget, is_mult: Target):
    neutral = curve_zero(b)
    ind = curve_select(b, is_mult, neutral, digest)
    mult = curve_select(b, is_mult, digest, neutral)
    return ind, mult


@dataclass
class _CellsPis:
    h: List[Target]
    ind: CurveTarget
    mult: CurveTarget
    ind_cnt: Target
    mult_cnt: Target

    @staticmethod
    def parse(b, pis: Sequence[Target]) -> "_CellsPis":
        return _CellsPis(
            h=list(pis[0:4]),
            ind=curve_from_pi_targets(b, pis[4:15]),
            mult=curve_from_pi_targets(b, pis[15:26]),
            ind_cnt=pis[26],
            mult_cnt=pis[27],
        )


@dataclass
class _RowsPis:
    h: List[Target]
    ind_vd: CurveTarget
    mult_vd: CurveTarget
    mult_cnt: Target
    mn: U256Target
    mx: U256Target

    @staticmethod
    def parse(b, pis: Sequence[Target]) -> "_RowsPis":
        return _RowsPis(
            h=list(pis[0:4]),
            ind_vd=curve_from_pi_targets(b, pis[4:15]),
            mult_vd=curve_from_pi_targets(b, pis[15:26]),
            mult_cnt=pis[26],
            mn=U256Target(tuple(pis[27:35])),
            mx=U256Target(tuple(pis[35:43])),
        )


@dataclass
class _BlockPis:
    h: List[Target]
    digest: CurveTarget
    mn: U256Target
    mx: U256Target

    @staticmethod
    def parse(b, pis: Sequence[Target]) -> "_BlockPis":
        return _BlockPis(
            h=list(pis[0:4]),
            digest=curve_from_pi_targets(b, pis[4:15]),
            mn=U256Target(tuple(pis[15:23])),
            mx=U256Target(tuple(pis[23:31])),
        )


# ---------------------------------------------------------------------------
# cells tree circuits
# ---------------------------------------------------------------------------


def _cells_common(b):
    """Witness inputs shared by every cells-node circuit."""
    ident = b.add_input()
    value = add_virtual_u256(b)
    is_mult = _bool_input(b)
    digest = map_to_curve_point_circuit(b, [ident] + list(value.limbs))
    ind, mult = _split_digest(b, digest, is_mult)
    return ident, value, is_mult, ind, mult


def _assign_cell(inputs, targets, cell):
    ident, value, is_mult = targets
    inputs[ident] = cell.identifier
    set_u256(inputs, value, cell.value)
    inputs[is_mult] = 1 if cell.is_multiplier else 0


def _cells_register(b, h, ind, mult, ind_cnt, mult_cnt):
    pis = (
        list(h)
        + curve_to_pi_targets(b, ind)
        + curve_to_pi_targets(b, mult)
        + [ind_cnt, mult_cnt]
    )
    b.register_public_inputs(_pad_pis(b, pis))


def cells_pi_values(h, split: D.SplitDigest, ind_cnt: int, mult_cnt: int):
    return _pad_vals(
        list(h)
        + split.individual.to_fields()
        + split.multiplier.to_fields()
        + [ind_cnt, mult_cnt]
    )


def _build_cells_leaf(b):
    ident, value, is_mult, ind, mult = _cells_common(b)
    e = [b.constant(v) for v in EMPTY]
    h = b.hash_no_pad(e + e + [ident] + list(value.limbs))
    ind_cnt = b.logic_not(is_mult)
    _cells_register(b, h, ind, mult, ind_cnt, is_mult)

    def assign(inputs, cell):
        _assign_cell(inputs, (ident, value, is_mult), cell)

    return assign


def _build_cells_full(b, children):
    ident, value, is_mult, ind, mult = _cells_common(b)
    l = _CellsPis.parse(b, children[0].public_inputs())
    r = _CellsPis.parse(b, children[1].public_inputs())
    h = b.hash_no_pad(l.h + r.h + [ident] + list(value.limbs))
    # host order: own, then left, then right (vdb.trees.build_cells_tree)
    ind_t = curve_add(b, curve_add(b, ind, l.ind), r.ind)
    mult_t = curve_add(b, curve_add(b, mult, l.mult), r.mult)
    ind_cnt = b.add(b.add(b.logic_not(is_mult), l.ind_cnt), r.ind_cnt)
    mult_cnt = b.add(b.add(is_mult, l.mult_cnt), r.mult_cnt)
    _cells_register(b, h, ind_t, mult_t, ind_cnt, mult_cnt)

    def assign(inputs, cell):
        _assign_cell(inputs, (ident, value, is_mult), cell)

    return assign


def _build_cells_partial(b, children):
    # single child is always LEFT in the complete-BST cells tree
    ident, value, is_mult, ind, mult = _cells_common(b)
    l = _CellsPis.parse(b, children[0].public_inputs())
    e = [b.constant(v) for v in EMPTY]
    h = b.hash_no_pad(l.h + e + [ident] + list(value.limbs))
    ind_t = curve_add(b, ind, l.ind)
    mult_t = curve_add(b, mult, l.mult)
    ind_cnt = b.add(b.logic_not(is_mult), l.ind_cnt)
    mult_cnt = b.add(is_mult, l.mult_cnt)
    _cells_register(b, h, ind_t, mult_t, ind_cnt, mult_cnt)

    def assign(inputs, cell):
        _assign_cell(inputs, (ident, value, is_mult), cell)

    return assign


# ---------------------------------------------------------------------------
# rows tree circuits
# ---------------------------------------------------------------------------


def _row_common(b, cells: _CellsPis):
    """Row-level digest transform (vdb.digests.row_digest, in-circuit):
    accumulate own cell digest with the cells tree's, then scalar-multiply
    the individual half by HashToInt(H(row_unique_data || individual_cnt))."""
    ident = b.add_input()
    value = add_virtual_u256(b)
    is_mult = _bool_input(b)
    rud = b.add_inputs(4)  # row_unique_data
    own = map_to_curve_point_circuit(b, [ident] + list(value.limbs))
    own_ind, own_mult = _split_digest(b, own, is_mult)
    acc_ind = curve_add(b, own_ind, cells.ind)
    acc_mult = curve_add(b, own_mult, cells.mult)
    ind_cnt = b.add(cells.ind_cnt, b.logic_not(is_mult))
    mult_cnt = b.add(cells.mult_cnt, is_mult)
    rid_h = b.hash_no_pad(list(rud) + [ind_cnt])
    ind_vd = curve_scalar_mul_hash128(b, rid_h[0], rid_h[1], acc_ind)
    return ident, value, is_mult, rud, ind_vd, acc_mult, mult_cnt


def _assign_row(inputs, targets, secondary, row_unique_data):
    ident, value, is_mult, rud = targets
    inputs[ident] = secondary.identifier
    set_u256(inputs, value, secondary.value)
    inputs[is_mult] = 1 if secondary.is_multiplier else 0
    for t, v in zip(rud, row_unique_data):
        inputs[t] = int(v)


def _rows_register(b, h, ind_vd, mult_vd, mult_cnt, mn, mx):
    pis = (
        list(h)
        + curve_to_pi_targets(b, ind_vd)
        + curve_to_pi_targets(b, mult_vd)
        + [mult_cnt]
        + list(mn.limbs)
        + list(mx.limbs)
    )
    b.register_public_inputs(_pad_pis(b, pis))


def rows_pi_values(payload):
    from mp2_tpu_torch.utils.u256 import u256_to_fields

    return _pad_vals(
        list(payload.hash)
        + payload.individual_vd.to_fields()
        + payload.multiplier_vd.to_fields()
        + [payload.multiplier_cnt]
        + u256_to_fields(payload.min_value)
        + u256_to_fields(payload.max_value)
    )


def _row_node_hash_circuit(b, lh, rh, mn, mx, ident, value, cells_h):
    return b.hash_no_pad(
        list(lh)
        + list(rh)
        + list(mn.limbs)
        + list(mx.limbs)
        + [ident]
        + list(value.limbs)
        + list(cells_h)
    )


def _build_rows_leaf(b, children, foreign):
    cells = _CellsPis.parse(b, foreign[0].public_inputs())
    ident, value, is_mult, rud, ind_vd, mult_vd, mult_cnt = _row_common(b, cells)
    e = [b.constant(v) for v in EMPTY]
    h = _row_node_hash_circuit(b, e, e, value, value, ident, value, cells.h)
    _rows_register(b, h, ind_vd, mult_vd, mult_cnt, value, value)

    def assign(inputs, secondary, row_unique_data):
        _assign_row(inputs, (ident, value, is_mult, rud), secondary, row_unique_data)

    return assign


def _connect_child_multiplier(b, mult_vd, mult_cnt, child_pis):
    """row_tree/full_node.rs:46-52: every row of the tree carries the SAME
    multiplier digest/counter (the shared multiplier columns of a merged
    table) — children must match this node's own, not be summed."""
    own_fields = curve_to_pi_targets(b, mult_vd)
    for a, c in zip(own_fields, child_pis[15:26]):
        b.connect(a, c)
    b.connect(mult_cnt, child_pis[26])


def _build_rows_full(b, children, foreign):
    cells = _CellsPis.parse(b, foreign[0].public_inputs())
    ident, value, is_mult, rud, ind_vd, mult_vd, mult_cnt = _row_common(b, cells)
    l = _RowsPis.parse(b, children[0].public_inputs())
    r = _RowsPis.parse(b, children[1].public_inputs())
    mn = _u256_min(b, _u256_min(b, value, l.mn), r.mn)
    mx = _u256_max(b, _u256_max(b, value, l.mx), r.mx)
    ind_t = curve_add(b, curve_add(b, ind_vd, l.ind_vd), r.ind_vd)
    _connect_child_multiplier(b, mult_vd, mult_cnt, children[0].public_inputs())
    _connect_child_multiplier(b, mult_vd, mult_cnt, children[1].public_inputs())
    h = _row_node_hash_circuit(b, l.h, r.h, mn, mx, ident, value, cells.h)
    _rows_register(b, h, ind_t, mult_vd, mult_cnt, mn, mx)

    def assign(inputs, secondary, row_unique_data):
        _assign_row(inputs, (ident, value, is_mult, rud), secondary, row_unique_data)

    return assign


def _build_rows_partial(b, children, foreign):
    cells = _CellsPis.parse(b, foreign[0].public_inputs())
    ident, value, is_mult, rud, ind_vd, mult_vd, mult_cnt = _row_common(b, cells)
    c = _RowsPis.parse(b, children[0].public_inputs())
    child_is_left = _bool_input(b)
    mn = _u256_min(b, value, c.mn)
    mx = _u256_max(b, value, c.mx)
    ind_t = curve_add(b, ind_vd, c.ind_vd)
    _connect_child_multiplier(b, mult_vd, mult_cnt, children[0].public_inputs())
    e = [b.constant(v) for v in EMPTY]
    lh = [b.select(child_is_left, a, z) for a, z in zip(c.h, e)]
    rh = [b.select(child_is_left, z, a) for a, z in zip(c.h, e)]
    h = _row_node_hash_circuit(b, lh, rh, mn, mx, ident, value, cells.h)
    _rows_register(b, h, ind_t, mult_vd, mult_cnt, mn, mx)

    def assign(inputs, secondary, row_unique_data, is_left):
        _assign_row(inputs, (ident, value, is_mult, rud), secondary, row_unique_data)
        inputs[child_is_left] = 1 if is_left else 0

    return assign


# ---------------------------------------------------------------------------
# block (index) tree circuits
# ---------------------------------------------------------------------------


def _block_common(b, rows: _RowsPis):
    """Block-node digest (vdb.digests + trees.BlockPayload.node_digest):
    rows_digest = compute_final_digest(is_merge, ...);
    node_digest = HashToInt(H(index_id || block_number)) * rows_digest."""
    index_id = b.add_input()
    number = add_virtual_u256(b)
    is_merge = _bool_input(b)
    # merge case (block_tree/mod.rs:69-95): final =
    # H2Int(fields(H2Int(H("")||cnt) * mult_vd)) * ind_vd — matching the
    # final-extraction merge digest H2Int(fields(dv_mult)) * dv_ind
    e = [b.constant(v) for v in EMPTY]
    merge_h = b.hash_no_pad(e + [rows.mult_cnt])
    md = curve_scalar_mul_hash128(b, merge_h[0], merge_h[1], rows.mult_vd)
    fh = b.hash_no_pad(curve_to_pi_targets(b, md))
    merged = curve_scalar_mul_hash128(b, fh[0], fh[1], rows.ind_vd)
    rows_digest = curve_select(b, is_merge, merged, rows.ind_vd)
    idx_h = b.hash_no_pad([index_id] + list(number.limbs))
    node_digest = curve_scalar_mul_hash128(b, idx_h[0], idx_h[1], rows_digest)
    return index_id, number, is_merge, node_digest, rows_digest


def _assign_block(inputs, targets, index_id, block_number, is_merge):
    t_id, t_num, t_merge = targets
    inputs[t_id] = index_id
    set_u256(inputs, t_num, block_number)
    inputs[t_merge] = 1 if is_merge else 0


def _block_register(b, h, digest, mn, mx):
    pis = (
        list(h)
        + curve_to_pi_targets(b, digest)
        + list(mn.limbs)
        + list(mx.limbs)
    )
    b.register_public_inputs(_pad_pis(b, pis))


def block_pi_values(payload):
    from mp2_tpu_torch.utils.u256 import u256_to_fields

    return _pad_vals(
        list(payload.hash)
        + payload.digest.to_fields()
        + u256_to_fields(payload.min_value)
        + u256_to_fields(payload.max_value)
    )


def _build_block_leaf(b, children, foreign):
    rows = _RowsPis.parse(b, foreign[0].public_inputs())
    index_id, number, is_merge, digest, _ = _block_common(b, rows)
    e = [b.constant(v) for v in EMPTY]
    h = _row_node_hash_circuit(b, e, e, number, number, index_id, number, rows.h)
    _block_register(b, h, digest, number, number)

    def assign(inputs, index_id_v, block_number, is_merge_v=False):
        _assign_block(inputs, (index_id, number, is_merge), index_id_v,
                      block_number, is_merge_v)

    return assign


def _build_block_leaf_bound(b, children, foreign):
    """Block leaf that ALSO verifies a final-extraction proof and enforces
    in-circuit that the extracted value digest equals the rows-tree digest
    and the extracted block number is this leaf's index value
    (block_tree/leaf.rs:37-60 — the extraction<->DB binding)."""
    from mp2_tpu_torch.extraction.final_circuits import F_BN, F_DV, F_MERGE

    rows = _RowsPis.parse(b, foreign[0].public_inputs())
    ext = foreign[1].public_inputs()
    index_id, number, is_merge, digest, rows_digest = _block_common(b, rows)
    # the merge flag is the EXTRACTION proof's, not a free witness
    b.connect(is_merge, ext[F_MERGE])
    for a, c in zip(list(ext[F_DV]), curve_to_pi_targets(b, rows_digest)):
        b.connect(a, c)
    # extracted block number == leaf index value (low limb; high limbs 0)
    b.connect(number.limbs[-1], ext[F_BN])
    for l in number.limbs[:-1]:
        b.connect(l, b.zero())
    e = [b.constant(v) for v in EMPTY]
    h = _row_node_hash_circuit(b, e, e, number, number, index_id, number, rows.h)
    _block_register(b, h, digest, number, number)

    def assign(inputs, index_id_v, block_number, is_merge_v=False):
        _assign_block(inputs, (index_id, number, is_merge), index_id_v,
                      block_number, is_merge_v)

    return assign


def _block_parent_body(b, children, rows, index_id, number, is_merge, digest):
    l = _BlockPis.parse(b, children[0].public_inputs())
    r = _BlockPis.parse(b, children[1].public_inputs())
    has_r = _bool_input(b)  # sbbst parents always have a left child
    e = [b.constant(v) for v in EMPTY]
    rh = [b.select(has_r, a, z) for a, z in zip(r.h, e)]
    mn = _u256_min(b, number, l.mn)
    mn = u256_select(b, has_r, _u256_min(b, mn, r.mn), mn)
    mx = _u256_max(b, number, l.mx)
    mx = u256_select(b, has_r, _u256_max(b, mx, r.mx), mx)
    d = curve_add(b, digest, l.digest)
    d = curve_add(b, d, curve_select(b, has_r, r.digest, curve_zero(b)))
    h = _row_node_hash_circuit(b, l.h, rh, mn, mx, index_id, number, rows.h)
    _block_register(b, h, d, mn, mx)
    return has_r


def _build_block_parent(b, children, foreign):
    """One or two block children + the node's own rows proof; missing
    children are flagged and replaced by the empty hash / neutral digest."""
    rows = _RowsPis.parse(b, foreign[0].public_inputs())
    index_id, number, is_merge, digest, _ = _block_common(b, rows)
    has_r = _block_parent_body(
        b, children, rows, index_id, number, is_merge, digest
    )

    def assign(inputs, index_id_v, block_number, has_right, is_merge_v=False):
        _assign_block(inputs, (index_id, number, is_merge), index_id_v,
                      block_number, is_merge_v)
        inputs[has_r] = 1 if has_right else 0

    return assign


def _build_block_parent_bound(b, children, foreign):
    """Parent variant with the extraction binding: a block inserted as a
    PARENT (sbbst topology) also verifies its final-extraction proof and
    pins DV/block-number/merge flag (block_tree/parent.rs role)."""
    from mp2_tpu_torch.extraction.final_circuits import F_BN, F_DV, F_MERGE

    rows = _RowsPis.parse(b, foreign[0].public_inputs())
    ext = foreign[1].public_inputs()
    index_id, number, is_merge, digest, rows_digest = _block_common(b, rows)
    b.connect(is_merge, ext[F_MERGE])
    for a, c in zip(list(ext[F_DV]), curve_to_pi_targets(b, rows_digest)):
        b.connect(a, c)
    b.connect(number.limbs[-1], ext[F_BN])
    for l in number.limbs[:-1]:
        b.connect(l, b.zero())
    has_r = _block_parent_body(
        b, children, rows, index_id, number, is_merge, digest
    )

    def assign(inputs, index_id_v, block_number, has_right, is_merge_v=False):
        _assign_block(inputs, (index_id, number, is_merge), index_id_v,
                      block_number, is_merge_v)
        inputs[has_r] = 1 if has_right else 0

    return assign


# ---------------------------------------------------------------------------
# IVC circuits
# ---------------------------------------------------------------------------


def ivc_pi_values(block_root_hash, metadata_hash, latest_block: int):
    return _pad_vals(list(block_root_hash) + list(metadata_hash) + [latest_block])


def _build_ivc_first(b, children, foreign):
    blk = foreign[0].public_inputs()
    metadata = b.add_inputs(4)
    latest = b.add_input()
    pis = list(blk[0:4]) + list(metadata) + [latest]
    b.register_public_inputs(_pad_pis(b, pis))

    def assign(inputs, metadata_hash, latest_block):
        for t, v in zip(metadata, metadata_hash):
            inputs[t] = int(v)
        inputs[latest] = int(latest_block)

    return assign


def _build_ivc_subsequent(b, children, foreign):
    prev = children[0].public_inputs()
    blk = foreign[0].public_inputs()
    metadata = list(prev[4:8])  # metadata hash must carry over unchanged
    latest = b.add_input()
    pis = list(blk[0:4]) + metadata + [latest]
    b.register_public_inputs(_pad_pis(b, pis))

    def assign(inputs, latest_block):
        inputs[latest] = int(latest_block)

    return assign


# ---------------------------------------------------------------------------
# the four chained circuit sets
# ---------------------------------------------------------------------------


class VerifiableDbCircuits:
    """Builds the cells -> rows -> block -> IVC circuit sets with chained
    fixed VKs (verifiable-db/src/api.rs:93-115 role): each set verifies the
    root of the one below in-circuit against that set's digest."""

    def __init__(self, config: CircuitConfig, extraction=None, device="cuda"):
        """`extraction`: an optional FinalExtractionCircuits instance; when
        given, the block set gains a `block_leaf_bound` member that verifies
        a final-extraction proof and pins extraction DV == rows digest +
        block number in-circuit."""
        self.config = config
        self.extraction = extraction
        self.cells = RecursionFramework(config, NUM_USER_PIS, set_height=2,
                                        device=device)
        self.cells.add_leaf_circuit("cells_leaf", _build_cells_leaf)
        self.cells.add_aggregation_circuit("cells_full", 2, _build_cells_full)
        self.cells.add_aggregation_circuit(
            "cells_partial", 1, _build_cells_partial
        )
        self.cells.finalize()

        self.rows = RecursionFramework(config, NUM_USER_PIS, set_height=2,
                                       device=device)
        self.rows.add_aggregation_circuit(
            "rows_leaf", 0, _build_rows_leaf, foreign=[self.cells]
        )
        self.rows.add_aggregation_circuit(
            "rows_full", 2, _build_rows_full, foreign=[self.cells]
        )
        self.rows.add_aggregation_circuit(
            "rows_partial", 1, _build_rows_partial, foreign=[self.cells]
        )
        self.rows.finalize()

        self.block = RecursionFramework(config, NUM_USER_PIS, set_height=2,
                                        device=device)
        self.block.add_aggregation_circuit(
            "block_leaf", 0, _build_block_leaf, foreign=[self.rows]
        )
        if extraction is not None:
            self.block.add_aggregation_circuit(
                "block_leaf_bound", 0, _build_block_leaf_bound,
                foreign=[self.rows, extraction.fw],
            )
        self.block.add_aggregation_circuit(
            "block_parent", 2, _build_block_parent, foreign=[self.rows]
        )
        if extraction is not None:
            self.block.add_aggregation_circuit(
                "block_parent_bound", 2, _build_block_parent_bound,
                foreign=[self.rows, extraction.fw],
            )
        self.block.finalize()

        self.ivc = RecursionFramework(config, NUM_USER_PIS, set_height=1,
                                      device=device)
        self.ivc.add_aggregation_circuit(
            "ivc_first", 0, _build_ivc_first, foreign=[self.block]
        )
        self.ivc.add_aggregation_circuit(
            "ivc_subsequent", 1, _build_ivc_subsequent, foreign=[self.block]
        )
        self.ivc.finalize()

    # ------------------------------------------------------------ proving
    def prove_cells_tree(self, cells_result) -> WrappedEnvelope:
        """Prove a whole cells tree bottom-up (one proof per node)."""
        tree = cells_result.tree
        nodes = cells_result.nodes

        def prove(k: int) -> WrappedEnvelope:
            l, r = tree.children_inner(k)
            node = nodes[k]
            pis = cells_pi_values(
                node.hash, node.split, node.individual_cnt, node.multiplier_cnt
            )
            if l is None and r is None:
                return self.cells.prove_leaf("cells_leaf", (node.cell,), pis)
            if r is None:
                return self.cells.prove_aggregation(
                    "cells_partial", [prove(l)], (node.cell,), pis
                )
            return self.cells.prove_aggregation(
                "cells_full", [prove(l), prove(r)], (node.cell,), pis
            )

        return prove(tree.root_inner())
