"""Merkle-path gadgets: recompute a rows/index-tree ROOT from a node hash
and a witnessed ancestor path (reference: verifiable-db/src/query/
merkle_path.rs:1-50), and the neighbors-aware variant that additionally
derives the end node's PREDECESSOR and SUCCESSOR info
(MerklePathWithNeighborsGadget, merkle_path.rs:440-690) — the building
block of the consecutive-rows completeness argument.

Each ancestor is a row/block-layout node H(lh || rh || min(8) || max(8)
|| id || value(8) || inner(4)); at every level the previous hash slots in
as the left or right child (witnessed position bit), everything else is
witnessed.  The final hash is returned for binding against a committed
tree root (block-leaf rows_hash, IVC block root).

Fixed depth with an `active` flag per level (shorter real paths deactivate
the tail, passing the hash through unchanged) — ROW_TREE_MAX_DEPTH /
INDEX_TREE_MAX_DEPTH style bounds.

A jax-free copy of `mp2_tpu/vdb/query/merkle_path.py`: only the imports
change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.vdb import digests as D


@dataclass
class PathLevelTargets:
    active: Target
    is_left: Target  # 1 when the child hash is the LEFT slot
    sibling: List[Target]  # 4
    mn: List[Target]  # 8
    mx: List[Target]  # 8
    ident: Target
    value: List[Target]  # 8
    inner: List[Target]  # 4


@dataclass
class MerklePathTargets:
    levels: List[PathLevelTargets]
    root: List[Target]  # 4


def _bool_input(b):
    t = b.add_input()
    b.connect(b.mul(t, t), t)
    return t


def add_merkle_path(
    b: CircuitBuilder, start_hash: Sequence[Target], max_depth: int
) -> MerklePathTargets:
    h = list(start_hash)
    levels = []
    e = [b.constant(v) for v in D.EMPTY_HASH]
    for _ in range(max_depth):
        lv = PathLevelTargets(
            active=_bool_input(b),
            is_left=_bool_input(b),
            sibling=b.add_inputs(4),
            mn=b.add_inputs(8),
            mx=b.add_inputs(8),
            ident=b.add_input(),
            value=b.add_inputs(8),
            inner=b.add_inputs(4),
        )
        lh = [b.select(lv.is_left, a, s) for a, s in zip(h, lv.sibling)]
        rh = [b.select(lv.is_left, s, a) for a, s in zip(h, lv.sibling)]
        parent = b.hash_no_pad(
            lh + rh + lv.mn + lv.mx + [lv.ident] + lv.value + lv.inner
        )
        h = [b.select(lv.active, p, c) for p, c in zip(parent, h)]
        levels.append(lv)
    return MerklePathTargets(levels=levels, root=h)


def set_merkle_path(
    inputs: Dict,
    mt: MerklePathTargets,
    path: Sequence[dict],
) -> None:
    """path: per real level a dict with keys is_left, sibling(4), mn(8),
    mx(8), ident, value(8), inner(4); shorter than max_depth is fine."""
    for i, lv in enumerate(mt.levels):
        if i < len(path):
            p = path[i]
            inputs[lv.active] = 1
            inputs[lv.is_left] = 1 if p["is_left"] else 0
            vals = (
                list(p["sibling"]) + list(p["mn"]) + list(p["mx"])
                + [p["ident"]] + list(p["value"]) + list(p["inner"])
            )
        else:
            inputs[lv.active] = 0
            inputs[lv.is_left] = 0
            vals = [0] * 25
        ts = (
            list(lv.sibling) + list(lv.mn) + list(lv.mx) + [lv.ident]
            + list(lv.value) + list(lv.inner)
        )
        for t, v in zip(ts, vals):
            inputs[t] = int(v)


def host_path_from_tree(db, key) -> List[dict]:
    """Build the witness path for `key` up a rows/block MerkleTreeKvDb
    (sibling payload fields per ancestor)."""
    from mp2_tpu_torch.utils.u256 import u256_to_fields

    path = []
    cur = key
    parent = db.tree.parent(cur)
    while parent is not None:
        l, r = db.tree.children(parent)
        is_left = l == cur
        sib = r if is_left else l
        sib_h = list(db.payload(sib).hash) if sib is not None else list(D.EMPTY_HASH)
        pp = db.payload(parent)
        if hasattr(pp, "secondary"):  # rows tree payload
            ident = pp.secondary.identifier
            value = u256_to_fields(pp.secondary.value)
            inner = list(pp.cells.root_hash)
        else:  # block tree payload
            ident = pp.index_id
            value = u256_to_fields(pp.block_number)
            inner = list(pp.rows_hash)
        path.append(
            dict(
                is_left=is_left,
                sibling=sib_h,
                mn=u256_to_fields(pp.min_value),
                mx=u256_to_fields(pp.max_value),
                ident=ident,
                value=value,
                inner=inner,
            )
        )
        cur = parent
        parent = db.tree.parent(cur)
    return path


# ===========================================================================
# neighbors-aware path gadget (merkle_path.rs MerklePathWithNeighborsGadget)
# ===========================================================================
#
# Node-hash layout (shared by the rows tree and the block/index tree):
#   H(lh(4) || rh(4) || min(8) || max(8) || ident || value(8) || inner(4))
# The `ident` (index column id) is a circuit TARGET shared by every level —
# all nodes of one tree carry the same column identifier.
#
# Witness u256 limbs here are NOT range-checked: every limb is bound
# through the Poseidon preimage of a node hash that must chain up to a
# committed root, so a non-canonical limb encoding changes the hash and
# the path no longer verifies.  (merkle_path.rs uses *_unsafe for the
# same reason.)

from mp2_tpu_torch.circuit.gadgets.u256 import (
    U256Target,
    add_virtual_u256,
    set_u256,
    u256_constant,
    u256_lte,
    u256_select,
)
from mp2_tpu_torch.utils.u256 import U256_MAX, u256_to_fields


@dataclass
class NeighborInfoTargets:
    """Info about the predecessor/successor of a node (NeighborInfoTarget,
    merkle_path.rs:137-148)."""

    is_found: Target
    is_in_path: Target
    value: U256Target
    hash: List[Target]  # 4; EMPTY_HASH unless the neighbor sits ON the path

    def to_targets(self) -> List[Target]:
        return (
            [self.is_found, self.is_in_path]
            + list(self.value.limbs)
            + list(self.hash)
        )

    @staticmethod
    def from_targets(ts: Sequence[Target]) -> "NeighborInfoTargets":
        return NeighborInfoTargets(
            is_found=ts[0],
            is_in_path=ts[1],
            value=U256Target(tuple(ts[2:10])),
            hash=list(ts[10:14]),
        )


NEIGHBOR_INFO_LEN = 14


@dataclass
class ChildInfoTargets:
    """Full data of an end-node child, enough to recompute its hash."""

    lh: List[Target]  # 4
    rh: List[Target]  # 4
    mn: U256Target
    mx: U256Target
    value: U256Target
    inner: List[Target]  # 4


@dataclass
class NodeInfoTargets:
    """A boundary node's exposed data (BoundaryRowNodeInfoTarget)."""

    end_hash: List[Target]  # 4
    predecessor: NeighborInfoTargets
    successor: NeighborInfoTargets

    def to_targets(self) -> List[Target]:
        return (
            list(self.end_hash)
            + self.predecessor.to_targets()
            + self.successor.to_targets()
        )

    @staticmethod
    def from_targets(ts: Sequence[Target]) -> "NodeInfoTargets":
        return NodeInfoTargets(
            end_hash=list(ts[0:4]),
            predecessor=NeighborInfoTargets.from_targets(ts[4:18]),
            successor=NeighborInfoTargets.from_targets(ts[18:32]),
        )


NODE_INFO_LEN = 4 + 2 * NEIGHBOR_INFO_LEN  # 32


@dataclass
class NeighborLevelTargets:
    active: Target
    is_left: Target
    sibling: List[Target]  # 4
    mn: U256Target
    mx: U256Target
    value: U256Target
    inner: List[Target]  # 4


@dataclass
class MerklePathNeighborTargets:
    levels: List[NeighborLevelTargets]
    end_mn: U256Target
    end_mx: U256Target
    left_exists: Target
    right_exists: Target
    left_child: ChildInfoTargets
    right_child: ChildInfoTargets
    root: List[Target]  # 4
    node: NodeInfoTargets  # end hash + predecessor/successor info


def _child_info(b: CircuitBuilder) -> ChildInfoTargets:
    return ChildInfoTargets(
        lh=b.add_inputs(4),
        rh=b.add_inputs(4),
        mn=add_virtual_u256(b, range_check=False),
        mx=add_virtual_u256(b, range_check=False),
        value=add_virtual_u256(b, range_check=False),
        inner=b.add_inputs(4),
    )


def _node_hash(b, lh, rh, mn, mx, ident, value, inner) -> List[Target]:
    return b.hash_no_pad(
        list(lh) + list(rh) + list(mn.limbs) + list(mx.limbs)
        + [ident] + list(value.limbs) + list(inner)
    )


def add_merkle_path_with_neighbors(
    b: CircuitBuilder,
    ident: Target,
    end_value: U256Target,
    end_inner: Sequence[Target],
    max_depth: int,
) -> MerklePathNeighborTargets:
    """Recompute the end node's hash from witnessed children info, walk a
    witnessed ancestor path to the root, and derive predecessor/successor
    info along the way (merkle_path.rs:545-690)."""
    e = [b.constant(v) for v in D.EMPTY_HASH]
    end_mn = add_virtual_u256(b, range_check=False)
    end_mx = add_virtual_u256(b, range_check=False)
    left_exists = _bool_input(b)
    right_exists = _bool_input(b)
    lc = _child_info(b)
    rc = _child_info(b)
    lc_hash = _node_hash(b, lc.lh, lc.rh, lc.mn, lc.mx, ident, lc.value, lc.inner)
    rc_hash = _node_hash(b, rc.lh, rc.rh, rc.mn, rc.mx, ident, rc.value, rc.inner)
    lh = [b.select(left_exists, a, c) for a, c in zip(lc_hash, e)]
    rh = [b.select(right_exists, a, c) for a, c in zip(rc_hash, e)]
    end_hash = _node_hash(b, lh, rh, end_mn, end_mx, ident, end_value, end_inner)

    zero256 = u256_constant(b, 0)
    max256 = u256_constant(b, U256_MAX)
    # predecessor: in the left subtree (its max) when a left child exists,
    # otherwise it is an ancestor found along the path
    pred = NeighborInfoTargets(
        is_found=left_exists,
        is_in_path=b.logic_not(left_exists),
        value=u256_select(b, left_exists, lc.mx, zero256),
        hash=list(e),
    )
    succ = NeighborInfoTargets(
        is_found=right_exists,
        is_in_path=b.logic_not(right_exists),
        value=u256_select(b, right_exists, rc.mn, max256),
        hash=list(e),
    )

    h = list(end_hash)
    levels: List[NeighborLevelTargets] = []
    for _ in range(max_depth):
        lv = NeighborLevelTargets(
            active=_bool_input(b),
            is_left=_bool_input(b),
            sibling=b.add_inputs(4),
            mn=add_virtual_u256(b, range_check=False),
            mx=add_virtual_u256(b, range_check=False),
            value=add_virtual_u256(b, range_check=False),
            inner=b.add_inputs(4),
        )
        plh = [b.select(lv.is_left, a, s) for a, s in zip(h, lv.sibling)]
        prh = [b.select(lv.is_left, s, a) for a, s in zip(h, lv.sibling)]
        parent = _node_hash(b, plh, prh, lv.mn, lv.mx, ident, lv.value, lv.inner)
        h = [b.select(lv.active, p, c) for p, c in zip(parent, h)]

        # the parent is the predecessor when we arrive from its RIGHT child
        is_right = b.logic_not(lv.is_left)
        is_pred = b.logic_and(
            b.logic_and(b.logic_not(pred.is_found), lv.active), is_right
        )
        pred.hash = [b.select(is_pred, p, c) for p, c in zip(h, pred.hash)]
        pred.value = u256_select(b, is_pred, lv.value, pred.value)
        pred.is_found = b.logic_or(pred.is_found, is_pred)
        # the parent is the successor when we arrive from its LEFT child
        is_succ = b.logic_and(
            b.logic_and(b.logic_not(succ.is_found), lv.active), lv.is_left
        )
        succ.hash = [b.select(is_succ, p, c) for p, c in zip(h, succ.hash)]
        succ.value = u256_select(b, is_succ, lv.value, succ.value)
        succ.is_found = b.logic_or(succ.is_found, is_succ)
        levels.append(lv)

    return MerklePathNeighborTargets(
        levels=levels,
        end_mn=end_mn,
        end_mx=end_mx,
        left_exists=left_exists,
        right_exists=right_exists,
        left_child=lc,
        right_child=rc,
        root=h,
        node=NodeInfoTargets(
            end_hash=list(end_hash), predecessor=pred, successor=succ
        ),
    )


def set_merkle_path_with_neighbors(
    inputs: Dict, mt: MerklePathNeighborTargets, w: dict
) -> None:
    """Witness dict `w` comes from host_neighbor_path_from_tree."""
    set_u256(inputs, mt.end_mn, w["end_mn"])
    set_u256(inputs, mt.end_mx, w["end_mx"])
    inputs[mt.left_exists] = 1 if w["left"] is not None else 0
    inputs[mt.right_exists] = 1 if w["right"] is not None else 0
    for child_t, cw in ((mt.left_child, w["left"]), (mt.right_child, w["right"])):
        cw = cw or dict(lh=D.EMPTY_HASH, rh=D.EMPTY_HASH, mn=0, mx=0, value=0,
                        inner=D.EMPTY_HASH)
        for t, v in zip(child_t.lh, cw["lh"]):
            inputs[t] = int(v)
        for t, v in zip(child_t.rh, cw["rh"]):
            inputs[t] = int(v)
        set_u256(inputs, child_t.mn, cw["mn"])
        set_u256(inputs, child_t.mx, cw["mx"])
        set_u256(inputs, child_t.value, cw["value"])
        for t, v in zip(child_t.inner, cw["inner"]):
            inputs[t] = int(v)
    path = w["levels"]
    assert len(path) <= len(mt.levels), (
        f"Merkle path needs {len(path)} levels but the circuit was built "
        f"with depth {len(mt.levels)} — raise the tree-depth bound"
    )
    for i, lv in enumerate(mt.levels):
        if i < len(path):
            p = path[i]
            inputs[lv.active] = 1
            inputs[lv.is_left] = 1 if p["is_left"] else 0
            for t, v in zip(lv.sibling, p["sibling"]):
                inputs[t] = int(v)
            set_u256(inputs, lv.mn, p["mn"])
            set_u256(inputs, lv.mx, p["mx"])
            set_u256(inputs, lv.value, p["value"])
            for t, v in zip(lv.inner, p["inner"]):
                inputs[t] = int(v)
        else:
            inputs[lv.active] = 0
            inputs[lv.is_left] = 0
            for t in list(lv.sibling) + list(lv.inner):
                inputs[t] = 0
            set_u256(inputs, lv.mn, 0)
            set_u256(inputs, lv.mx, 0)
            set_u256(inputs, lv.value, 0)


# --------------------------------------------------------------------- host


def _payload_fields(payload) -> Tuple[int, int, list]:
    """(value, ident, inner_hash) of a rows/block tree payload."""
    if hasattr(payload, "secondary"):
        return payload.secondary.value, payload.secondary.identifier, list(
            payload.cells.root_hash
        )
    return payload.block_number, payload.index_id, list(payload.rows_hash)


def host_neighbor_path_from_tree(db, key) -> dict:
    """Witness structure for add_merkle_path_with_neighbors + the host
    NeighborInfo mirror (what the circuit derives, for PI computation).

    Returns {end_mn,end_mx,left,right,levels, pred,succ,end_hash,root}."""
    pl = db.payload(key)
    l, r = db.tree.children(key)

    def child_info(c):
        if c is None:
            return None
        cp = db.payload(c)
        cl, cr = db.tree.children(c)
        v, _, inner = _payload_fields(cp)
        return dict(
            lh=list(db.payload(cl).hash) if cl is not None else list(D.EMPTY_HASH),
            rh=list(db.payload(cr).hash) if cr is not None else list(D.EMPTY_HASH),
            mn=cp.min_value,
            mx=cp.max_value,
            value=v,
            inner=inner,
        )

    levels = []
    hashes = []  # node hash at each level AFTER folding (ancestor hashes)
    cur = key
    parent = db.tree.parent(cur)
    while parent is not None:
        pl_p = db.payload(parent)
        cl, cr = db.tree.children(parent)
        is_left = cl == cur
        sib = cr if is_left else cl
        v, _, inner = _payload_fields(pl_p)
        levels.append(
            dict(
                is_left=is_left,
                sibling=list(db.payload(sib).hash) if sib is not None
                else list(D.EMPTY_HASH),
                mn=pl_p.min_value,
                mx=pl_p.max_value,
                value=v,
                inner=inner,
            )
        )
        hashes.append(list(pl_p.hash))
        cur = parent
        parent = db.tree.parent(cur)

    # host mirror of the in-circuit predecessor/successor derivation
    lw, rw = child_info(l), child_info(r)
    pred = dict(
        is_found=lw is not None,
        is_in_path=lw is None,
        value=lw["mx"] if lw is not None else 0,
        hash=list(D.EMPTY_HASH),
    )
    succ = dict(
        is_found=rw is not None,
        is_in_path=rw is None,
        value=rw["mn"] if rw is not None else U256_MAX,
        hash=list(D.EMPTY_HASH),
    )
    for i, lv in enumerate(levels):
        if not pred["is_found"] and not lv["is_left"]:
            pred.update(is_found=True, value=lv["value"], hash=hashes[i])
        if not succ["is_found"] and lv["is_left"]:
            succ.update(is_found=True, value=lv["value"], hash=hashes[i])

    end_value, end_ident, end_inner = _payload_fields(pl)
    return dict(
        end_mn=pl.min_value,
        end_mx=pl.max_value,
        end_value=end_value,
        end_ident=end_ident,
        end_inner=end_inner,
        left=lw,
        right=rw,
        levels=levels,
        pred=pred,
        succ=succ,
        end_hash=list(pl.hash),
        root=list(db.payload(db.root()).hash),
    )


def neighbor_info_fields(ni: dict) -> List[int]:
    """Host NeighborInfo -> PI field encoding (matches to_targets)."""
    return (
        [1 if ni["is_found"] else 0, 1 if ni["is_in_path"] else 0]
        + u256_to_fields(ni["value"])
        + [int(v) for v in ni["hash"]]
    )


def node_info_fields(w: dict) -> List[int]:
    """Host boundary-node info -> PI fields (end_hash || pred || succ)."""
    return (
        [int(v) for v in w["end_hash"]]
        + neighbor_info_fields(w["pred"])
        + neighbor_info_fields(w["succ"])
    )


# ===========================================================================
# consecutiveness predicates (row_chunk_gadgets/consecutive_rows.rs)
# ===========================================================================


def _hashes_equal(b, x, y) -> Target:
    acc = None
    for a, c in zip(x, y):
        e = b.is_equal(a, c)
        acc = e if acc is None else b.logic_and(acc, e)
    return acc


def are_consecutive_nodes(
    b: CircuitBuilder,
    first: NodeInfoTargets,
    second: NodeInfoTargets,
    min_bound: U256Target,
    max_bound: U256Target,
    rows_tree: bool,
) -> Tuple[Target, Target]:
    """(are_consecutive, first_succ_in_range) — consecutive_rows.rs:20-158.

    For index-tree nodes (rows_tree=False) both boundary neighbors must be
    found and in range; for rows-tree nodes the chunk may legitimately end
    at a rows-tree boundary whose neighbor is out of range."""
    ok = b.one()
    succ_v = first.successor.value
    ok = b.logic_and(ok, u256_lte(b, min_bound, succ_v))
    succ_in_range = b.logic_and(
        u256_lte(b, succ_v, max_bound), first.successor.is_found
    )
    check = b.logic_and(succ_in_range, first.successor.is_in_path)
    is_succ = _hashes_equal(b, first.successor.hash, second.end_hash)
    ok = b.select(check, b.logic_and(ok, is_succ), ok)

    pred_v = second.predecessor.value
    ok = b.logic_and(ok, u256_lte(b, pred_v, max_bound))
    pred_in_range = b.logic_and(
        u256_lte(b, min_bound, pred_v), second.predecessor.is_found
    )
    check = b.logic_and(pred_in_range, second.predecessor.is_in_path)
    is_pred = _hashes_equal(b, second.predecessor.hash, first.end_hash)
    ok = b.select(check, b.logic_and(ok, is_pred), ok)

    either_in_path = b.logic_or(
        first.successor.is_in_path, second.predecessor.is_in_path
    )
    if not rows_tree:
        ok = b.logic_and(ok, either_in_path)
        ok = b.logic_and(ok, succ_in_range)
        ok = b.logic_and(ok, pred_in_range)
    else:
        # the two sides must agree on whether the boundary stays inside one
        # rows tree; when it does, one of the neighbors must be on a path
        ok = b.logic_and(
            ok, b.logic_not(b.logic_xor(succ_in_range, pred_in_range))
        )
        ok = b.select(
            succ_in_range, b.logic_and(ok, either_in_path), ok
        )
    return ok, succ_in_range


@dataclass
class BoundaryRowTargets:
    """Row + index tree boundary info of one row (BoundaryRowDataTarget)."""

    row: NodeInfoTargets
    index: NodeInfoTargets

    def to_targets(self) -> List[Target]:
        return self.row.to_targets() + self.index.to_targets()

    @staticmethod
    def from_targets(ts: Sequence[Target]) -> "BoundaryRowTargets":
        return BoundaryRowTargets(
            row=NodeInfoTargets.from_targets(ts[0:NODE_INFO_LEN]),
            index=NodeInfoTargets.from_targets(ts[NODE_INFO_LEN:]),
        )


BOUNDARY_ROW_LEN = 2 * NODE_INFO_LEN  # 64


def are_consecutive_rows(
    b: CircuitBuilder,
    first: BoundaryRowTargets,
    second: BoundaryRowTargets,
    min_primary: U256Target,
    max_primary: U256Target,
    min_secondary: U256Target,
    max_secondary: U256Target,
) -> Target:
    """consecutive_rows.rs:163-210: rows-tree consecutiveness, then index
    tree consistency (same rows tree, or consecutive index nodes)."""
    ok, first_succ_in_range = are_consecutive_nodes(
        b, first.row, second.row, min_secondary, max_secondary, True
    )
    same_rows_tree = _hashes_equal(
        b, first.index.end_hash, second.index.end_hash
    )
    idx_ok, _ = are_consecutive_nodes(
        b, first.index, second.index, min_primary, max_primary, False
    )
    index_check = b.select(first_succ_in_range, same_rows_tree, idx_ok)
    return b.logic_and(ok, index_check)
