"""Top-level pre-processing API: the reference's `mp2_v1::api` umbrella
(mp2-v1/src/api.rs:67-212).

Role: ONE stateless entry point the worker network can drive — build every
circuit family once (`build_circuits_params` -> `PublicParameters`), then
`generate_proof(params, CircuitInput) -> serialized proof envelope`, where
every cross-stage reference is itself a serialized envelope (the
`ProofWithVK` byte-blob discipline of mp2-common/src/proof.rs:42).  This is
the surface `parallel.workqueue` payloads speak.

CircuitInput kinds (api.rs CircuitInput enum equivalents):
  values_trie     — map phase over one table's storage-trie paths
  contract        — state-trie walk to the contract's account leaf
  block           — header extraction
  final_simple / final_lengthed / final_merge — reduce-phase join
  cells_tree      — one row's cells tree (all nodes)
  rows_node       — one rows-tree node (leaf/full/partial)
  block_node      — one index-tree node (leaf/parent, extraction-bound)
  ivc             — first/subsequent IVC step

The flagship drivers (`models.circuit_pipeline`) call the families
directly; this module re-exposes the same provers over serialized
dictionaries so proving can be distributed process-by-process.

A jax-free copy of `mp2_tpu/api.py`: only the imports change, and
`build_circuits_params` builds every set for the device it is given
(`device="cuda"` unless the caller asks for the CPU).  The length set waits
for ROADMAP Queue 1 item 3b.3: `build_circuits_params(length_slot=...)`
raises through the final set's refusal before any set is built, and
`generate_proof` raises on the `length` and `final_lengthed` kinds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from mp2_tpu_torch.extraction.circuits import fixture_header_offsets
from mp2_tpu_torch.extraction.final_circuits import (
    BlockExtractionFramework,
    ContractExtractionCircuits,
    FinalExtractionCircuits,
)
from mp2_tpu_torch.extraction.mpt_circuits import ValuesExtractionCircuits
from mp2_tpu_torch.models.pipeline import MappingTableConfig
from mp2_tpu_torch.prover.config import CircuitConfig, test_config
from mp2_tpu_torch.recursion.runtime import WrappedEnvelope
from mp2_tpu_torch.vdb.circuits import VerifiableDbCircuits


@dataclass
class PublicParameters:
    """All circuit families for one table description (api.rs
    PublicParameters).  Deterministic for a given (cfg, header shape,
    CircuitConfig): workers rebuild identical parameters from the same
    description (the reference serializes its params to disk; here the
    build itself is the canonical serialization)."""

    cfg: MappingTableConfig
    config: CircuitConfig
    vx: ValuesExtractionCircuits
    cx: ContractExtractionCircuits
    bx: BlockExtractionFramework
    fx: FinalExtractionCircuits
    vdb: VerifiableDbCircuits
    vx_b: Optional[ValuesExtractionCircuits] = None
    lx: None = None  # the length set: ROADMAP Queue 1 item 3b.3


def build_circuits_params(
    cfg: MappingTableConfig,
    header: bytes,
    config: Optional[CircuitConfig] = None,
    length_slot: Optional[int] = None,
    branch_arities=(1, 2, 3),
    device="cuda",
) -> PublicParameters:
    """Build every pre-processing circuit family (api.rs
    build_circuits_params): values / contract / block extraction sets,
    the final-extraction set chaining their VKs, and the verifiable-db
    sets chained onto final extraction.  `cfg` may be a
    MergedTableConfig (adds the multiplier table's set + final_merge);
    `length_slot` raises until the length set lands (ROADMAP Queue 1 item
    3b.3).  Every set is built for `device`."""
    if length_slot is not None:
        FinalExtractionCircuits(None, None, None, length=length_slot)  # raises
    c = config or test_config()
    merged = hasattr(cfg, "single_slot")
    vx = ValuesExtractionCircuits(
        [cfg.column], cfg.value_id, config=c,
        mapping=(cfg.slot, cfg.key_id), branch_arities=branch_arities,
        device=device,
    )
    vx_b = None
    if merged:
        vx_b = ValuesExtractionCircuits(
            [cfg.single_column], cfg.supply_id, config=c,
            branch_arities=branch_arities, device=device,
        )
    cx = ContractExtractionCircuits(cfg.contract_address, config=c, device=device)
    bx = BlockExtractionFramework(
        config=c, device=device, **fixture_header_offsets(header)
    )
    lx = None
    fx = FinalExtractionCircuits(
        bx, cx, vx, config=c, length=lx, merge_with=vx_b, device=device
    )
    vdb = VerifiableDbCircuits(c, extraction=fx, device=device)
    return PublicParameters(
        cfg=cfg, config=c, vx=vx, cx=cx, bx=bx, fx=fx, vdb=vdb,
        vx_b=vx_b, lx=lx,
    )


# --------------------------------------------------------------- envelopes


def _env_out(env: WrappedEnvelope) -> Dict:
    return env.to_dict()


def _env_in(d: Dict) -> WrappedEnvelope:
    return WrappedEnvelope.from_dict(d)


def _unhex(v) -> bytes:
    return bytes.fromhex(v) if isinstance(v, str) else bytes(v)


def generate_proof(params: PublicParameters, circuit_input: Dict) -> Dict:
    """One proof from one serialized CircuitInput (api.rs
    generate_proof): dispatch on `circuit_input['kind']`; child proofs
    arrive as serialized envelopes inside the payload; the result is a
    serialized envelope."""
    kind = circuit_input["kind"]
    p = circuit_input

    if kind == "block":
        env, _ = params.bx.prove_header(_unhex(p["header"]))
        return _env_out(env)

    if kind == "contract":
        env, _ = params.cx.prove_state_path(
            [_unhex(n) for n in p["proof_nodes"]]
        )
        return _env_out(env)

    if kind in ("length", "final_lengthed"):
        raise NotImplementedError(
            f"CircuitInput kind {kind!r}: the length set and final_lengthed wait for "
            "ROADMAP Queue 1 item 3b.3")

    if kind == "values_trie":
        vxs = params.vx_b if p.get("table") == "b" else params.vx
        paths = {
            i: [_unhex(n) for n in nodes]
            for i, nodes in enumerate(p["paths"])
        }
        def leaf_arg(a):
            if isinstance(a, str):
                return _unhex(a)  # mapping key bytes
            if (
                isinstance(a, (list, tuple)) and len(a) == 2
                and isinstance(a[0], (list, tuple))
            ):
                return (list(a[0]), int(a[1]))  # (key nibbles, evm_word)
            return a  # key nibbles

        leaf_args = {i: leaf_arg(a) for i, a in enumerate(p["leaf_args"])}
        env, _ = vxs.prove_trie(paths, leaf_args)
        return _env_out(env)

    if kind == "final_simple":
        env, _ = params.fx.prove(
            _env_in(p["block"]), _env_in(p["contract"]), _env_in(p["values"])
        )
        return _env_out(env)

    if kind == "final_merge":
        env, _ = params.fx.prove_merge(
            _env_in(p["block"]), _env_in(p["contract"]),
            _env_in(p["table_a"]), _env_in(p["table_b"]),
            is_table_a_multiplier=bool(p.get("is_table_a_multiplier")),
        )
        return _env_out(env)

    if kind == "cells_tree":
        from mp2_tpu_torch.vdb.trees import Cell, build_cells_tree

        cells = build_cells_tree(
            [Cell(c["identifier"], c["value"], bool(c.get("is_multiplier")))
             for c in p["cells"]]
        )
        return _env_out(params.vdb.prove_cells_tree(cells))

    if kind == "rows_node":
        from mp2_tpu_torch.vdb.trees import Cell

        sec = p["secondary"]
        secondary = Cell(
            sec["identifier"], sec["value"], bool(sec.get("is_multiplier"))
        )
        rud = tuple(p["row_unique_data"])
        children = [_env_in(e) for e in p.get("children", [])]
        cells_env = _env_in(p["cells"])
        pis = list(p["claimed_pis"])
        if not children:
            return _env_out(params.vdb.rows.prove_aggregation(
                "rows_leaf", [], (secondary, rud), pis,
                foreign_children=[cells_env],
            ))
        if len(children) == 2:
            return _env_out(params.vdb.rows.prove_aggregation(
                "rows_full", children, (secondary, rud), pis,
                foreign_children=[cells_env],
            ))
        return _env_out(params.vdb.rows.prove_aggregation(
            "rows_partial", children,
            (secondary, rud, bool(p["child_is_left"])), pis,
            foreign_children=[cells_env],
        ))

    if kind == "block_node":
        children = [_env_in(e) for e in p.get("children", [])]
        foreign = [_env_in(p["rows_root"])]
        bound = "extraction" in p
        if bound:
            foreign.append(_env_in(p["extraction"]))
        pis = list(p["claimed_pis"])
        is_merge = bool(p.get("is_merge"))
        if not children:
            name = "block_leaf_bound" if bound else "block_leaf"
            return _env_out(params.vdb.block.prove_aggregation(
                name, [], (p["index_id"], p["block_number"], is_merge),
                pis, foreign_children=foreign,
            ))
        name = "block_parent_bound" if bound else "block_parent"
        return _env_out(params.vdb.block.prove_aggregation(
            name, children,
            (p["index_id"], p["block_number"], bool(p["has_right"]),
             is_merge),
            pis, foreign_children=foreign,
        ))

    if kind == "ivc":
        block_root = _env_in(p["block_root"])
        pis = list(p["claimed_pis"])
        if "previous" in p:
            return _env_out(params.vdb.ivc.prove_aggregation(
                "ivc_subsequent", [_env_in(p["previous"])],
                (p["latest_block"],), pis, foreign_children=[block_root],
            ))
        return _env_out(params.vdb.ivc.prove_aggregation(
            "ivc_first", [],
            (tuple(p["metadata_hash"]), p["latest_block"]), pis,
            foreign_children=[block_root],
        ))

    raise ValueError(f"unknown CircuitInput kind {kind!r}")


def verify_envelope(params: PublicParameters, env_dict: Dict) -> bool:
    """Verify one serialized envelope against whichever family owns its
    member (the ONE host check of the fixed-VK discipline)."""
    env = _env_in(env_dict)
    for fw in (
        params.vx.fw,
        params.vx_b.fw if params.vx_b else None,
        params.cx.fw, params.bx.fw, params.fx.fw,
        params.lx.fw if params.lx else None,
        params.vdb.cells, params.vdb.rows, params.vdb.block, params.vdb.ivc,
    ):
        # member NAMES repeat across sets (both values sets have
        # "extension"/"branchN"); try every owner — the set digest riding
        # in the proof makes acceptance unambiguous
        if fw is not None and env.member in fw.members and fw.verify(env):
            return True
    return False
