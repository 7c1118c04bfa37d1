"""Circuit-driven end-to-end pipeline: the TableIndexer flow with REAL
proofs at every stage.

Where `mp2_tpu/models/pipeline.TableIndexer` drives the host-golden
extraction model with attestation envelopes, this indexer drives the actual
circuit families:

  * map phase: every storage-trie node proved by the values-extraction
    circuit set (leaf_mapping / extension / branchN under one fixed VK),
    aggregated bottom-up over the real trie topology
    (mp2-v1/src/values_extraction/api.rs:214-340);
  * contract / block / final extraction proofs verified cross-set inside
    `final_simple` (final_extraction/base_circuit.rs:35-70);
  * cells -> rows -> block trees proved over the ryhope UpdateTree
    workplans, each node verifying its children in-circuit; the NEW block
    node uses the `_bound` member pinning extraction DV == rows digest and
    extracted block number == leaf index (block_tree/mod.rs:37-60);
  * IVC chain verifying the previous IVC proof + the block root proof
    (ivc/api.rs);
  * queries through the TREE-BOUND universal query stack: row proofs walk
    Merkle paths into the committed rows/index trees, chunks enforce the
    consecutive-rows completeness argument, and the revelation proof binds
    the chunk root to the IVC proof
    (query/row_chunk_processing.rs, revelation_without_results_tree.rs).

The result of `run_query` is ONE proof an outside verifier can check
against the query + the table's verification keys.

A jax-free copy of `mp2_tpu/models/circuit_pipeline.py`: only the imports
change, and the circuit sets are built for the device the indexer is given
(`device="cuda"` unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from mp2_tpu_torch.extraction import storage_key as SK
from mp2_tpu_torch.extraction import values as V
from mp2_tpu_torch.extraction.circuits import fixture_header_offsets
from mp2_tpu_torch.extraction.final_circuits import (
    F_DM,
    F_DV,
    BlockExtractionFramework,
    ContractExtractionCircuits,
    FinalExtractionCircuits,
)
from mp2_tpu_torch.extraction.mpt_circuits import ValuesExtractionCircuits
from mp2_tpu_torch.field.ecgfp5 import Point
from mp2_tpu_torch.models.pipeline import BlockFixture, IvcOutput, MappingTableConfig
from mp2_tpu_torch.models.proof_store import MemoryProofStore, ProofDict
from mp2_tpu_torch.parsil.assembler import parse_and_assemble
from mp2_tpu_torch.prover.config import CircuitConfig, test_config
from mp2_tpu_torch.recursion.runtime import WrappedEnvelope
from mp2_tpu_torch.vdb import circuits as C
from mp2_tpu_torch.vdb import digests as D
from mp2_tpu_torch.vdb.circuits import VerifiableDbCircuits
from mp2_tpu_torch.vdb.query.api import (
    Placeholders,
    QueryResult,
    TableData,
    execute_query,
)
from mp2_tpu_torch.vdb.query.chunks import QueryCircuits, make_row_binding
from mp2_tpu_torch.vdb.query.merkle_path import host_neighbor_path_from_tree
from mp2_tpu_torch.vdb.query.planner import find_node_for_non_existence
from mp2_tpu_torch.vdb.query.universal import UniversalQueryParams
from mp2_tpu_torch.vdb.trees import (
    BlockPayload,
    Cell,
    RowPayload,
    build_cells_tree,
    new_block_tree,
    new_row_tree,
)


class CircuitTableIndexer:
    """Extraction -> rows tree -> block tree -> IVC -> query with real
    proofs (the reference's `TableIndexing::run` + `prove_query` loop)."""

    def __init__(
        self,
        cfg: MappingTableConfig,
        config: Optional[CircuitConfig] = None,
        query_params: Optional[UniversalQueryParams] = None,
        row_tree_depth: int = 4,
        index_tree_depth: int = 4,
        branch_arities=(1, 2, 3),
        tabular_rows: int = 0,
        proof_store=None,
        device="cuda",
    ):
        self.cfg = cfg
        self.config = config or test_config()
        self.query_params = query_params or UniversalQueryParams(
            num_columns=3, num_placeholders=4, num_predicate_ops=4,
            num_result_ops=2, num_outputs=2,
        )
        self.row_tree_depth = row_tree_depth
        self.index_tree_depth = index_tree_depth
        self.branch_arities = tuple(branch_arities)
        self.tabular_rows = tabular_rows
        self.column_ids = [cfg.block_id, cfg.key_id, cfg.value_id]
        self.device = device

        self.rows_db = new_row_tree()
        self.block_db = new_block_tree()
        self.table_data = TableData(cfg.schema())

        # proof stores (ProofKV role, proof_storage.rs): latest envelope
        # per tree node, the rows ROOT envelope per epoch (ancestor
        # re-proofs need it), and typed stage proofs — all routed through
        # ONE pluggable ProofStorage (pass SqliteProofKV(path) for durable
        # cross-process storage)
        # `is not None`: an EMPTY SqliteProofKV is len()==0 hence falsy
        self.proof_store = (
            proof_store if proof_store is not None else MemoryProofStore()
        )
        self.rows_node_env = ProofDict(self.proof_store, "row_tree")
        self.rows_root_env = ProofDict(self.proof_store, "rows_root")
        self.block_node_env = ProofDict(self.proof_store, "index_tree")
        self.proofs = ProofDict(self.proof_store)
        self.epoch_of: Dict[int, int] = {}
        self.rows_of_block: Dict[int, Dict[bytes, int]] = {}

        self.ivc_env: Optional[WrappedEnvelope] = None
        self.ivc: Optional[IvcOutput] = None
        self.metadata_hash = None
        self._built = False

    # -- circuit families (built lazily: the block circuit needs the header
    # shape) ------------------------------------------------------------
    def _ensure_built(self, header: bytes):
        if self._built:
            return
        cfg = self.cfg
        self.vx = ValuesExtractionCircuits(
            [cfg.column], cfg.value_id, config=self.config,
            mapping=(cfg.slot, cfg.key_id),
            branch_arities=self.branch_arities, device=self.device,
        )
        self.cx = ContractExtractionCircuits(
            cfg.contract_address, config=self.config, device=self.device
        )
        self.bx = BlockExtractionFramework(
            config=self.config, device=self.device, **fixture_header_offsets(header)
        )
        self.fx = FinalExtractionCircuits(
            self.bx, self.cx, self.vx, config=self.config, device=self.device
        )
        self.vdb = VerifiableDbCircuits(self.config, extraction=self.fx,
                                        device=self.device)
        self.qc = QueryCircuits(
            self.config, self.query_params, ivc_framework=self.vdb.ivc,
            row_tree_depth=self.row_tree_depth,
            index_tree_depth=self.index_tree_depth,
            tabular_rows=self.tabular_rows, device=self.device,
        )
        self._built = True

    # -- per block --------------------------------------------------------
    def _prove_extraction(self, blk: BlockFixture):
        """Map-reduce over the storage trie, the contract's state-trie
        walk, the header circuit, and final_simple."""
        cfg = self.cfg
        paths = {
            k: blk.storage.get_proof(SK.mapping_location(cfg.slot, k))
            for k in sorted(blk.entries)
        }
        values_env, values_pis = self.vx.prove_trie(
            paths, {k: k for k in paths}
        )
        assert values_pis[95] == 0, "values walk must reach the trie root"
        contract_env, _ = self.cx.prove_state_path(
            blk.state.get_proof(cfg.contract_address)
        )
        block_env, _ = self.bx.prove_header(blk.header_rlp)
        return self.fx.prove(block_env, contract_env, values_env)

    def _row_cells(self, blk: BlockFixture, key: bytes, value: int):
        """Non-indexed cells of one row."""
        return [Cell(self.cfg.value_id, value, False)]

    def _row_values(self, blk: BlockFixture, key: bytes, value: int):
        """Materialized query-view row."""
        return [blk.number, int.from_bytes(key, "big"), value]

    def apply_block(self, blk: BlockFixture) -> WrappedEnvelope:
        cfg = self.cfg
        self._ensure_built(blk.header_rlp)

        # 1. extraction
        final_env, final_pis = self._prove_extraction(blk)
        self.proofs[("final_extraction", blk.number)] = final_env

        # 2. rows tree update + one proof per dirtied node
        def tx(t):
            for k, v in blk.entries.items():
                key_int = int.from_bytes(k, "big")
                cells = build_cells_tree(self._row_cells(blk, k, v))
                t.store(
                    (key_int, 0),
                    RowPayload(
                        secondary=Cell(cfg.key_id, key_int, False),
                        row_unique_data=V.row_unique_data_for_mapping_leaf(k),
                        cells=cells,
                    ),
                )
            for key in list(self.rows_db.payloads):
                if not any(
                    int.from_bytes(k, "big") == key[0] for k in blk.entries
                ):
                    t.remove(key)

        row_plan = self.rows_db.in_transaction(tx)
        self._prove_rows_plan(row_plan)
        self.epoch_of[blk.number] = self.rows_db.epoch
        self.rows_root_env[blk.number] = self.rows_node_env[self.rows_db.root()]

        root_pl = self.rows_db.payload(self.rows_db.root())
        rows_digest = D.compute_final_digest(
            self.is_merge, root_pl.individual_vd, root_pl.multiplier_vd,
            root_pl.multiplier_cnt,
        )
        # the block_leaf_bound circuit enforces this equality in-circuit;
        # the host check just fails earlier with a better message
        assert rows_digest == Point.from_fields(final_pis[F_DV]), (
            "extraction values digest != rows tree digest"
        )

        # 3. block tree append; the NEW node carries the extraction binding
        node_payload = BlockPayload(
            index_id=cfg.block_id,
            block_number=blk.number,
            rows_hash=root_pl.hash,
            rows_digest=rows_digest,
        )
        block_plan = self.block_db.in_transaction(
            lambda t: t.store(blk.number, node_payload)
        )
        self._prove_block_plan(block_plan, blk.number, final_env)

        # 4. IVC step
        md = D.block_metadata_hash(
            Point.from_fields(final_pis[F_DM]), cfg.block_id
        )
        root_key = self.block_db.root()
        root_env = self.block_node_env[root_key]
        root_hash = self.block_db.payload(root_key).hash
        pis = C.ivc_pi_values(root_hash, md, blk.number)
        if self.ivc_env is None:
            self.metadata_hash = md
            env = self.vdb.ivc.prove_aggregation(
                "ivc_first", [], (md, blk.number), pis,
                foreign_children=[root_env],
            )
        else:
            assert md == self.metadata_hash, "metadata hash changed"
            env = self.vdb.ivc.prove_aggregation(
                "ivc_subsequent", [self.ivc_env], (blk.number,), pis,
                foreign_children=[root_env],
            )
        self.ivc_env = env
        self.proofs[("ivc", blk.number)] = env
        self.ivc = IvcOutput(
            first_block=self.ivc.first_block if self.ivc else blk.number,
            latest_block=blk.number,
            latest_block_hash=b"",
            block_tree_root=root_hash,
            metadata_hash=md,
        )

        # 5. materialized query view + row bookkeeping
        self.rows_of_block[blk.number] = dict(blk.entries)
        self._fixture_of: Dict[int, BlockFixture] = getattr(
            self, "_fixture_of", {}
        )
        self._fixture_of[blk.number] = blk
        for k, v in blk.entries.items():
            self.table_data.add_row(blk.number, self._row_values(blk, k, v))
        return final_env

    def _prove_rows_plan(self, plan):
        """Reduce phase over the rows tree: children before parents, every
        node verifying its cells chain + child row proofs in-circuit."""
        for key in plan.into_workplan():
            l, r = self.rows_db.tree.children(key)
            payload = self.rows_db.payload(key)
            cells_env = self.vdb.prove_cells_tree(payload.cells)
            pis = C.rows_pi_values(payload)
            children = [
                self.rows_node_env[c] for c in (l, r) if c is not None
            ]
            if not children:
                env = self.vdb.rows.prove_aggregation(
                    "rows_leaf", [],
                    (payload.secondary, payload.row_unique_data), pis,
                    foreign_children=[cells_env],
                )
            elif l is not None and r is not None:
                env = self.vdb.rows.prove_aggregation(
                    "rows_full", children,
                    (payload.secondary, payload.row_unique_data), pis,
                    foreign_children=[cells_env],
                )
            else:
                env = self.vdb.rows.prove_aggregation(
                    "rows_partial", children,
                    (payload.secondary, payload.row_unique_data,
                     l is not None),
                    pis, foreign_children=[cells_env],
                )
            self.rows_node_env[key] = env

    is_merge = False  # merged tables: MergedTableIndexer sets True

    def _prove_block_plan(self, plan, new_block: int, final_env):
        """Block-tree reduce: the new node binds its extraction proof
        (`*_bound`); re-proved ancestors verify their children + their own
        epoch's rows root."""
        for key in plan.into_workplan():
            l, r = self.block_db.tree.children(key)
            payload = self.block_db.payload(key)
            rows_env = self.rows_root_env[key]
            pis = C.block_pi_values(payload)
            bound = key == new_block
            foreign = [rows_env] + ([final_env] if bound else [])
            if l is None and r is None:
                env = self.vdb.block.prove_aggregation(
                    "block_leaf_bound" if bound else "block_leaf", [],
                    (payload.index_id, payload.block_number, self.is_merge),
                    pis, foreign_children=foreign,
                )
            else:
                assert l is not None, "sbbst parents always have a left child"
                lc = self.block_node_env[l]
                rc = self.block_node_env[r] if r is not None else lc
                env = self.vdb.block.prove_aggregation(
                    "block_parent_bound" if bound else "block_parent",
                    [lc, rc],
                    (payload.index_id, payload.block_number, r is not None,
                     self.is_merge),
                    pis, foreign_children=foreign,
                )
            self.block_node_env[key] = env

    # -- query --------------------------------------------------------------
    def run_query(
        self, sql: str, ph: Placeholders
    ) -> Tuple[QueryResult, WrappedEnvelope, List[int]]:
        """Prove the query through the tree-bound stack.  Returns the host
        result, the revelation envelope, and its public-input values."""
        assert self.ivc_env is not None, "no epochs indexed"
        pis = parse_and_assemble(sql, self.cfg.schema())
        res = execute_query(pis, self.table_data, ph)
        bounds = pis.bounds.resolve(ph)
        values = dict(ph.values)
        values.setdefault("$MIN_BLOCK", bounds.min_block)
        values.setdefault("$MAX_BLOCK", bounds.max_block)
        ph = Placeholders(values)

        rows: List[List[int]] = []
        bindings = []
        for bn in sorted(self.rows_of_block):
            if not bounds.min_block <= bn <= bounds.max_block:
                continue
            view = self.rows_db.view_at(self.epoch_of[bn])
            entries = self.rows_of_block[bn]
            for k in sorted(entries, key=lambda kk: int.from_bytes(kk, "big")):
                kv = int.from_bytes(k, "big")
                rows.append(
                    self._row_values(self._fixture_of[bn], k, entries[k])
                )
                bindings.append(
                    make_row_binding(view, (kv, 0), self.block_db, bn)
                )

        if not pis.is_aggregation:
            sel = self._select_tabular(pis, ph, rows, bindings)
            env, reveal = self.qc.prove_query_tabular(
                pis, self.column_ids, [r for r, _ in sel], ph, bounds,
                ivc_env=self.ivc_env, bindings=[bi for _, bi in sel],
            )
            return res, env, reveal

        if rows:
            env, reveal = self.qc.prove_query(
                pis, self.column_ids, rows, ph, bounds,
                ivc_env=self.ivc_env, bindings=bindings,
            )
        else:
            ne = find_node_for_non_existence(
                self.block_db, bounds.min_block, bounds.max_block
            )
            assert ne is not None, "block tree is empty"
            index_w = host_neighbor_path_from_tree(self.block_db, ne.node_key)
            env, reveal = self.qc.prove_query(
                pis, self.column_ids, [], ph, bounds,
                ivc_env=self.ivc_env,
                non_existence_witness=(self.cfg.block_id, index_w),
            )
        return res, env, reveal

    def _select_tabular(self, pis, ph, rows, bindings):
        """Mirror api.execute_query's tabular result shaping (order/
        DISTINCT/OFFSET/LIMIT) while carrying each result's source row +
        Merkle binding, so the revealed circuit rows line up with the host
        answer."""
        from mp2_tpu_torch.vdb.query.ops import eval_predicate, eval_result_row

        cand = []
        for row, bi in zip(rows, bindings):
            ok, _ = eval_predicate(pis.predicate_ops, row, ph)
            if not ok:
                continue
            out, _ = eval_result_row(pis.result, row, ph)
            cand.append((out, row, bi))
        if pis.order_by is not None:
            j, direction = pis.order_by
            cand.sort(key=lambda t: t[0][j], reverse=(direction == "DESC"))
        if pis.result.distinct:
            seen = set()
            uniq = []
            for t in cand:
                k = tuple(t[0])
                if k not in seen:
                    seen.add(k)
                    uniq.append(t)
            cand = sorted(uniq, key=lambda t: tuple(t[0]))
        if pis.offset:
            cand = cand[pis.offset :]
        if pis.limit is not None:
            cand = cand[: pis.limit]
        assert len(cand) <= self.tabular_rows, (
            "result set exceeds the tabular revelation width; add LIMIT"
        )
        return [(row, bi) for _, row, bi in cand]

    def verify(self, env: WrappedEnvelope) -> bool:
        return self.qc.verify(env)


class MergedTableIndexer(CircuitTableIndexer):
    """CircuitTableIndexer for a MERGED table: a mapping table (individual
    rows) joined with a single-slot table whose columns repeat on every row
    as the MULTIPLIER side of the split-digest scheme (merge_circuit.rs +
    block_tree/mod.rs:69-95).

    Extraction proves BOTH storage walks under their own fixed VKs and
    combines them in `final_merge`; every row's cells tree carries the
    multiplier cell, the rows tree enforces all rows agree on it, and
    `block_leaf_bound` pins the merged extraction digest to the rows
    tree's merged final digest with is_merge = 1 in-circuit."""

    is_merge = True

    def __init__(self, cfg, config=None, query_params=None, **kw):
        qp = query_params or UniversalQueryParams(
            num_columns=4, num_placeholders=4, num_predicate_ops=4,
            num_result_ops=2, num_outputs=2,
        )
        super().__init__(cfg, config=config, query_params=qp, **kw)
        self.column_ids = [
            cfg.block_id, cfg.key_id, cfg.value_id, cfg.supply_id
        ]

    def _ensure_built(self, header: bytes):
        if self._built:
            return
        cfg = self.cfg
        self.vx = ValuesExtractionCircuits(
            [cfg.column], cfg.value_id, config=self.config,
            mapping=(cfg.slot, cfg.key_id),
            branch_arities=self.branch_arities, device=self.device,
        )
        self.vx_b = ValuesExtractionCircuits(
            [cfg.single_column], cfg.supply_id, config=self.config,
            branch_arities=self.branch_arities, device=self.device,
        )
        self.cx = ContractExtractionCircuits(
            cfg.contract_address, config=self.config, device=self.device
        )
        self.bx = BlockExtractionFramework(
            config=self.config, device=self.device, **fixture_header_offsets(header)
        )
        self.fx = FinalExtractionCircuits(
            self.bx, self.cx, self.vx, config=self.config,
            merge_with=self.vx_b, device=self.device,
        )
        self.vdb = VerifiableDbCircuits(self.config, extraction=self.fx,
                                        device=self.device)
        self.qc = QueryCircuits(
            self.config, self.query_params, ivc_framework=self.vdb.ivc,
            row_tree_depth=self.row_tree_depth,
            index_tree_depth=self.index_tree_depth,
            tabular_rows=self.tabular_rows, device=self.device,
        )
        self._built = True

    def _prove_extraction(self, blk: BlockFixture):
        from mp2_tpu_torch.extraction.mpt_circuits import host_key_nibbles

        cfg = self.cfg
        assert blk.single_value is not None, (
            "merged-table fixtures need the single multiplier slot"
        )
        paths = {
            k: blk.storage.get_proof(SK.mapping_location(cfg.slot, k))
            for k in sorted(blk.entries)
        }
        a_env, a_pis = self.vx.prove_trie(paths, {k: k for k in paths})
        assert a_pis[95] == 0, "mapping walk must reach the trie root"

        loc = SK.simple_slot_location(cfg.single_slot)
        b_env, b_pis = self.vx_b.prove_trie(
            {loc: blk.storage.get_proof(loc)},
            {loc: host_key_nibbles(loc)},
        )
        assert b_pis[95] == 0, "single-slot walk must reach the trie root"

        contract_env, _ = self.cx.prove_state_path(
            blk.state.get_proof(cfg.contract_address)
        )
        block_env, _ = self.bx.prove_header(blk.header_rlp)
        # table A (mapping) = individual rows; table B (single) = multiplier
        return self.fx.prove_merge(
            block_env, contract_env, a_env, b_env,
            is_table_a_multiplier=False,
        )

    def _row_cells(self, blk: BlockFixture, key: bytes, value: int):
        return [
            Cell(self.cfg.value_id, value, False),
            Cell(self.cfg.supply_id, blk.single_value, True),
        ]

    def _row_values(self, blk: BlockFixture, key: bytes, value: int):
        return [
            blk.number, int.from_bytes(key, "big"), value, blk.single_value
        ]
