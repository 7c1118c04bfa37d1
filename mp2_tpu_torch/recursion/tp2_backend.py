"""The verifiable-DB tree circuits that the map phase proves.

Port of the circuit builders of `mp2_tpu/recursion/tp2_backend.py`; the
`TP2Backend` class is not ported yet.  Each circuit proves the Poseidon2
node hash of one tree node in-circuit, with the node's fields exposed as
public inputs:
  cells_node:  PIs = h(4) || id || value(8) || lh(4) || rh(4)
               h == H(lh || rh || id || value)
  tree_node:   PIs = h(4) || id || value(8) || min(8) || max(8)
                     || lh(4) || rh(4) || inner(4)
               h == H(lh || rh || min || max || id || value || inner)
               (shared by rows-tree and block-tree nodes)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mp2_tpu_torch.circuit.builder import CircuitBuilder
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.prover.config import CircuitConfig


def _build_cells_node(cfg: CircuitConfig, device):
    b = CircuitBuilder(cfg)
    lh = b.add_inputs(4)
    rh = b.add_inputs(4)
    ident = b.add_input()
    value = b.add_inputs(8)
    h = b.hash_no_pad(lh + rh + [ident] + value)
    b.register_public_inputs(h + [ident] + value + lh + rh)
    inputs = lh + rh + [ident] + value
    return b.build(device), inputs


def _build_tree_node(cfg: CircuitConfig, device):
    b = CircuitBuilder(cfg)
    lh = b.add_inputs(4)
    rh = b.add_inputs(4)
    mn = b.add_inputs(8)
    mx = b.add_inputs(8)
    ident = b.add_input()
    value = b.add_inputs(8)
    inner = b.add_inputs(4)
    h = b.hash_no_pad(lh + rh + mn + mx + [ident] + value + inner)
    b.register_public_inputs(h + [ident] + value + mn + mx + lh + rh + inner)
    inputs = lh + rh + mn + mx + [ident] + value + inner
    return b.build(device), inputs


def tree_node_batch(data, input_targets, batch: int,
                    seed: int = 0) -> Tuple[np.ndarray, List[List[int]]]:
    """`batch` random tree-node witnesses and their public inputs, made
    exactly as the reference's bench makes them (numpy default_rng(seed),
    37 node fields below 2^31 per proof).  Returns ((B, n, W) uint64,
    B public-input lists)."""
    rng = np.random.default_rng(seed)
    wits, pis_list = [], []
    for _ in range(batch):
        vals = [int(v) for v in rng.integers(0, 2**31, 37)]
        h = p2h.hash_no_pad(vals)
        lh, rh = vals[0:4], vals[4:8]
        mn, mx = vals[8:16], vals[16:24]
        ident, value, inner = vals[24], vals[25:33], vals[33:37]
        pis_list.append(list(h) + [ident] + value + mn + mx + lh + rh + inner)
        wits.append(data.generate_witness(dict(zip(input_targets, vals))))
    return np.stack(wits), pis_list
