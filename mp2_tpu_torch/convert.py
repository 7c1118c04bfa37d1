"""Carry a compiled circuit across from the reference package.

`circuit_data_from_numpy` builds the port's `CircuitData` from the numpy
form of `mp2_tpu`'s compiled `CircuitData`: the fixed columns, the fixed
polynomial data (coefficients, LDE, Merkle levels) and the host-side parts
(gate types, generators, copy-constraint classes, public inputs).  It plays
the role that loading weights plays for a model: both packages then prove
from the same fixed data.  Nothing here imports the reference package; it
reads plain attributes and arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from mp2_tpu_torch.circuit import gates as G
from mp2_tpu_torch.prover.config import CircuitConfig
from mp2_tpu_torch.prover.fri import FriConfig
from mp2_tpu_torch.prover.prove import CircuitData


def _config_from(cfg) -> CircuitConfig:
    """The port's CircuitConfig with the same field values as `cfg`."""
    d = dataclasses.asdict(cfg)
    return CircuitConfig(**{**d, "fri": FriConfig(**d["fri"])})


def _gate_from(gate) -> G.Gate:
    """The port's gate of the same class and parameters."""
    cls = getattr(G, type(gate).__name__)
    out = cls.__new__(cls)
    out.__dict__.update(vars(gate))
    return out


def circuit_data_from_numpy(
    config,
    n: int,
    gate_types: Sequence,
    selector_values: np.ndarray,
    constants_values: np.ndarray,
    sigma_values: np.ndarray,
    k_coeffs: Sequence[int],
    fixed_coeffs: np.ndarray,
    fixed_lde: np.ndarray,
    fixed_levels: Sequence[np.ndarray],
    rows_meta: List,
    dsu_parent,
    generators: List,
    public_inputs: List,
    device,
) -> CircuitData:
    """The port's CircuitData on `device` from the reference's arrays
    (all field arrays as canonical uint64): fixed_coeffs (F, n),
    fixed_lde (F, big), fixed_levels the fixed tree's digest levels from
    the leaf digests to the cap.  The circuit digest is recomputed from the
    cap, so a caller can hold it against the reference's."""
    cfg = _config_from(config)
    device = torch.device(device)
    data = CircuitData(
        config=cfg,
        n=n,
        log_n=n.bit_length() - 1,
        gate_types=[(name, _gate_from(g)) for name, g in gate_types],
        selector_values=np.asarray(selector_values, dtype=np.uint64),
        constants_values=np.asarray(constants_values, dtype=np.uint64),
        sigma_values=np.asarray(sigma_values, dtype=np.uint64),
        k_coeffs=[int(k) for k in k_coeffs],
        rows_meta=rows_meta,
        dsu_parent=dsu_parent,
        generators=generators,
        public_inputs=public_inputs,
        device=device,
    )
    data.set_fixed(fixed_coeffs, fixed_lde, fixed_levels)
    return data
