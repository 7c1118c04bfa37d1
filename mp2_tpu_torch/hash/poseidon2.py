"""Poseidon2 permutation and sponge over torch tensors.

Every permutation goes through K1 (`ops/poseidon2_cuda.permute_planar`):
the CUDA kernel for a CUDA tensor, its plain torch twin for a CPU tensor.
Unlike `mp2_tpu/hash/poseidon2.py` there is no 1024-lane gate: in eager
PyTorch the plain version costs thousands of launches per permutation, so
on the card the kernel is the faster path at every batch size.

Port of `mp2_tpu/hash/poseidon2.py`; bit-identical to the host model
`hash/poseidon2_host.py`.
"""

from __future__ import annotations

import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.hash.constants import RATE, WIDTH
from mp2_tpu_torch.ops.poseidon2_cuda import permute_planar


def permute_lanes(lanes: torch.Tensor, permute=None) -> torch.Tensor:
    """Permutation on a planar state of shape (12, ...): lane i is
    lanes[i].  The prover's entry (sponge lanes, challenger, grinding).
    `permute` replaces K1's entry (a plain twin passes its own)."""
    flat = lanes.reshape(WIDTH, -1).contiguous()
    return (permute or permute_planar)(flat).reshape(lanes.shape)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Permutation on a stacked state of shape (..., 12)."""
    planar = state.reshape(-1, WIDTH).T.contiguous()
    return permute_planar(planar).T.reshape(state.shape)


def hash_n_to_m_no_pad(inputs: torch.Tensor, num_outputs: int,
                       permute=None) -> torch.Tensor:
    """Sponge over (..., n) -> (..., num_outputs): overwrite-mode absorption
    in chunks of RATE, no padding (plonky2 semantics, as the host model)."""
    n = inputs.shape[-1]
    state = gl.zeros((WIDTH,) + tuple(inputs.shape[:-1]), inputs.device)
    for i in range(0, n, RATE):
        k = min(RATE, n - i)
        chunk = torch.movedim(inputs[..., i : i + k], -1, 0)
        state = permute_lanes(torch.cat([chunk, state[k:]]), permute)
    outputs = []
    while True:
        for j in range(RATE):
            outputs.append(state[j])
            if len(outputs) == num_outputs:
                return torch.stack(outputs, dim=-1)
        state = permute_lanes(state, permute)


def hash_no_pad(inputs: torch.Tensor, permute=None) -> torch.Tensor:
    return hash_n_to_m_no_pad(inputs, 4, permute)


def hash_or_noop(inputs: torch.Tensor, permute=None) -> torch.Tensor:
    """plonky2 semantics: <= 4 inputs are returned zero-padded (no hashing)."""
    n = inputs.shape[-1]
    if n <= 4:
        pad = gl.zeros(tuple(inputs.shape[:-1]) + (4 - n,), inputs.device)
        return torch.cat([inputs, pad], dim=-1)
    return hash_no_pad(inputs, permute)


def two_to_one(left: torch.Tensor, right: torch.Tensor, permute=None) -> torch.Tensor:
    """(..., 4) x (..., 4) -> (..., 4)."""
    return hash_no_pad(torch.cat([left, right], dim=-1), permute)
