"""Duplex challenger: the Fiat-Shamir transcript of the proving system.

plonky2's `Challenger` semantics: overwrite-mode duplex sponge, output
buffer popped from the end.  Two variants, as in `mp2_tpu/hash/challenger.py`:
  Challenger     - batched, one independent transcript per element of
                   `batch`, state kept as a planar (12, *batch) tensor
  HostChallenger - python-int golden model (verification)
"""

from __future__ import annotations

from typing import List

import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.ext2 import GF2
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash import poseidon2 as p2
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.hash.constants import RATE, WIDTH


class Challenger:
    """Batched duplex challenger over field scalars of shape `batch`."""

    def __init__(self, batch, device):
        self.batch = tuple(batch)
        self.state = gl.zeros((WIDTH,) + self.batch, device)
        self.input_buffer: List[torch.Tensor] = []
        self._output_buffer: List[torch.Tensor] = []

    def observe(self, x: torch.Tensor):
        """Observe one element (shape == batch) or a vector (*batch, n)."""
        if tuple(x.shape) == self.batch:
            self._output_buffer = []
            self.input_buffer.append(x)
            if len(self.input_buffer) == RATE:
                self._duplex()
        else:
            if tuple(x.shape[: len(self.batch)]) != self.batch:
                raise ValueError(f"cannot observe shape {tuple(x.shape)} in batch {self.batch}")
            for i in range(x.shape[-1]):
                self.observe(x[..., i])

    def _duplex(self):
        k = len(self.input_buffer)
        st = self.state
        if k:
            st = torch.cat([torch.stack(self.input_buffer), st[k:]])
        self.state = p2.permute_lanes(st)
        self.input_buffer = []
        self._output_buffer = list(self.state[:RATE])

    def get_challenge(self) -> torch.Tensor:
        if self.input_buffer or not self._output_buffer:
            self._duplex()
        return self._output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[torch.Tensor]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> GF2:
        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return GF2(c0, c1)


class HostChallenger:
    """Python-int golden model with identical semantics."""

    def __init__(self):
        self._state = [0] * WIDTH
        self._input_buffer: List[int] = []
        self._output_buffer: List[int] = []

    def observe(self, x):
        if isinstance(x, (list, tuple)):
            for v in x:
                self.observe(v)
            return
        self._output_buffer = []
        self._input_buffer.append(x % P)
        if len(self._input_buffer) == RATE:
            self._duplex()

    def _duplex(self):
        for j, x in enumerate(self._input_buffer):
            self._state[j] = x
        self._state = p2h.permute(self._state)
        self._input_buffer = []
        self._output_buffer = list(self._state[:RATE])

    def get_challenge(self) -> int:
        if self._input_buffer or not self._output_buffer:
            self._duplex()
        return self._output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self):
        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return (c0, c1)
