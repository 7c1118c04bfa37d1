"""In-circuit duplex challenger: the Fiat-Shamir transcript as a gadget.

Call-for-call identical bookkeeping to `mp2_tpu.hash.challenger`
(overwrite-mode duplex sponge, output buffer popped from the END), so the
recursive verifier replays exactly the transcript the prover and the host
verifier walk.  Every `observe` is free (buffering); each duplex costs one
single-row Poseidon2 gate.

A jax-free copy of `mp2_tpu/circuit/gadgets/transcript.py`: only the
imports change.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from mp2_tpu_torch.circuit.builder import CircuitBuilder, Target
from mp2_tpu_torch.hash.constants import RATE, WIDTH

ExtTarget = Tuple[Target, Target]


class CircuitChallenger:
    def __init__(self, b: CircuitBuilder):
        self.b = b
        self._state: List[Target] = [b.zero()] * WIDTH
        self._input_buffer: List[Target] = []
        self._output_buffer: List[Target] = []

    def observe(self, x) -> None:
        """Observe a single target or a sequence of targets."""
        if isinstance(x, (list, tuple)) and not self._is_target(x):
            for v in x:
                self.observe(v)
            return
        self._output_buffer = []
        self._input_buffer.append(x)
        if len(self._input_buffer) == RATE:
            self._duplex()

    @staticmethod
    def _is_target(x) -> bool:
        return (
            isinstance(x, tuple)
            and len(x) == 2
            and all(isinstance(v, int) for v in x)
        )

    def observe_ext(self, x: ExtTarget) -> None:
        self.observe(x[0])
        self.observe(x[1])

    def _duplex(self) -> None:
        for j, x in enumerate(self._input_buffer):
            self._state[j] = x
        self._state = self.b.poseidon2_permute(self._state)
        self._input_buffer = []
        self._output_buffer = list(self._state[:RATE])

    def get_challenge(self) -> Target:
        if self._input_buffer or not self._output_buffer:
            self._duplex()
        return self._output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[Target]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> ExtTarget:
        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return (c0, c1)
