"""Circuit/prover configuration (the TP2 protocol parameters).

A copy of `mp2_tpu/prover/config.py`: production defaults (quotient degree
factor 8, 2 soundness repetitions, rate 1/8, cap 4, 28 queries, 16 PoW
bits) and the lighter `test_config`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from mp2_tpu_torch.prover.fri import FriConfig


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 136         # all routed; >= 130 fits the single-row
                                 # Poseidon2 gate, 17 x chunk_size 8
    num_constants: int = 13      # constant columns (per-round poseidon
                                 # fallback gates use 12+1)
    num_challenges: int = 2      # permutation/constraint soundness repetitions
    quotient_degree_factor: int = 8
    permutation_chunk_size: int = 8
    fri: FriConfig = field(default_factory=FriConfig)
    fri_final_poly_bits: int = 2

    @property
    def num_partial_products(self) -> int:
        # chunks of the 'num_wires'-term permutation product
        n_chunks = -(-self.num_wires // self.permutation_chunk_size)
        return n_chunks - 1

    @property
    def zs_partials_cols(self) -> int:
        return self.num_challenges * (1 + self.num_partial_products)

    @property
    def quotient_cols(self) -> int:
        return self.num_challenges * self.quotient_degree_factor


# test-friendly default: fewer queries / lighter grinding, same structure
def test_config(**overrides) -> CircuitConfig:
    defaults = dict(
        num_challenges=2,
        fri=FriConfig(
            rate_bits=3, cap_height=1, proof_of_work_bits=4, num_query_rounds=12
        ),
        fri_final_poly_bits=2,
    )
    defaults.update(overrides)
    return CircuitConfig(**defaults)


test_config.__test__ = False  # not a pytest case despite the name
