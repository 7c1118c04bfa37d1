"""Merkle-cap commitments over Poseidon2 (the prover's vector commitment).

Port of `mp2_tpu/prover/merkle.py` (`MerkleTree`, `verify_merkle_proof`)
and `mp2_tpu/prover/batch.py::BatchedMerkleTree`.  Leaves are sponge-hashed
(or zero-padded when at most 4 wide), then hashed pairwise up to a cap of
2^cap_height digests: one `two_to_one` over a whole level per step.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from mp2_tpu_torch.hash import poseidon2 as p2
from mp2_tpu_torch.hash import poseidon2_host as p2h


class MerkleTree:
    """leaves (n, w), n a power of two; digest_levels[0] (n, 4) leaf
    digests, the last level the (2^cap_height, 4) cap."""

    def __init__(self, leaves: torch.Tensor, cap_height: int = 0):
        n = leaves.shape[0]
        assert n & (n - 1) == 0 and n > 0, "leaf count must be a power of two"
        assert (1 << cap_height) <= n
        self.cap_height = cap_height
        self.leaves = leaves
        digests = p2.hash_or_noop(leaves)
        self.digest_levels: List[torch.Tensor] = [digests]
        while digests.shape[0] > (1 << cap_height):
            digests = p2.two_to_one(digests[0::2], digests[1::2])
            self.digest_levels.append(digests)

    @classmethod
    def from_levels(cls, leaves: torch.Tensor, digest_levels: List[torch.Tensor],
                    cap_height: int) -> "MerkleTree":
        """A tree from precomputed digest levels (no hashing)."""
        t = cls.__new__(cls)
        t.cap_height = cap_height
        t.leaves = leaves
        t.digest_levels = list(digest_levels)
        return t

    @property
    def cap(self) -> torch.Tensor:
        return self.digest_levels[-1]


class BatchedMerkleTree:
    """Merkle-cap trees over a batch: leaves (B, m, w) -> cap (B, 2^ch, 4)."""

    def __init__(self, leaves: torch.Tensor, cap_height: int = 0):
        m = leaves.shape[1]
        assert m & (m - 1) == 0
        self.cap_height = cap_height
        self.leaves = leaves
        digests = p2.hash_or_noop(leaves)  # (B, m, 4)
        self.digest_levels: List[torch.Tensor] = [digests]
        while digests.shape[1] > (1 << cap_height):
            digests = p2.two_to_one(digests[:, 0::2], digests[:, 1::2])
            self.digest_levels.append(digests)

    @property
    def cap(self) -> torch.Tensor:
        return self.digest_levels[-1]


def verify_merkle_proof(
    leaf: Sequence[int],
    index: int,
    siblings: Sequence[Sequence[int]],
    cap: Sequence[Tuple[int, int, int, int]],
    depth: int = None,
) -> bool:
    """Host verification of an opened leaf against a cap.

    `depth` (when given) pins the expected sibling count: since hash_or_noop
    is the identity on <=4-wide leaves, an unchecked short path would let a
    leaf equal to a cap row verify with zero siblings.
    """
    if depth is not None and len(siblings) != depth:
        return False
    if (index >> len(siblings)) >= len(cap):
        return False
    digest = p2h.hash_or_noop([int(x) for x in leaf])
    idx = index
    for sib in siblings:
        sib = tuple(int(x) for x in sib)
        if idx & 1:
            digest = p2h.two_to_one(sib, digest)
        else:
            digest = p2h.two_to_one(digest, sib)
        idx >>= 1
    return tuple(digest) == tuple(cap[idx])
