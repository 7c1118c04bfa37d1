"""Merkle-cap commitments over Poseidon2 (the prover's vector commitment).

Port of `mp2_tpu/prover/merkle.py` (`MerkleTree`, `verify_merkle_proof`)
and `mp2_tpu/prover/batch.py::BatchedMerkleTree`.  Leaves are sponge-hashed
(or zero-padded when at most 4 wide), then hashed pairwise up to a cap of
2^cap_height digests.

A tree over an LDE (`from_lde`) takes the natural-order evaluations as they
come from the transform: K1's leaf entry (`ops/poseidon2_cuda.hash_leaves`)
hashes each point's column into the bit-reversed leaf order in one launch,
and the tree opens a leaf by gathering that point's column, so neither the
bit-reversed copy nor the transposed leaves are ever made.  A tree over
explicit leaves (the FRI fold trees, whose leaves are 4 wide) digests them
with hash_or_noop.  Both build their levels with K1's level entry
(`merkle_levels`: two launches where the reference makes one per level).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from mp2_tpu_torch.hash import poseidon2 as p2
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.ops import poseidon2_cuda as k1
from mp2_tpu_torch.ops.ntt_cuda import _bitrev_t


def _open(leaves, lde_nat, idx: torch.Tensor) -> torch.Tensor:
    """Leaves at tree positions idx (B, q) -> (B, q, w), from the (B, m, w)
    leaves or, where there are none, from the (B, C, m) natural-order LDE
    at the bit-reversed points."""
    B, q = idx.shape
    if leaves is not None:
        return torch.gather(leaves, 1, idx[..., None].expand(B, q, leaves.shape[2]))
    pts = _bitrev_t(lde_nat.shape[-1].bit_length() - 1, idx.device)[idx]
    C = lde_nat.shape[1]
    return torch.gather(lde_nat, 2, pts[:, None, :].expand(B, C, q)).transpose(1, 2)


class BatchedMerkleTree:
    """Merkle-cap trees over a batch: leaves (B, m, w) -> cap (B, 2^ch, 4);
    digest_levels[0] the (B, m, 4) leaf digests, the last the cap."""

    def __init__(self, leaves: torch.Tensor, cap_height: int = 0):
        m = leaves.shape[1]
        assert m & (m - 1) == 0 and m > 0, "leaf count must be a power of two"
        self._init(leaves, None, p2.hash_or_noop(leaves).contiguous(), cap_height)

    @classmethod
    def from_lde(cls, lde_nat: torch.Tensor, cap_height: int = 0) -> "BatchedMerkleTree":
        """The tree whose leaf i is column rev(i) of a natural-order (B, C, m)
        LDE: the prover's commitment to C polynomials."""
        t = cls.__new__(cls)
        t._init(None, lde_nat, k1.hash_leaves(lde_nat), cap_height)
        return t

    def _init(self, leaves, lde_nat, digests, cap_height):
        self.cap_height = cap_height
        self._leaves = leaves
        self._lde = lde_nat
        self.digest_levels: List[torch.Tensor] = [
            digests, *k1.merkle_levels(digests, cap_height)]

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Leaves at tree positions idx (B, q) -> (B, q, w)."""
        return _open(self._leaves, self._lde, idx)

    @property
    def cap(self) -> torch.Tensor:
        return self.digest_levels[-1]


class MerkleTree:
    """leaves (n, w), n a power of two; digest_levels[0] (n, 4) leaf
    digests, the last level the (2^cap_height, 4) cap.  One tree, built as
    a batch of one."""

    def __init__(self, leaves: torch.Tensor, cap_height: int = 0):
        n = leaves.shape[0]
        assert n & (n - 1) == 0 and n > 0, "leaf count must be a power of two"
        assert (1 << cap_height) <= n
        self._set(BatchedMerkleTree(leaves[None], cap_height), cap_height)

    @classmethod
    def from_lde(cls, lde_nat: torch.Tensor, cap_height: int = 0) -> "MerkleTree":
        """The tree whose leaf i is column rev(i) of a natural-order (C, m) LDE."""
        t = cls.__new__(cls)
        t._set(BatchedMerkleTree.from_lde(lde_nat[None], cap_height), cap_height)
        return t

    @classmethod
    def from_levels(cls, lde_nat: torch.Tensor, digest_levels: List[torch.Tensor],
                    cap_height: int) -> "MerkleTree":
        """The tree of a natural-order (C, m) LDE from precomputed digest
        levels (no hashing)."""
        t = cls.__new__(cls)
        b = BatchedMerkleTree.__new__(BatchedMerkleTree)
        b.cap_height, b._leaves, b._lde = cap_height, None, lde_nat[None]
        b.digest_levels = [l[None] for l in digest_levels]
        t._set(b, cap_height)
        return t

    def _set(self, batched: BatchedMerkleTree, cap_height: int):
        self.cap_height = cap_height
        self._batched = batched
        self.digest_levels: List[torch.Tensor] = [l[0] for l in batched.digest_levels]

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Leaves at tree positions idx (B, q), the same tree for every batch
        element -> (B, q, w)."""
        b, B = self._batched, idx.shape[0]
        return _open(None if b._leaves is None else b._leaves.expand(B, -1, -1),
                     None if b._lde is None else b._lde.expand(B, -1, -1), idx)

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
