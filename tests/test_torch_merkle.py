"""K1's Merkle entries' plain twins and the port's trees against mp2_tpu on
the CPU.

`ops/poseidon2_cuda.hash_leaves_plain` (leaf digests of a natural-order LDE
in bit-reversed leaf order) and `merkle_levels_plain` (every level up to
the cap) are held against the reference's `BatchedMerkleTree` over
`_leaves_batched` (mp2_tpu/prover/batch.py) and its `MerkleTree`
(mp2_tpu/prover/merkle.py): every digest level, the cap, and the leaves
the port's trees open at query indices.  Leaf widths 3 and 4 take
hash_or_noop's zero-padded copy, wider ones the sponge.  Inputs come from
numpy with a seed; every comparison is exact.  The CUDA kernels run only
on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from mp2_tpu.field import goldilocks as jgl
from mp2_tpu.prover.batch import BatchedMerkleTree as JBatchedMerkleTree
from mp2_tpu.prover.batch import _leaves_batched as j_leaves_batched
from mp2_tpu.prover.merkle import MerkleTree as JMerkleTree
from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.ops import poseidon2_cuda as K
from mp2_tpu_torch.prover.merkle import BatchedMerkleTree, MerkleTree

P = gl.P

# (leaf width, log2 leaf count, cap height): widths 3, 4, 8, 12, 135, 136,
# leaf counts 2^3 to 2^8, cap heights 0 to 4.  The reference compiles its
# hashing per shape (~1 s a level size on a CPU), so the cases share level
# sizes: after the first, each adds at most one.
CASES = [(136, 8, 4), (135, 4, 3), (12, 5, 2), (8, 6, 1), (4, 3, 0), (3, 7, 2)]


def _rand(seed, shape):
    x = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    x.reshape(-1)[:4] = [0, P - 1, 1 << 32, (1 << 32) - 1]
    return x


def _bitrev(log_m):
    return np.array([int(format(i, f"0{log_m}b")[::-1], 2) if log_m else 0
                     for i in range(1 << log_m)])


@pytest.mark.parametrize("width, log_m, cap", CASES)
def test_plain_twins_match_reference_batched_tree(width, log_m, cap):
    """The port's tree over a natural-order LDE, whose levels on a CPU tensor
    are hash_leaves_plain and merkle_levels_plain, against the reference's
    tree over the bit-reversed leaves: every level, and the leaves the
    port opens at query positions."""
    lde = _rand(100 * width + log_m, (2, width, 1 << log_m))
    ref = JBatchedMerkleTree(j_leaves_batched(jgl.from_u64(lde)), cap_height=cap)
    tree = BatchedMerkleTree.from_lde(gl.from_u64(lde, "cpu"), cap_height=cap)
    assert len(tree.digest_levels) == len(ref.digest_levels) == log_m - cap + 1
    for got, want in zip(tree.digest_levels, ref.digest_levels):
        np.testing.assert_array_equal(gl.to_u64(got), jgl.to_u64(want))
    idx = np.random.default_rng(log_m).integers(0, 1 << log_m, size=(2, 5))
    ref_leaves = jgl.to_u64(ref.leaves)
    np.testing.assert_array_equal(
        gl.to_u64(tree.rows(torch.from_numpy(idx))),
        np.stack([ref_leaves[b, idx[b]] for b in range(2)]))
    every = torch.arange(1 << log_m).expand(2, -1)
    np.testing.assert_array_equal(gl.to_u64(tree.rows(every)), ref_leaves)


@pytest.mark.parametrize("width, log_m, cap", [(12, 3, 1)])
def test_fixed_tree_matches_reference_merkle_tree(width, log_m, cap):
    """The unbatched tree over a (C, m) LDE, as the fixed columns' tree."""
    lde = _rand(7 + width, (width, 1 << log_m))
    leaves = lde[:, _bitrev(log_m)].T  # the reference's fixed-tree leaves
    ref = JMerkleTree(jgl.from_u64(leaves), cap_height=cap)
    tree = MerkleTree.from_lde(gl.from_u64(lde, "cpu"), cap_height=cap)
    for got, want in zip(tree.digest_levels, ref.digest_levels, strict=True):
        np.testing.assert_array_equal(gl.to_u64(got), jgl.to_u64(want))
    idx = torch.tensor([[0, 3, (1 << log_m) - 1], [5, 5, 1]])
    np.testing.assert_array_equal(gl.to_u64(tree.rows(idx)), leaves[idx.numpy()])
    again = MerkleTree.from_levels(gl.from_u64(lde, "cpu"), tree.digest_levels, cap)
    assert torch.equal(again.rows(idx), tree.rows(idx))
    assert torch.equal(again.cap, tree.cap)


def test_wrappers_take_the_plain_path_on_the_cpu():
    lde = gl.from_u64(_rand(3, (1, 9, 16)), "cpu")
    before = K.launches()
    digests = K.hash_leaves(lde)
    levels = K.merkle_levels(digests, 1)
    assert K.launches() == before
    # the plain twin is the prover's old composition: bit-reverse, transpose,
    # sponge each leaf
    cols = gl.to_u64(lde[0])[:, _bitrev(4)]
    want = np.array([p2h.hash_or_noop([int(x) for x in cols[:, i]]) for i in range(16)],
                    dtype=np.uint64)
    np.testing.assert_array_equal(gl.to_u64(digests[0]), want)
    assert torch.equal(digests, K.hash_leaves_plain(lde))
    assert all(torch.equal(a, b) for a, b in
               zip(levels, K.merkle_levels_plain(digests, 1), strict=True))
    assert K.merkle_levels(digests[:, :2], 1) == []  # already the cap


@pytest.mark.parametrize("call", [
    lambda: K.hash_leaves(torch.zeros((2, 3, 12), dtype=torch.int64)),  # m not 2^k
    lambda: K.hash_leaves(torch.zeros((2, 0, 8), dtype=torch.int64)),  # no columns
    lambda: K.hash_leaves(torch.zeros((3, 8), dtype=torch.int64)),  # not (B, C, m)
    lambda: K.merkle_levels(torch.zeros((2, 8, 3), dtype=torch.int64), 0),  # not 4 wide
    lambda: K.merkle_levels(torch.zeros((2, 8, 4), dtype=torch.int64), 4),  # cap > m
    lambda: K.merkle_levels(torch.zeros((2, 8, 4), dtype=torch.int32), 0),
])
def test_wrappers_refuse_shapes_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_wrappers_refuse_devices_without_the_kernel():
    with pytest.raises(ValueError, match="no Poseidon2 kernel"):
        K.hash_leaves(torch.zeros((1, 9, 8), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="no Poseidon2 kernel"):
        K.merkle_levels(torch.zeros((1, 8, 4), dtype=torch.int64, device="meta"), 0)
