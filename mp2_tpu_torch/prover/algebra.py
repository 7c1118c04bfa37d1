"""Algebra abstraction: gate constraints are written once and evaluated on
device tensors over the LDE domain (quotient) and on host GF(p^2) values
(verification at zeta).  Port of `mp2_tpu/prover/algebra.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from mp2_tpu_torch.field import ext2
from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.goldilocks import P

_PRODUCT_ELEMS = 1 << 24  # elements of one block of a constant-matrix product


class HostExtAlgebra:
    """Values are (c0, c1) python-int pairs in GF(p^2)."""

    zero = (0, 0)
    one = (1, 0)

    @staticmethod
    def constant(c: int):
        return (c % P, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        return ext2.host_mul(a, b)

    @staticmethod
    def mul_const(a, c: int):
        return (a[0] * c % P, a[1] * c % P)

    @staticmethod
    def add_const(a, c: int):
        return ((a[0] + c) % P, a[1])

    @classmethod
    def exp7(cls, a):
        a2 = cls.mul(a, a)
        a3 = cls.mul(a2, a)
        a4 = cls.mul(a2, a2)
        return cls.mul(a4, a3)


class TorchAlgebra:
    """Values are base-field tensors broadcast over `shape` on `device`
    (the `DeviceAlgebra` interface).  `vectorized = True` selects the gates'
    stacked-lane paths: structurally identical constraints evaluate as one
    (lanes, ...) tensor and constant-matrix products, which in eager torch
    also means far fewer launches."""

    vectorized = True

    def __init__(self, shape, device):
        self.shape = tuple(shape)
        self.device = device
        self.zero = gl.zeros(self.shape, device)
        self.one = gl.ones(self.shape, device)

    def constant(self, c: int):
        return gl.full(self.shape, c, self.device)

    @staticmethod
    def add(a, b):
        return gl.add(a, b)

    @staticmethod
    def sub(a, b):
        return gl.sub(a, b)

    @staticmethod
    def mul(a, b):
        return gl.mul(a, b)

    @staticmethod
    def mul_const(a, c: int):
        return gl.mul_const(a, c)

    @staticmethod
    def add_const(a, c: int):
        return gl.add_const(a, c)

    @staticmethod
    def exp7(a):
        return gl.exp7(a)

    # -- stacked-lane helpers (vectorized gate paths) -----------------------
    @staticmethod
    def stack(items):
        return torch.stack(list(items), dim=0)

    @staticmethod
    def unstack(v):
        return [v[i] for i in range(v.shape[0])]

    def matmul_const(self, A, v):
        """out[i, ...] = sum_j A[i][j] * v[j, ...] for an int matrix A.

        A (nearly) dense A, such as the Poseidon2 matrices, is broadcast
        against v in one product.  Where no row has more than half its
        entries nonzero (the block-diagonal weights of a bit decomposition,
        ops x ops*bits), each row multiplies only the rows of v under its
        nonzero entries, gathered: the (m, k, ...) product of the dense form
        grows with ops^2 and, at a chunk of the quotient of a 2^14-row
        verifiable-DB member, would need 18 GiB."""
        A = np.array(A, dtype=np.uint64)
        m, k = A.shape
        tail = (1,) * (v.dim() - 1)
        nonzero = [np.flatnonzero(row) for row in A]
        kk = max(1, max(len(j) for j in nonzero))
        if 2 * kk > k:
            a = gl.from_u64(A, self.device).reshape((m, k) + tail)
            return self._row_blocks(m, k * v[0].numel(),
                                    lambda r: gl.sum_axis(gl.mul(a[r], v[None]), axis=1))
        idx = np.zeros((m, kk), dtype=np.int64)
        coef = np.zeros((m, kk), dtype=np.uint64)  # zero coefficients pad short rows
        for i, j in enumerate(nonzero):
            idx[i, : len(j)] = j
            coef[i, : len(j)] = A[i, j]
        idx_t = torch.from_numpy(idx).to(v.device)
        c = gl.from_u64(coef, self.device).reshape((m, kk) + tail)
        return self._row_blocks(m, kk * v[0].numel(),
                                lambda r: gl.sum_axis(gl.mul(c[r], v[idx_t[r]]), axis=1))

    @staticmethod
    def _row_blocks(m, row_elems, rows_of):
        """rows_of(slice) over the m output rows, in blocks whose products
        hold about _PRODUCT_ELEMS elements: a dense 22 x 34 product over a
        quotient chunk of 2^19 points would hold 3 GiB in each of a field
        multiply's temporaries."""
        step = max(1, _PRODUCT_ELEMS // row_elems)
        if step >= m:
            return rows_of(slice(0, m))
        return torch.cat([rows_of(slice(r, min(m, r + step))) for r in range(0, m, step)])

    def add_col_const(self, v, col):
        """v (k, ...) + per-lane constants col (k,)."""
        c = gl.from_u64(np.array(col, dtype=np.uint64), self.device)
        return gl.add(v, c.reshape((len(col),) + (1,) * (v.dim() - 1)))
