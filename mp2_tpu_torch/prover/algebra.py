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
        """out[i, ...] = sum_j A[i][j] * v[j, ...] for an int matrix A."""
        m, k = len(A), len(A[0])
        a = gl.from_u64(np.array(A, dtype=np.uint64), self.device)
        a = a.reshape((m, k) + (1,) * (v.dim() - 1))
        return gl.sum_axis(gl.mul(a, v[None]), axis=1)

    def add_col_const(self, v, col):
        """v (k, ...) + per-lane constants col (k,)."""
        c = gl.from_u64(np.array(col, dtype=np.uint64), self.device)
        return gl.add(v, c.reshape((len(col),) + (1,) * (v.dim() - 1)))
