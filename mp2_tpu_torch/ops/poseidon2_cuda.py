"""K1: the batched Poseidon2 permutation, as a CUDA kernel and its plain twin.

Replaces `mp2_tpu/ops/poseidon2_pallas.py::_kernel` (the Pallas TPU kernel).
The kernel source is `csrc/poseidon2.cu` on `csrc/goldilocks.cuh`; its header
comment says what bounds it on Hopper and how the design answers that.

`permute_planar` is the one entry: a (12, n) int64 planar state in, the
permuted state out.  On a CPU tensor it runs `permute_planar_plain`, the
same permutation written with the port's torch field ops.  On a CUDA tensor
it launches the kernel or raises; it never falls back to the plain version.
`permute_planar.launches` counts kernel launches.

Build: at first use, `ops/_nvcc.build_library` compiles the kernel for
sm_90a into a shared library with a plain C entry under
`mp2_tpu_torch/_build/mp2_poseidon2-<hash>/`, keyed by a hash of the
sources, the generated round-constant header and the flags, and loads it
with ctypes.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.hash.constants import ROUNDS_F, ROUNDS_P, WIDTH, load_table
from mp2_tpu_torch.ops._nvcc import Built, build_library

_SOURCES = ("poseidon2.cu", "goldilocks.cuh")


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _tables_header() -> str:
    ext, intr, diag = load_table()

    def arr(vals):
        return "{" + ", ".join(f"{int(v)}ull" for v in vals) + "}"

    diag_m1 = [(d - 1) % gl.P for d in diag]
    return (
        "// Generated from mp2_tpu_torch/hash/constants.py; do not edit.\n"
        "#pragma once\n"
        f"#define P2_EXT_RC {{{', '.join(arr(row) for row in ext)}}}\n"
        f"#define P2_INT_RC {arr(intr)}\n"
        f"#define P2_DIAG_M1 {arr(diag_m1)}\n"
    )


@functools.lru_cache(maxsize=None)
def build() -> Built:
    """Compile (once per source hash) and load the kernel library."""
    built = build_library("mp2_poseidon2", _SOURCES,
                          header=("poseidon2_tables.h", _tables_header()))
    fn = built.lib.mp2_poseidon2_permute_planar
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


# ---------------------------------------------------------------------------
# plain version (torch field ops)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _plain_tables(device):
    ext, intr, diag = load_table()
    ext_t = gl.from_u64(ext, device).reshape(ROUNDS_F, WIDTH, 1)
    int_t = gl.from_u64(intr, device)
    diag_t = gl.from_u64([(d - 1) % gl.P for d in diag], device).reshape(WIDTH, 1)
    return ext_t, int_t, diag_t


def _dbl(x):
    return gl.add(x, x)


def external_linear(st: torch.Tensor) -> torch.Tensor:
    """M_E = circ(2*M4, M4, M4) on a (12, ...) planar state, by the M4 add
    chain with the three 4-lane chunks folded into the batch."""
    c = st.reshape((3, 4) + st.shape[1:])
    c0, c1, c2, c3 = (c[:, i] for i in range(4))
    t0 = gl.add(c0, c1)
    t1 = gl.add(c2, c3)
    t2 = gl.add(_dbl(c1), t1)
    t3 = gl.add(_dbl(c3), t0)
    t4 = gl.add(_dbl(_dbl(t1)), t3)
    t5 = gl.add(_dbl(_dbl(t0)), t2)
    m = torch.stack([gl.add(t3, t5), t5, gl.add(t2, t4), t4], dim=1)
    total = gl.add(gl.add(m[0], m[1]), m[2])
    return gl.add(m, total[None]).reshape(st.shape)


def permute_planar_plain(x: torch.Tensor) -> torch.Tensor:
    """(12, n) int64 -> (12, n): the plain torch version of the kernel."""
    ext, intr, diag = _plain_tables(x.device)
    st = external_linear(gl.canon(x))
    half = ROUNDS_F // 2
    for r in range(half):
        st = external_linear(gl.exp7(gl.add(st, ext[r])))
    for r in range(ROUNDS_P):
        s0 = gl.exp7(gl.add(st[:1], intr[r]))
        st = torch.cat([s0, st[1:]])
        st = gl.add(gl.mul(st, diag), gl.sum_axis(st, 0)[None])
    for r in range(half, ROUNDS_F):
        st = external_linear(gl.exp7(gl.add(st, ext[r])))
    return st


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def permute_planar(x: torch.Tensor) -> torch.Tensor:
    """(12, n) int64 planar state -> (12, n) canonical permuted state.

    CPU tensor: the plain version.  CUDA tensor: the kernel, on the current
    stream, or an exception."""
    if x.dtype != torch.int64 or x.dim() != 2 or x.shape[0] != WIDTH:
        raise ValueError(f"expected a (12, n) int64 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return permute_planar_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no Poseidon2 kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the Poseidon2 kernel takes a contiguous (12, n) tensor")
    out = torch.empty_like(x)
    n = x.shape[1]
    if n == 0:
        return out
    fn = build().lib.mp2_poseidon2_permute_planar
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"Poseidon2 kernel launch failed: CUDA error {rc}")
    permute_planar.launches += 1
    return out


permute_planar.launches = 0
