"""K1: the batched Poseidon2 permutation and the Merkle entries built on it,
as CUDA kernels and their plain twins.

Replaces `mp2_tpu/ops/poseidon2_pallas.py::_kernel` (the Pallas TPU kernel).
The kernel source is `csrc/poseidon2.cu` on `csrc/goldilocks.cuh`; its header
comment says what bounds it on Hopper (integer instruction issue) and how the
design answers that (lazy arithmetic, wide linear-layer sums).

Three entries, each with its plain twin in this module:
  * `permute_planar(x)`: a (12, n) int64 planar state in, the permuted state
    out (challenger, PI hash, grinding);
  * `hash_leaves(lde_nat)`: a natural-order LDE (B, C, m) in, the Merkle leaf
    digests (B, m, 4) out, in the bit-reversed leaf order of the tree
    (hash_or_noop of each column, one launch);
  * `merkle_levels(digests, cap_height)`: leaf digests (B, m, 4) in, every
    level above them up to the cap out (a launch per 9 levels: two for
    every tree the prover builds).
On a CPU tensor each runs its plain twin, written with the port's torch
field ops.  On a CUDA tensor it launches its kernel or raises; it never
falls back to the plain version.  Each entry's `.launches` counts its kernel
launches; `launches()` is their K1 total.

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
from mp2_tpu_torch.ops.ntt_cuda import _bitrev_t

LEVELS_PER_LAUNCH = 9  # a block hashes 2^9 digests into 9 levels

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
    lib = built.lib
    lib.mp2_poseidon2_permute_planar.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.mp2_poseidon2_hash_leaves.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.mp2_poseidon2_merkle_levels.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.mp2_poseidon2_permute_planar, lib.mp2_poseidon2_hash_leaves,
               lib.mp2_poseidon2_merkle_levels):
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


def hash_leaves_plain(lde_nat: torch.Tensor, permute=None) -> torch.Tensor:
    """(B, C, m) natural order -> (B, m, 4): the plain version of the leaf
    kernel, the composition the prover ran before it: bit-reverse the
    points, transpose to leaves (B, m, C), sponge each leaf (hash_or_noop)
    by `permute` (default: the plain permutation)."""
    from mp2_tpu_torch.hash import poseidon2 as p2

    m = lde_nat.shape[-1]
    leaves = torch.index_select(lde_nat, -1, _bitrev_t(m.bit_length() - 1, lde_nat.device))
    return p2.hash_or_noop(leaves.transpose(1, 2), permute or permute_planar_plain)


def merkle_levels_plain(digests: torch.Tensor, cap_height: int, permute=None) -> list:
    """(B, m, 4) leaf digests -> the levels above them, [(B, m/2, 4), ...,
    (B, 2^cap_height, 4)]: the plain version of the levels kernel, one
    two_to_one over a whole level per step by `permute` (default: the plain
    permutation)."""
    from mp2_tpu_torch.hash import poseidon2 as p2

    levels = []
    while digests.shape[1] > (1 << cap_height):
        digests = p2.two_to_one(digests[:, 0::2], digests[:, 1::2],
                                permute or permute_planar_plain)
        levels.append(digests)
    return levels


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_cuda(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"no Poseidon2 kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"the {what} kernel takes a contiguous tensor")


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
        rc = fn(x.data_ptr(), out.data_ptr(), n, _stream(x))
    if rc != 0:
        raise RuntimeError(f"Poseidon2 kernel launch failed: CUDA error {rc}")
    permute_planar.launches += 1
    return out


def hash_leaves(lde_nat: torch.Tensor) -> torch.Tensor:
    """(B, C, m) int64 natural-order LDE, m a power of two -> (B, m, 4) leaf
    digests in bit-reversed leaf order: row i holds hash_or_noop of the
    points at rev(i) (the leaves of `_leaves_batched` in the reference).

    CPU tensor: the plain version.  CUDA tensor: one kernel launch on the
    current stream, or an exception."""
    if lde_nat.dtype != torch.int64 or lde_nat.dim() != 3:
        raise ValueError(f"expected a (B, C, m) int64 tensor, got {lde_nat.dtype} "
                         f"{tuple(lde_nat.shape)}")
    B, C, m = lde_nat.shape
    log_m = m.bit_length() - 1
    if C == 0 or m == 0 or 1 << log_m != m:
        raise ValueError(f"leaf count {m} is not a power of two, or no columns")
    if lde_nat.device.type == "cpu":
        return hash_leaves_plain(lde_nat)
    _check_cuda(lde_nat, "leaf-hash")
    out = torch.empty((B, m, 4), dtype=torch.int64, device=lde_nat.device)
    if B == 0:
        return out
    with torch.cuda.device(lde_nat.device):
        rc = build().lib.mp2_poseidon2_hash_leaves(
            lde_nat.data_ptr(), out.data_ptr(), B, C, log_m, _stream(lde_nat))
    if rc != 0:
        raise RuntimeError(f"Poseidon2 leaf-hash kernel launch failed: CUDA error {rc}")
    hash_leaves.launches += 1
    return out


def merkle_levels(digests: torch.Tensor, cap_height: int) -> list:
    """(B, m, 4) int64 leaf digests, m a power of two -> the levels above
    them, [(B, m/2, 4), ..., (B, 2^cap_height, 4)] (empty when m is the cap
    size), each level's node i = two_to_one(node 2i, node 2i + 1).

    CPU tensor: the plain version.  CUDA tensor: one kernel launch per
    LEVELS_PER_LAUNCH levels on the current stream, or an exception.  The
    levels are views of one buffer."""
    if digests.dtype != torch.int64 or digests.dim() != 3 or digests.shape[2] != 4:
        raise ValueError(f"expected a (B, m, 4) int64 tensor, got {digests.dtype} "
                         f"{tuple(digests.shape)}")
    B, m, _ = digests.shape
    log_m = m.bit_length() - 1
    if m == 0 or 1 << log_m != m or not 0 <= cap_height <= log_m:
        raise ValueError(f"{m} digests do not reduce to a cap of 2^{cap_height}")
    if digests.device.type == "cpu":
        return merkle_levels_plain(digests, cap_height)
    _check_cuda(digests, "Merkle-level")
    sizes = [m >> j for j in range(1, log_m - cap_height + 1)]
    buf = torch.empty(B * 4 * sum(sizes), dtype=torch.int64, device=digests.device)
    levels, off = [], 0
    for size in sizes:
        levels.append(buf[off:off + B * size * 4].view(B, size, 4))
        off += B * size * 4
    fn = build().lib.mp2_poseidon2_merkle_levels
    src, done = digests, 0
    with torch.cuda.device(digests.device):
        while done < len(sizes):
            k = min(LEVELS_PER_LAUNCH, len(sizes) - done)
            rc = fn(src.data_ptr(), levels[done].data_ptr(), B, log_m - done, k,
                    _stream(digests))
            if rc != 0:
                raise RuntimeError(f"Poseidon2 Merkle-level kernel launch failed: "
                                   f"CUDA error {rc}")
            merkle_levels.launches += 1
            done += k
            src = levels[done - 1]
    return levels


permute_planar.launches = 0
hash_leaves.launches = 0
merkle_levels.launches = 0


def launches() -> int:
    """K1 launches so far, all entries together."""
    return permute_planar.launches + hash_leaves.launches + merkle_levels.launches
