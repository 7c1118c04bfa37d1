"""P1: the field-primitive probe, as a CUDA kernel and its plain twin.

Replaces `tools/probe_ops.py::_kern` (the Pallas TPU probe launched by
`_compiled`), which timed the `gl_u32` limb primitives to find which one
bounds the NTT and Poseidon2 kernels.  The kernel source is
`csrc/probe_ops.cu` on `csrc/goldilocks.cuh`; its header comment says what
bounds it (integer issue, by construction) and how the chain is built.

`probe(op, k, a, b)` is the one entry: int64 tensors a, b of n elements
(n a multiple of 256) -> canon(x_k), where x_0 = a and x_{r+1} =
op(x_r, b, r), elementwise.  On a CPU tensor it runs `probe_plain`, the same
chain in the port's torch field ops (canonical arithmetic for the lazy
ops, which compute the same residues).  On a CUDA tensor it launches the
kernel or raises; it never falls back to the plain version.
`probe.launches` counts kernel launches.

    python3 -m mp2_tpu_torch.ops.probe_cuda

prints, on one CUDA card, each op's cost as the slope of time against k over
N = 2^23 elements, with the card's name and power limit (`measure`), after
holding every (op, k) bit for bit against its plain twin.  The TPU probe's
chain lengths, {2, 18} ({2, 10} for the products), are timed too, but on
the card their slope says little: a kernel's 24 bytes per element take as
long at 3.35 TB/s as ~120 integer instructions per element, so a short
chain of a cheap op runs in the shadow of its memory traffic.  The cost is
the slope between two long chains, {256, 512} ({64, 128} for the
products), both compute-bound.

Build: at first use, `ops/_nvcc.build_library` compiles the kernel for
sm_90a into `mp2_tpu_torch/_build/mp2_probe-<hash>/` and loads it with
ctypes.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys

import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.ops._nvcc import Built, build_library

_SOURCES = ("probe_ops.cu", "goldilocks.cuh")
N = 1 << 23  # elements, as the TPU probe's 64 blocks of 8 x 2048 u32 pairs
THREADS = 256
PRODUCTS = ("mul", "mul_lazy", "sqr", "sqr_lazy", "mul_pow2_lazy", "mul_pow2_warp",
            "mul_pow2_uniform", "mul_wide", "mul_lazy_sel", "sqr_lazy_sel")
# The ops of csrc/probe_ops.cu, in its enum's order.  The *_sel ops are the
# lazy primitives by compare and select, the forms goldilocks.cuh's carry
# chains replaced, probe-local copies timed beside them.
OPS = ("mul", "mul_lazy", "sqr", "sqr_lazy", "add", "add_lazy", "sub", "sub_lazy",
       "canon", "mul_pow2_lazy", "mul_pow2_warp", "mul_pow2_uniform", "mul32",
       "mul_wide", "select", "shfl", "add_lazy_sel", "sub_lazy_sel", "mul_lazy_sel",
       "sqr_lazy_sel")
# Integer instructions per second of the H100 at its boost clock: the INT32
# pipe runs 64 lanes per SM per clock (half the FP32 rate), 132 SMs, 1.98
# GHz; a slope in these units is the op's cost in integer instructions
# where the integer pipe bounds it
INT_INSTR_PER_S = 132 * 64 * 1.98e9
M32 = 0xFFFFFFFF


def ks(op: str):
    """op's chain lengths: the TPU probe's pair, then the long pair whose
    time difference gives op's cost."""
    return (2, 10, 64, 128) if op in PRODUCTS else (2, 18, 256, 512)


@functools.lru_cache(maxsize=None)
def build() -> Built:
    """Compile (once per source hash) and load the kernel library."""
    built = build_library("mp2_probe", _SOURCES)
    fn = built.lib.mp2_probe_ops
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


# ---------------------------------------------------------------------------
# plain version (torch field ops)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pow2_table(device) -> torch.Tensor:
    return gl.from_u64([pow(2, e, P) for e in range(192)], device)


def warp_exponents(n: int, device) -> torch.Tensor:
    """The exponent of mul_pow2_warp and mul_pow2_uniform at each of n
    elements: one per warp of 32 threads, (warp * 131) mod 192."""
    return ((torch.arange(n, device=device) >> 5) * 131) % 192


def _halves(x):
    return x & M32, (x >> 32) & M32


def _step(op: str, x, y, r: int, two_e, two_ew):
    op = op.removesuffix("_sel")  # the same residues as the lazy ops
    if op in ("mul", "mul_lazy"):
        return gl.mul(x, y)
    if op in ("sqr", "sqr_lazy"):
        return gl.sqr(x)
    if op in ("add", "add_lazy"):
        return gl.add(x, y)
    if op in ("sub", "sub_lazy"):
        return gl.sub(x, y)
    if op == "canon":
        return gl.canon(x ^ y)
    if op == "mul_pow2_lazy":
        return gl.mul(x, two_e)
    if op in ("mul_pow2_warp", "mul_pow2_uniform"):
        return gl.mul(x, two_ew)
    if op == "mul32":
        lo, hi = _halves(x)
        return (((hi + lo) & M32) << 32) | ((lo * hi) & M32)
    if op == "mul_wide":
        lo, hi = gl._mul_wide(x, y)
        return lo ^ hi
    if op == "select":
        lo, hi = _halves(x)
        nlo = torch.where((lo & 1) == 0, lo, hi)
        nhi = torch.where((hi & 1) == 0, hi, lo)
        return (nhi << 32) | nlo
    if op == "shfl":
        s = 1 + r % 7
        return torch.roll(x.view(-1, 32), -s, dims=1).reshape(x.shape)
    raise ValueError(f"unknown probe op {op!r}")


def probe_plain(op: str, k: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel: the same k-step chain, canonical."""
    y_lo, y_hi = _halves(b)
    two_e = _pow2_table(a.device)[(y_hi * 64 + y_lo) % 192]  # 2^(b mod 192)
    two_ew = _pow2_table(a.device)[warp_exponents(a.numel(), a.device)]
    x = a
    for r in range(k):
        x = _step(op, x, b, r, two_e, two_ew)
    return gl.canon(x)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def probe(op: str, k: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """canon of op applied k times to a with operand b, elementwise; a, b
    int64 of the same n elements, n a multiple of 256; k in ks(op).

    CPU tensor: the plain version.  CUDA tensor: the kernel, on the current
    stream, or an exception."""
    if op not in OPS:
        raise ValueError(f"unknown probe op {op!r}")
    if k not in ks(op):
        raise ValueError(f"the probe chains {op} over {ks(op)} steps, not {k}")
    if a.dtype != torch.int64 or b.dtype != torch.int64 or a.shape != b.shape \
            or a.numel() % THREADS or a.numel() == 0:
        raise ValueError(f"expected two int64 tensors of one shape with a multiple of "
                         f"{THREADS} elements, got {a.dtype} {tuple(a.shape)}, "
                         f"{b.dtype} {tuple(b.shape)}")
    if a.device.type == "cpu":
        return probe_plain(op, k, a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"no probe kernel for devices {a.device}, {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the probe kernel takes contiguous tensors")
    out = torch.empty_like(a)
    fn = build().lib.mp2_probe_ops
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(OPS.index(op), k, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                a.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {rc}")
    probe.launches += 1
    return out


probe.launches = 0


# ---------------------------------------------------------------------------
# the measurement
# ---------------------------------------------------------------------------


def inputs(device, n: int = N, seed: int = 0):
    """Canonical random a, b of n elements (numpy default_rng(seed)), with
    the edge values 0, p-1, 2^32, 2^32-1 at the head of a."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    a[:4] = [0, P - 1, 1 << 32, (1 << 32) - 1]
    return gl.from_u64(a, device), gl.from_u64(b, device)


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(device="cuda", reps: int = 20):
    """Every op on the card: each (op, k) held bit for bit against its plain
    twin, then timed (CUDA events, mean of `reps` after a warm-up).  Returns
    {op: {"ms": {k: ms}, "ns_per_pass": slope, "gops": rate,
    "int_instr_per_op": slope in integer instructions per element,
    "short_ns_per_pass":
    the TPU probe's pair's slope}} and the largest |kernel - plain| seen (0
    when bit-exact)."""
    a, b = inputs(device)
    table, err = {}, 0
    for op in OPS:
        times = {}
        for k in ks(op):
            got = probe(op, k, a, b)
            want = probe_plain(op, k, a, b)
            if not torch.equal(got, want):
                diff = got != want
                err = max(err, max(abs(int(x) - int(y)) for x, y in zip(
                    gl.to_u64(got[diff][:64]), gl.to_u64(want[diff][:64]))))
                raise RuntimeError(f"probe {op} k={k}: {int(diff.sum())} elements "
                                   f"differ from the plain twin (max_abs_err {err})")
            times[k] = _time_ms(lambda: probe(op, k, a, b), reps)
        k0, k1, k2, k3 = ks(op)
        slope_ms = (times[k3] - times[k2]) / (k3 - k2)
        table[op] = {"ms": times, "ns_per_pass": slope_ms * 1e6,
                     "gops": N / (slope_ms * 1e-3) / 1e9 if slope_ms > 0 else float("inf"),
                     "int_instr_per_op": slope_ms * 1e-3 * INT_INSTR_PER_S / N,
                     "short_ns_per_pass": (times[k1] - times[k0]) / (k1 - k0) * 1e6}
    return table, err


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def print_table(table, name: str):
    print(f"P1 field-primitive probe, {N} elements, slope of CUDA-event time "
          f"against chain length; {name}")
    for op, row in table.items():
        times = "  ".join(f"k={k}: {ms:.4f} ms" for k, ms in row["ms"].items())
        print(f"{op:14s} {times}  {row['ns_per_pass'] / 1e3:8.3f} us/op-pass "
              f"{row['gops']:8.1f} Gop/s  {row['int_instr_per_op']:6.2f} int instructions/op "
              f"at 1.98 GHz  (k={ks(op)[0]}->{ks(op)[1]}: "
              f"{row['short_ns_per_pass'] / 1e3:.3f} us/op-pass)")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_cuda: no CUDA device", file=sys.stderr)
        return 2
    table, _ = measure()
    print_table(table, card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
