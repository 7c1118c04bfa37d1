"""K2's 2^14-point rows: the shipped block of 1024 threads against a cluster
of two blocks of 512, on one CUDA card.

The shipped kernel (`mp2_tpu_torch/csrc/ntt.cu`) keeps a 2^14 row in the
registers of one 1024-thread block, so one block fills an SM and every
exchange barrier stalls the whole SM.  The variant (`tools/k2_cluster.cu`,
which includes the shipped source and reuses its 2^13 passes) splits the
row across a 2-block cluster: each block transforms half the samples with
its own barriers, and one exchange through distributed shared memory
combines the halves.  This script builds the variant into
`mp2_tpu_torch/_build/k2_cluster/` in two forms (ptxas asked for two blocks
per SM, hence at most 64 registers, or for one), prints ptxas's registers
and stack frames, holds both bit for bit against the shipped kernel and
times each beside it, alternating (shipped, variant, variant, shipped), at
the aggregation's iNTT shape (8*136 rows of 2^14 points) and a forward
transform of the same shape, beside the shipped 2^13 iNTT of the same
bytes (16*136 rows):

    python3 tools/k2_cluster.py

It prints the card's name and power limit beside every time.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from mp2_tpu_torch.field import goldilocks as gl  # noqa: E402
from mp2_tpu_torch.field.goldilocks import P  # noqa: E402
from mp2_tpu_torch.ops import _nvcc  # noqa: E402
from mp2_tpu_torch.ops import ntt_cuda as N  # noqa: E402
from mp2_tpu_torch.ops.probe_cuda import card  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "k2_cluster.cu"


def build() -> ctypes.CDLL:
    out = _nvcc.BUILD_DIR / "k2_cluster"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libk2_cluster.so"
    cmd = [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-I", str(_nvcc.CSRC), "-o", str(so), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_nvcc.NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the variant:\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and ("cluster" in line or "ILi13E" in line
                                          or "ILi14E" in line):
            props = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                     if "stack frame" in x or "registers" in x]
            print(f"ptxas {line.split('entry function')[-1].strip()}: {'; '.join(props)}")
    lib = ctypes.CDLL(str(so))
    lib.mp2_ntt14_cluster.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mp2_ntt14_cluster.restype = ctypes.c_int
    return lib


def cluster_ntt(lib, x: torch.Tensor, inverse: bool, min_blocks: int) -> torch.Tensor:
    out = torch.empty_like(x)
    table = N._pass_table(13, inverse, x.device)
    comb = N._coset_powers(1 << 13, N._root(14, inverse), x.device)
    scale = pow(1 << 14, P - 2, P) if inverse else 0
    rc = lib.mp2_ntt14_cluster(x.data_ptr(), out.data_ptr(), x.shape[0], table.data_ptr(),
                               comb.data_ptr(), scale, int(inverse), min_blocks,
                               torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed: CUDA error {rc}")
    return out


def _time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_cluster: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(rows, log_n):
        return gl.canon(torch.randint(-2**63, 2**63 - 1, (rows, 1 << log_n), device="cuda",
                                      dtype=torch.int64, generator=gen))

    for rows in (1, 3, 8):  # small counts: ragged grids, both ranks
        x = rand(rows, 14)
        for inverse in (False, True):
            for mb in (1, 2):
                if not torch.equal(cluster_ntt(lib, x, inverse, mb),
                                   N.ntt_rows(x, inverse, scale=inverse)):
                    print(f"k2_cluster: the variant disagrees with K2 at ({rows}, 2^14), "
                          f"inverse={inverse}, min_blocks={mb}")
                    return 1
    x13 = rand(16 * 136, 13)
    ms13 = _time_ms(lambda: N.ntt_rows(x13, True, scale=True))
    print(f"shipped iNTT (16*136, 2^13): {ms13:.4f} ms (CUDA events, mean of 20); {name}")
    del x13
    x = rand(8 * 136, 14)
    for (label, inverse), mb in itertools.product((("iNTT", True), ("NTT", False)), (1, 2)):
        ship = lambda: N.ntt_rows(x, inverse, scale=inverse)  # noqa: E731
        var = lambda: cluster_ntt(lib, x, inverse, mb)  # noqa: E731
        if not torch.equal(ship(), var()):
            print(f"k2_cluster: the variant disagrees with K2 at {label} (8*136, 2^14)")
            return 1
        s1, v1, v2, s2 = (_time_ms(f) for f in (ship, var, var, ship))
        print(f"{label} (8*136, 2^14): shipped {s1:.4f} {s2:.4f} ms, cluster with "
              f"min_blocks {mb} {v1:.4f} {v2:.4f} ms (CUDA events, mean of 20, "
              f"alternating), identical; {name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
