"""Build and load a kernel library: `nvcc` for sm_90a into a shared library
with a plain C interface, loaded with ctypes.

`build_library` compiles the `.cu` files among `sources` (all under
`mp2_tpu_torch/csrc/`; headers are listed so that they enter the hash) plus
an optional generated header into `mp2_tpu_torch/_build/<name>-<hash>/`,
where the hash covers the sources, the header and the flags.  A library
already built under that hash is loaded without compiling.  A failed build
raises.  Call it at first use, never at import: the CPU tests import every
module and have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_TIMEOUT_S = 600  # a build that takes longer raises instead of hanging
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class Built:
    """The loaded kernel library and how it was made."""

    path: Path
    seconds: float  # nvcc wall time in this process; 0.0 if already built
    log: str  # nvcc's output (register and spill counts from -Xptxas -v)
    lib: ctypes.CDLL


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); cannot build a kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sass_counts(path: Path) -> dict:
    """{kernel symbol: (SASS instructions, integer multiplies)} of a built
    library, from `cuobjdump -sass`; the multiplies are the IMAD family
    without the moves, shifts and adds the compiler also issues as IMAD.
    Static counts: the code as compiled, not the instructions a thread
    runs where the kernel loops."""
    out = subprocess.run([os.path.join(os.path.dirname(nvcc()), "cuobjdump"), "-sass",
                          str(path)], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name][0] += 1
            counts[name][1] += (" IMAD" in line and not any(
                alu in line for alu in ("IMAD.MOV", "IMAD.SHL", "IMAD.IADD")))
    return {k: tuple(v) for k, v in counts.items()}


def build_library(name: str, sources: Sequence[str],
                  header: Optional[Tuple[str, str]] = None,
                  flags: Sequence[str] = NVCC_FLAGS) -> Built:
    """Compile (once per hash) and load `lib<name>.so`.  `header` is a
    (file name, text) pair written beside the library before compiling."""
    h = hashlib.sha256(" ".join(flags).encode())
    if header is not None:
        h.update(header[0].encode() + header[1].encode())
    for src in sources:
        h.update(src.encode() + (CSRC / src).read_bytes())
    out_dir = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"
    so = out_dir / f"lib{name}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        pid = os.getpid()
        if header is not None:
            tmp_h = out_dir / f"{header[0]}.{pid}.tmp"
            tmp_h.write_text(header[1])
            os.replace(tmp_h, out_dir / header[0])
        tmp = out_dir / f"lib{name}.{pid}.tmp.so"
        cmd = [nvcc(), *flags, "-I", str(out_dir), "-I", str(CSRC), "-o", str(tmp),
               *(str(CSRC / s) for s in sources if s.endswith(".cu"))]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"nvcc did not finish {name} within {NVCC_TIMEOUT_S} s") from e
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    return Built(path=so, seconds=seconds, log=log, lib=ctypes.CDLL(str(so)))
