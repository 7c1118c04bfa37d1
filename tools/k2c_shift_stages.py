"""K2c with shift-multiply stages against K2c as shipped, on one CUDA card.

The TPU NTT kernels multiplied the stages of length <= 64 by shifts, since
the roots of unity of order <= 64 in Goldilocks are powers of 2.  K2c
(`mp2_tpu_torch/csrc/ntt_t.cu`) multiplies every stage from its twiddle
table.  This script builds a variant of K2c whose stages 1-6 multiply by
`gl::mul_pow2_uniform_lazy` (shifts, by branches that a warp sharing its
exponent runs once: in K2c's interleaved layout a warp's threads share the
twiddle exponent wherever a tile is 32 columns wide), holds it bit for bit
against the shipped kernel, and times both, alternating, at the prover's
shapes:

    python3 tools/k2c_shift_stages.py

The variant is made from the shipped sources by text substitution into
`mp2_tpu_torch/_build/k2c_shift_stages/` and is never on the prover's path.
It prints the card's name and power limit beside every time.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from mp2_tpu_torch.field import goldilocks as gl  # noqa: E402
from mp2_tpu_torch.field.goldilocks import P  # noqa: E402
from mp2_tpu_torch.ops import _nvcc  # noqa: E402
from mp2_tpu_torch.ops import ntt_t_cuda as T  # noqa: E402
from mp2_tpu_torch.ops.ntt_cuda import _root_of_unity, _stage_table  # noqa: E402
from mp2_tpu_torch.ops.probe_cuda import card  # noqa: E402

MAX_SHIFT_STAGE = 6  # w_{2^s} is a power of 2 for s <= 6


def _substitute(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"the shipped source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variant() -> ctypes.CDLL:
    out = _nvcc.BUILD_DIR / "k2c_shift_stages"
    out.mkdir(parents=True, exist_ok=True)
    kernel = _substitute((_nvcc.CSRC / "ntt_t.cu").read_text(), [
        ("""                                            const uint64_t* __restrict__ stage_tw) {
  return gl::mul_lazy(x, stage_tw[(1 << (s - 1)) - 1 + j]);""",
         """                                            const uint64_t* __restrict__ stage_tw,
                                            uint64_t roots) {
  if (roots != 0 && s <= 6) {
    const uint32_t e0 = (uint32_t)(roots >> (8 * (s - 1))) & 255u;
    return gl::mul_pow2_uniform_lazy(x, (e0 * (uint32_t)j) % 192u);
  }
  return gl::mul_lazy(x, stage_tw[(1 << (s - 1)) - 1 + j]);"""),
        ("""                                           const uint64_t* __restrict__ stage_tw) {
  int s = 1;""",
         """                                           const uint64_t* __restrict__ stage_tw,
                                           uint64_t roots = 0) {
  int s = 1;"""),
        ("twiddle(a1, s, j, stage_tw)", "twiddle(a1, s, j, stage_tw, roots)"),
        ("twiddle(a3, s, j, stage_tw)", "twiddle(a3, s, j, stage_tw, roots)"),
        ("twiddle(b2, s + 1, j, stage_tw)", "twiddle(b2, s + 1, j, stage_tw, roots)"),
        ("twiddle(b3, s + 1, j + h, stage_tw)", "twiddle(b3, s + 1, j + h, stage_tw, roots)"),
        ("""                int log_d, int post_shift) {""",
         """                int log_d, int post_shift, uint64_t roots) {"""),
        ("ntt::dit_stages(sh, tile, log_tile, log_l, stride, stage_tw);",
         "ntt::dit_stages(sh, tile, log_tile, log_l, stride, stage_tw, roots);"),
        ("""                            unsigned long long scale, int log_d, int post_shift,
                            void* stream) {""",
         """                            unsigned long long scale, int log_d, int post_shift,
                            unsigned long long roots, void* stream) {"""),
        ("(uint64_t)scale, log_d, post_shift);",
         "(uint64_t)scale, log_d, post_shift, (uint64_t)roots);"),
    ])
    (out / "ntt_t_shift.cu").write_text(kernel)
    so = out / "libk2c_shift.so"
    cmd = [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-I", str(out), "-I", str(_nvcc.CSRC),
           "-o", str(so), str(out / "ntt_t_shift.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_nvcc.NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the variant:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line:
            print("variant ptxas: " + line.strip())
    for fn, (n_sass, n_mul) in _nvcc.sass_counts(so).items():
        print(f"variant sass: {n_sass} instructions, {n_mul} integer multiplies")
    lib = ctypes.CDLL(str(so))
    lib.mp2_ntt_cols.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_void_p]
    lib.mp2_ntt_cols.restype = ctypes.c_int
    return lib


def root_exponents(log_l: int, inverse: bool) -> int:
    """Byte s - 1: the e with 2^e = w_{2^s} (inverted when `inverse`), s <= 6."""
    packed = 0
    for s in range(1, min(MAX_SHIFT_STAGE, log_l) + 1):
        w = _root_of_unity(s)
        if inverse:
            w = pow(w, P - 2, P)
        packed |= next(e for e in range(192) if pow(2, e, P) == w) << (8 * (s - 1))
    return packed


def variant_passes(lib, x, log_n, inverse, log_in, pre):
    """The two passes of T._launch_passes (up to 2^20 points) on the
    variant kernel."""
    dev, B = x.device, x.shape[0]
    n = 1 << log_n
    log1, log2 = T.passes(log_n)
    a = torch.empty((B, n), dtype=torch.int64, device=dev)
    out = torch.empty((B, n), dtype=torch.int64, device=dev)
    scale = pow(n, P - 2, P) if inverse else 0
    # the first pass written transposed (log_d 0), the second in place
    passes = ((x, a, log1, log2, log_in - log2, pre, _stage_table(log1, inverse, dev),
               T._four_step_twiddles(log_n, inverse, dev), 0, 0),
              (a, out, log2, log1, log2, None, _stage_table(log2, inverse, dev), None, scale,
               log1))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for src, dst, log_l, log_m, log_l_in, pre_t, table, post, sc, log_d in passes:
        rc = lib.mp2_ntt_cols(src.data_ptr(), dst.data_ptr(), B, log_l, log_m, log_l_in,
                              pre_t.data_ptr() if pre_t is not None else None,
                              table.data_ptr(), post.data_ptr() if post is not None else None,
                              sc, log_d, 0, root_exponents(log_l, inverse), stream)
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
        print("k2c_shift_stages: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    lib = build_variant()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    cases = [(f"transform ({b}*136, 2^{log_n})", b * 136, log_n, False, 0)
             for b, log_n in ((16, 16), (8, 17), (1, 18))]
    cases.append(("iNTT (2*136, 2^15)", 2 * 136, 15, True, 0))
    cases += [(f"LDE ({b}*136, 2^{log_n - 3} -> 2^{log_n})", b * 136, log_n, False, 3)
              for b, log_n in ((16, 16), (8, 17))]
    for label, rows, log_n, inverse, rate in cases:
        x = gl.canon(torch.randint(-2**63, 2**63 - 1, (rows, 1 << (log_n - rate)),
                                   device="cuda", dtype=torch.int64, generator=gen))
        if rate:
            pre = T._coset_powers(1 << (log_n - rate), shift, x.device)
            shipped = lambda: T.lde_t(x, rate, shift)  # noqa: E731
            variant = lambda: variant_passes(lib, x, log_n, False, log_n - rate, pre)  # noqa: E731
        else:
            shipped = lambda: T.ntt_four_step_t(x, inverse)  # noqa: E731
            variant = lambda: variant_passes(lib, x, log_n, inverse, log_n, None)  # noqa: E731
        if not torch.equal(shipped(), variant()):
            print(f"k2c_shift_stages: the variant disagrees with K2c at {label}")
            return 1
        s1, v1, v2, s2 = (_time_ms(f) for f in (shipped, variant, variant, shipped))
        print(f"{label}: shipped {s1:.4f} {s2:.4f} ms, shift stages {v1:.4f} {v2:.4f} ms "
              f"(CUDA events, mean of 20, alternating), identical; {name}", flush=True)
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
