"""Time the MC V-pass kernel (csrc/mc_vpass.cu) against a second design
(tools/mc_vpass_wide.cu: wide aligned loads with a select, 16-byte
stores) on one CUDA GPU, in one process.

    python3 -m dav1d_mirror_tpu_torch.tools.vpass_variants

Run from the root of a checkout: it takes its timing (warm and cold-L2
device time) and its V-pass edge cases from ``chip_smoke.py``. It builds
both sources, holds every variant of the second design to ``torch.equal``
with the plain version (``ops/mc.mc_unit_batch_hv``) at the edge cases
and at the timed inputs, then times the kernel and each variant at 16384
units, bd 8 put, over a (64, 1080, 1942) H-plane stack (C = 64 combos of
a 1080p frame): 8x8, 4x4 and 2x2 units with random descriptors, and 8x8
units tiled side by side over the planes, as a decoded block's units
lie. The decoder never loads the second design. Exits non-zero without
a CUDA device or when a variant differs.
"""
from __future__ import annotations

import ctypes as ct
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_build, mc, mc_cuda

_SRC = os.path.join(os.path.dirname(__file__), "mc_vpass_wide.cu")
# (columns per thread at uw = 8, threads per block); uw = 4 and 2 take 4
# and 2 columns
VARIANTS = ((8, 64), (8, 128), (4, 64), (4, 128))
B_TIMED = 16384
C_T, H_T, W_T = 64, 1080, 1920


def _build():
    so = os.path.join(cuda_build.BUILD, "libmc_vpass_wide.so")
    os.makedirs(cuda_build.BUILD, exist_ok=True)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                    _SRC],
                   check=True)
    lib = ct.CDLL(so)
    vp = ct.c_void_p
    lib.vpass_wide_launch.restype = ct.c_int
    lib.vpass_wide_launch.argtypes = [vp] * 7 + [ct.c_int] * 11 + [vp]
    lib.vpass_wide_init.restype = ct.c_int
    lib.vpass_wide_init.argtypes = [vp]
    lib.vpass_wide_error_string.restype = ct.c_char_p
    lib.vpass_wide_error_string.argtypes = [ct.c_int]
    _raise_on(lib, lib.vpass_wide_init(mc.SUBPEL.ctypes.data))
    return lib


def _raise_on(lib, rc):
    if rc != 0:
        msg = lib.vpass_wide_error_string(rc).decode()
        raise RuntimeError(f"vpass_wide failed: {msg} ({rc})")


def wide(lib, args, uw, uh, bd, prep, nc, nt):
    """The second design on `args` (as ``mc_cuda.mc_unit_batch_hv``)."""
    hstack, *cols = args
    B = cols[0].shape[0]
    _, H, w_mid = hstack.shape
    out = torch.empty((B, uh, uw), dtype=torch.int32, device=hstack.device)
    _raise_on(lib, lib.vpass_wide_launch(
        hstack.data_ptr(), *(c.data_ptr() for c in cols), out.data_ptr(),
        B, H, w_mid, uw, uh, mc.ibits(bd), 0 if bd == 8 else 8192,
        (1 << bd) - 1, int(prep), nc, nt,
        torch.cuda.current_stream().cuda_stream))
    return out


def _variants(uw):
    """The distinct (columns per thread, threads per block) at `uw`."""
    return sorted({(min(nc, uw), nt) for nc, nt in VARIANTS})


def _timed_args(rng, hstack, uw, tiled):
    B = B_TIMED
    if tiled:   # units side by side in rows of the frame, 64 to a plane
        k = np.arange(B)
        per_row = W_T // uw
        cols = [k // 64 % C_T, 8 * (k // per_row) - 3,
                uw * (k % per_row) - 3]
    else:
        cols = [rng.integers(0, C_T, B), rng.integers(-40, H_T + 30, B),
                rng.integers(-15, W_T, B)]
    cols += [rng.integers(1, 16, B), rng.integers(0, 3, B)]
    return (hstack, *(torch.from_numpy(c.astype(np.int32)).to(hstack.device)
                      for c in cols))


def main():
    if not torch.cuda.is_available():
        print("vpass_variants: torch.cuda is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    print(f"card: {cs.card_line()}")
    cuda_build.build()
    lib = _build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)

    def check(args, uw, uh, bd, prep, label):
        want = mc.mc_unit_batch_hv(args, uw, uh, bd, prep)
        got = [mc_cuda.mc_unit_batch_hv(args, uw, uh, bd, prep)] + [
            wide(lib, args, uw, uh, bd, prep, nc, nt)
            for nc, nt in _variants(uw)]
        for g, name in zip(got, ["kernel"] + _variants(uw)):
            assert torch.equal(g, want), f"{name} differs: {label} {prep}"
        return len(got)

    n = 0
    for lbl, args, uw, uh, bd in cs.vpass_edge_cases(rng, np, torch, dev):
        for prep in (False, True):
            n += check(args, uw, uh, bd, prep, lbl)
    gen = torch.Generator(device=dev).manual_seed(2024)
    hstack = torch.randint(-(1 << 14), 1 << 14, (C_T, H_T, W_T + 22),
                           dtype=torch.int16, device=dev, generator=gen)
    cases = [(f"{u}x{u} random", _timed_args(rng, hstack, u, False), u)
             for u in (8, 4, 2)]
    cases.append(("8x8 tiled", _timed_args(rng, hstack, 8, True), 8))
    for lbl, args, u in cases:
        n += check(args, u, u, 8, False, lbl)
    print(f"equal to the plain version in {n} (case, design) pairs")

    scratch = torch.empty(cs.SCRATCH_BYTES, dtype=torch.uint8, device=dev)
    floor = cs.time_warm(torch, mc_cuda.empty_launch, 200)
    print(f"empty launch (floor): {floor:.5f} ms warm")
    for lbl, args, u in cases:
        b_ms, _ = cs.bound(B_TIMED * ((u + 7) * u * 2 + 5 * 4 + u * u * 4),
                           B_TIMED * u * u * 16)
        runs = [("kernel", lambda: mc_cuda.mc_unit_batch_hv(
            args, u, u, 8, False))]
        runs += [(f"wide nc={nc} nt={nt}",
                  lambda nc=nc, nt=nt: wide(lib, args, u, u, 8, False, nc,
                                            nt)) for nc, nt in _variants(u)]
        runs.append(runs[0])   # the kernel again, for the drift
        for name, fn in runs:
            warm = cs.time_warm(torch, fn, 100)
            cold = cs.time_cold(torch, fn, scratch, 20)
            print(f"{lbl} B={B_TIMED} bd8 put, {name}: {warm:.5f} ms warm "
                  f"({100 * b_ms / warm:.1f}% of bound), {cold:.5f} ms cold;"
                  f" bound {b_ms:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
