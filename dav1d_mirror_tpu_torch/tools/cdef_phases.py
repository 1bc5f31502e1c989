"""Where the CDEF frame kernel's time goes, on one CUDA GPU.

    python3 -m dav1d_mirror_tpu_torch.tools.cdef_phases

Run from the root of a checkout (it takes its timing from
``chip_smoke.py``). It decodes config 2 to its frame 3 and keeps that
frame's ``cdef_frame`` call, builds ``csrc/cdef.cu`` again three times,
with ``-DCDEF_SKIP_DIR`` (no direction search), ``-DCDEF_SKIP_FILTER``
(every pixel copied) and both (staging, block parameters and the copy
out), and prints the warm device time of each build on that call and on
the 4K CDEF frame of ``tools/filter_cases`` (every block active), beside
the decoder's build, which it holds to ``torch.equal`` with the plain
version. The skipping builds compute something else; the decoder never
loads them.
"""
from __future__ import annotations

import ctypes as ct
import os
import sys

import numpy as np
import torch

from ..ops import cdef, cdef_cuda, cuda_build
from . import filter_cases, filter_ops

CONFIG2 = "bench_cache/e2e_1080p_inter_cdef_727de0883e7e.ivf"
BUILDS = (("decoder", ()), ("no direction search", ("CDEF_SKIP_DIR",)),
          ("no filter", ("CDEF_SKIP_FILTER",)),
          ("neither", ("CDEF_SKIP_DIR", "CDEF_SKIP_FILTER")))


def _build():
    """{build name: its library, bound and its direction table set}."""
    libs = {}
    paths = cuda_build.build_variants(
        "cdef", {f"phases{n}": flags for n, (_, flags) in enumerate(BUILDS)})
    for n, (name, _) in enumerate(BUILDS):
        lib = ct.CDLL(paths[f"phases{n}"])
        cdef_cuda._bind(lib)
        if lib.cdef_init(ct.c_void_p(cdef_cuda.TABLE.ctypes.data)) != 0:
            raise RuntimeError(f"cdef_init failed for the {name} build")
        libs[name] = lib
    return libs


def _config2_call(chip_smoke):
    """(args, kwargs) of config 2 frame 3's cdef_frame call."""
    from ..models import frame_exec
    sig, *args = filter_ops.keep_filter_program(CONFIG2, 3)
    with chip_smoke.FilterLog() as log:
        log.keep = True
        frame_exec.execute_program(sig, *args)
    return next(call for name, call in log.kept if name == "cdef_frame")


def _times(chip_smoke, libs, a, k):
    """{build: warm ms} of one cdef_frame call, the decoder's build held
    to the plain version."""
    kw = dict(zip(("planes", "cdef_idx_map", "noskip4", "y_strengths",
                   "uv_strengths", "damping", "bitdepth", "ss_hor",
                   "ss_ver", "monochrome"), a), **k)
    planes = [p.to(torch.int32) for p in
              kw["planes"][:1 if kw["monochrome"] else 3]]
    want = cdef.cdef_frame(*a, **k)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, lib in libs.items():
        outs = [torch.empty_like(p) for p in planes]
        fa = cdef_cuda.frame_args(planes, outs, *(kw[n] for n in (
            "cdef_idx_map", "noskip4", "y_strengths", "uv_strengths",
            "damping", "bitdepth", "ss_hor", "ss_ver")))

        def run():
            rc = lib.cdef_frame_launch(ct.byref(fa), len(planes),
                                       ct.c_void_p(stream))
            if rc != 0:
                raise RuntimeError(f"cdef_frame_launch: {rc}")
        run()
        torch.cuda.synchronize()
        if name == "decoder" and not all(
                torch.equal(o, w) for o, w in zip(outs, want)):
            raise SystemExit("the decoder's build differs from the plain "
                             "version")
        out[name] = chip_smoke.time_warm(torch, run, 50)
    return out


def main():
    if not torch.cuda.is_available():
        print("cdef_phases: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    print(chip_smoke.card_line())
    libs = _build()
    a, k = _config2_call(chip_smoke)
    label, kw = filter_cases.cdef_4k_case(np.random.default_rng(2026))
    kw = filter_cases.to_torch(kw, torch.device("cuda"))
    a4 = (tuple(kw.pop("planes")),) + tuple(kw.pop(n) for n in (
        "cdef_idx_map", "noskip4", "y_strengths", "uv_strengths"))
    for what, (x, y) in (("config 2 frame 3", (a, k)), (label, (a4, kw))):
        times = _times(chip_smoke, libs, x, y)
        print(f"{what}: " + ", ".join(f"{n} {ms:.5f} ms warm"
                                     for n, ms in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
