"""Where the warp and comp work-list kernels' time goes, on one CUDA GPU.

    python3 -m dav1d_mirror_tpu_torch.tools.tool_runs

Run from the root of a checkout (it takes its timing and its call log
from ``chip_smoke.py``). It decodes the tools path's stream
(tests/streams_torch/e2e_1080p_inter_tools.ivf) to its frame 1 and keeps
that frame's ``warp_run``, ``comp_run`` and ``obmc_run`` calls, prints
their work (entries, units, joined or blended pixels, the entries'
sizes, the joins' kinds), and builds ``csrc/warp.cu`` again with other
CTA sizes (``-DWP_UNITS=4`` and ``8``; the decoder's build takes two
units a CTA) and with ``-DWARP_SKIP_FILTER`` (staging, descriptors and
stores, no filter: it computes something else), and ``csrc/comp.cu``
with ``-DCOMP_SKIP_SEGC`` (no luma reads for a seg chroma mask: it
computes something else). It prints the warm device time of each build
on the frame's run beside the decoder's build, which it holds to
``torch.equal`` with the plain version, and beside the same entries as
one-entry launches. The decoder never loads these builds.
"""
from __future__ import annotations

import ctypes as ct
import os
import sys

import numpy as np
import torch

from ..ops import cuda_build, mc, mc_cuda, tools_cuda

STREAM = "tests/streams_torch/e2e_1080p_inter_tools.ivf"
BUILDS = (("WP_UNITS=4", ("WP_UNITS=4",)), ("WP_UNITS=8", ("WP_UNITS=8",)),
          ("no filter", ("WARP_SKIP_FILTER",)))
COMP_BUILDS = (("no seg chroma luma reads", ("COMP_SKIP_SEGC",)),)


def _libs():
    """{build name: its library, bound and its filter table set}."""
    paths = cuda_build.build_variants(
        "warp", {f"v{n}": flags for n, (_, flags) in enumerate(BUILDS)})
    libs = {}
    for n, (name, _) in enumerate(BUILDS):
        lib = ct.CDLL(paths[f"v{n}"])
        tools_cuda._binder("warp", tools_cuda.WarpArgs)(lib)
        lib.warp_init.restype = ct.c_int
        lib.warp_init.argtypes = [ct.c_void_p]
        if lib.warp_init(tools_cuda.WARP_TABLE.ctypes.data) != 0:
            raise RuntimeError(f"warp_init failed for the {name} build")
        libs[name] = lib
    return libs


def _frame_calls(chip_smoke):
    """[(name, (args, kwargs))] of the tools stream's frame 1 warp_run and
    obmc_run calls (the decoder's, on the card)."""
    from .. import api
    from ..host.ivf import parse_ivf
    from ..output import MD5Muxer
    with open(STREAM, "rb") as f:
        _, _, _, frames = parse_ivf(f.read())
    log = chip_smoke.ToolsLog()
    with log:
        chip_smoke.decode(api, MD5Muxer, frames[:2], torch,
                          lambda i: setattr(log, "keep", i == 1))
    return log.kept


def _describe(name, a):
    tab, work = a[0], a[1]
    if name == "warp_run":
        rows = mc.table_rows(tab, work[0], mc.WENTRY)
        sizes = sorted((e[mc.W_NREAL] for e in rows), reverse=True)
        slot = sum(1 for e in rows if e[mc.W_FLAGS] & mc.WF_SLOT)
        return (f"warp_run: {work[0]} entries ({slot} slot entries), "
                f"{work[1]} units, the largest {sizes[:6]}")
    if name == "comp_run":
        ents, rows = mc.comp_table_parts(tab, work)
        px = (ents[:, mc.C_NREAL] * ents[:, mc.C_BH] * ents[:, mc.C_BW])
        area = np.repeat(px // np.maximum(ents[:, mc.C_NREAL], 1),
                         ents[:, mc.C_NREAL])
        kinds = {k: (int((rows[:, mc.R_KIND] == v).sum()),
                     int(area[rows[:, mc.R_KIND] == v].sum()))
                 for k, v in (("average", mc.CJ_WAVG), ("seg luma", mc.CJ_SEGL),
                              ("seg chroma", mc.CJ_SEGC),
                              ("wedge", mc.CJ_WEDGE))}
        return (f"comp_run: {work[0]} entries, {work[1]} real slots, "
                f"{int(px.sum())} joined pixels in {work[2]} work items; "
                f"(slots, pixels) by join {kinds}; slot shapes "
                f"{sorted({(int(e[mc.C_BW]), int(e[mc.C_BH])) for e in ents})}")
    rows = mc.table_rows(tab, work[0], mc.OENTRY)
    return (f"obmc_run: {work[0]} entries, {work[1]} blended pixels, "
            f"{sum(e[mc.O_NREAL] for e in rows)} real laps")


def main():
    if not torch.cuda.is_available():
        print("tool_runs: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from .tools_cases import one_entry_lists
    print(chip_smoke.card_line())
    cuda_build.build()
    libs = _libs()
    calls = _frame_calls(chip_smoke)
    for name, (a, _) in calls:
        print(_describe(name, a))
    a, k = next(c for n, c in calls if n == "warp_run")
    want = chip_smoke._clone(a)
    mc.warp_run(*want)
    got = chip_smoke._clone(a)
    tools_cuda.warp_run(*got)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(
        chip_smoke._tools_dst("warp_run", got),
        chip_smoke._tools_dst("warp_run", want))), "warp_run differs"
    stream = torch.cuda.current_stream().cuda_stream
    fa = tools_cuda.warp_args(*a)

    def launcher(lib):
        def run():
            rc = lib.warp_launch(ct.byref(fa), ct.c_void_p(stream))
            if rc != 0:
                raise RuntimeError(f"warp_launch: {rc}")
        return run
    singles = one_entry_lists(a[0], a[1], "warp")

    def run_singles():
        for tab, work in singles:
            tools_cuda.warp_run(tab, work, *a[2:])
    runs = [("decoder", lambda: tools_cuda.warp_run(*a))]
    runs += [(n, launcher(lib)) for n, lib in libs.items()]
    runs += [("decoder, one-entry launches", run_singles), runs[0]]
    floor = chip_smoke.time_warm(torch, mc_cuda.empty_launch, 200)
    print(f"empty launch (floor): {floor:.5f} ms warm")
    for name, fn in runs:
        n = max(1, chip_smoke.QUEUE_LAUNCHES //
                (len(singles) if "one-entry" in name else 1))
        print(f"tools frame 1 warp_run, {name}: "
              f"{chip_smoke.time_warm(torch, fn, n):.5f} ms warm")
    _comp_runs(chip_smoke, calls, stream)
    return 0


def _comp_runs(chip_smoke, calls, stream):
    """Times the frame's comp_run: the decoder's build, the COMP_BUILDS
    builds and the same entries as one-entry launches."""
    from .tools_cases import one_entry_lists
    a, _ = next(c for n, c in calls if n == "comp_run")
    want, got = chip_smoke._clone(a), chip_smoke._clone(a)
    mc.comp_run(*want)
    tools_cuda.comp_run(*got)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got[3], want[3])), \
        "comp_run differs"
    paths = cuda_build.build_variants(
        "comp", {f"c{n}": flags for n, (_, flags) in enumerate(COMP_BUILDS)})
    fa = tools_cuda.comp_args(*a)

    def launcher(lib):
        tools_cuda._binder("comp", tools_cuda.CompArgs)(lib)

        def run():
            rc = lib.comp_launch(ct.byref(fa), ct.c_void_p(stream))
            if rc != 0:
                raise RuntimeError(f"comp_launch: {rc}")
        return run
    singles = one_entry_lists(a[0], a[1], "comp")

    def run_singles():
        for tab, work in singles:
            tools_cuda.comp_run(tab, work, *a[2:])
    runs = [("decoder", lambda: tools_cuda.comp_run(*a))]
    runs += [(name, launcher(ct.CDLL(paths[f"c{n}"])))
             for n, (name, _) in enumerate(COMP_BUILDS)]
    runs += [("decoder, one-entry launches", run_singles), runs[0]]
    for name, fn in runs:
        n = max(1, chip_smoke.QUEUE_LAUNCHES //
                (len(singles) if "one-entry" in name else 1))
        print(f"tools frame 1 comp_run, {name}: "
              f"{chip_smoke.time_warm(torch, fn, n):.5f} ms warm")


if __name__ == "__main__":
    sys.exit(main())
