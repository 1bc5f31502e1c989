"""Where the time of one itx work list goes, phase by phase, on the card.

    python3 -m dav1d_mirror_tpu_torch.tools.itx_phases [--stream IVF]
        [--inter N]

Run from the root of a checkout on a machine with a CUDA card. It decodes
the stream (default: config 2, bench_cache/e2e_1080p_inter_cdef_*.ivf)
through ``Decoder(Settings(device="cuda"))`` up to its N-th inter frame
(default 3, frame 3), keeps that frame's clip-add run (its ``itxrun``
record, descriptor buffers and plane shapes), builds ``csrc/itx.cu`` a
second time with ``-DITX_PHASES`` (a globaltimer stamp at each phase
boundary of each work item) into the kernel build directory, and runs the
run with it on random int32 planes: warm (after a run on the same data)
and cold (after a 256 MB write). It prints, for each (tx size,
sparse/dense) group of work items, their count, start and the mean time
of each phase (entry read, tile zeroed and pixels staged, expand, row
scan and pass, column pass, write-out and the item's last barrier), the
slowest item's total, and the launch's span; and the warm event time of
the run with the instrumented and with the built library, in turns.
Stamps are taken by one thread a CTA, so a phase's time is that thread's
view of it (its block's, after the CTA's barrier where one ends it).
"""
from __future__ import annotations

import argparse
import ctypes as ct
import glob
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_build, itx, itx_cuda
from ..ops.itx_meta import TX_INFO

PHASES = ("entry", "zero+stage", "expand", "scan+row", "column",
          "write+sync")


def keep_add_run(stream, n_inter):
    """(sig, desc, desc16) of the program whose clip-add run is the
    n_inter-th one the decode of `stream` executes."""
    from .. import api
    from ..host.ivf import parse_ivf
    from ..models import frame_exec
    kept = []
    orig = frame_exec.execute_program

    def spy(sig, desc, desc16, desc8, refsrc):
        if any(r[0] == "itxrun" and r[1] == "add" for r in sig[0]):
            kept.append((sig, desc, desc16))
        return orig(sig, desc, desc16, desc8, refsrc)
    with open(stream, "rb") as f:
        _, _, _, frames = parse_ivf(f.read())
    frame_exec.execute_program = spy
    try:
        dec = api.Decoder(api.Settings(device="cuda"))
        for fr in frames:
            dec.send_data(fr.data)
            while dec.get_picture() is not None:
                pass
            if len(kept) >= n_inter:
                break
    finally:
        frame_exec.execute_program = orig
    if len(kept) < n_inter:
        raise SystemExit(f"{stream}: {len(kept)} clip-add runs, "
                         f"asked for the {n_inter}-th")
    return kept[n_inter - 1]


def build_instrumented():
    """csrc/itx.cu built with -DITX_PHASES; returns the loaded library."""
    os.makedirs(cuda_build.BUILD, exist_ok=True)
    so = os.path.join(cuda_build.BUILD, "libitx_phases.so")
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS,
                    "-DITX_PHASES", "-o", so,
                    os.path.join(cuda_build.CSRC, "itx.cu")], check=True)
    lib = ct.CDLL(so)
    lib.itx_error_string.restype = ct.c_char_p
    lib.itx_error_string.argtypes = [ct.c_int]
    lib.itx_phase_read.restype = ct.c_int
    lib.itx_phase_read.argtypes = [ct.c_void_p, ct.c_int]
    itx_cuda._bind(lib)
    return lib


def event_ms(fn, n=100):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def report(stamps, item_entry, entries, label):
    """Print the phases of the work items by (tx size, sparse/dense)."""
    ok = (stamps[:, [0, 1, 2, 3, 4, 6]] > 0).all(axis=1)
    t0 = stamps[ok, 0].min()
    print(f"{label}: launch span {(stamps[ok, 6].max() - t0) / 1e3:.2f} us, "
          f"{len(stamps)} work items ({int(ok.sum())} stamped)")
    groups = {}
    for w in np.nonzero(ok)[0]:
        e = entries[item_entry[w]]
        wd, ht, _ = TX_INFO[e[itx.E_TX]]
        key = (wd, ht, "dense" if e[itx.E_K] > 16 else "sparse")
        groups.setdefault(key, []).append(w)
    for key in sorted(groups):
        st = stamps[groups[key]].astype(np.float64)
        col = np.where(st[:, 5] > 0, st[:, 5], st[:, 4])   # t0 block dead
        d = np.stack([st[:, 1] - st[:, 0], st[:, 2] - st[:, 1],
                      st[:, 3] - st[:, 2], st[:, 4] - st[:, 3],
                      col - st[:, 4], st[:, 6] - col], axis=1) / 1e3
        print(f"  {key[0]}x{key[1]} {key[2]}: {len(st)} items, start "
              f"{(st[:, 0].mean() - t0) / 1e3:.2f} us; " +
              ", ".join(f"{p} {v:.2f}" for p, v in zip(PHASES, d.mean(0)))
              + f" us; slowest item {(st[:, 6] - st[:, 0]).max() / 1e3:.2f}"
              " us")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stream", default=(glob.glob(
        "bench_cache/e2e_1080p_inter_cdef_*.ivf") or [None])[0])
    ap.add_argument("--inter", type=int, default=3)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("itx_phases: no CUDA device", file=sys.stderr)
        return 1
    sig, desc, desc16 = keep_add_run(opts.stream, opts.inter)
    (_, _, (off, shape), work, _), = [r for r in sig[0] if r[0] == "itxrun"
                                      and r[1] == "add"]
    tab = desc[off:off + shape[0]]
    bd = sig[2]
    rng = np.random.default_rng(0)
    planes = [torch.from_numpy(rng.integers(0, 1 << bd, s).astype(
        np.int32)).cuda() for s in sig[3]]
    host = tab.cpu().numpy()
    entries = itx.table_entries(host, work[0])
    item_entry = host[work[0] * itx.ENTRY:]
    print(f"{opts.stream}, inter frame {opts.inter}'s clip-add run: "
          f"{work[0]} entries, "
          f"{sum(e[itx.E_NREAL] for e in entries)} real blocks, "
          f"{work[1]} work items; {torch.cuda.get_device_name(0)}")

    def run():
        itx_cuda.itx_run("add", tab, work, desc, desc16, bd, planes)
    itx_cuda.load("itx", itx_cuda._bind)
    built = cuda_build._libs["itx"]
    lib = build_instrumented()
    n = min(work[1], 16384)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    try:
        cuda_build._libs["itx"] = lib
        for label in ("warm", "cold"):
            run()
            torch.cuda.synchronize()
            if label == "cold":
                scratch.fill_(1)
            run()
            torch.cuda.synchronize()
            buf = np.zeros(n * 8, np.uint64)
            rc = lib.itx_phase_read(buf.ctypes.data, n)
            if rc:
                raise RuntimeError(f"itx_phase_read: {rc}")
            report(buf.reshape(n, 8).astype(np.int64), item_entry, entries,
                   label)
        times = []
        for which in (built, lib, lib, built):
            cuda_build._libs["itx"] = which
            times.append(event_ms(run))
    finally:
        cuda_build._libs["itx"] = built
    print("warm ms a run, in turns (built, instrumented, instrumented, "
          "built): " + ", ".join(f"{t:.5f}" for t in times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
