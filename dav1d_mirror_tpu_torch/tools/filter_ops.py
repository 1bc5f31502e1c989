"""Eager ops and wall time of one frame's filter program, on the card.

    python3 -m dav1d_mirror_tpu_torch.tools.filter_ops [--stream IVF]
        [--frame N] [--reps R]

Run from the root of a checkout on a machine with a CUDA card. It decodes
the stream (default: config 2, bench_cache/e2e_1080p_inter_cdef_*.ivf,
frame 3; and config 3, bench_cache/e2e_1080p_10bit_grain_lr_*.ivf, frame
2) through ``Decoder(Settings(device="cuda"))`` up to frame N, keeps that
frame's filter program (the plane-input ``FrameProgram`` that
``models/filters.apply_inloop_filters`` builds: ``dbk`` and
``dbkrun``, ``snap``, ``cdef``, ``sres``, ``lrw``/``lrs`` and ``out`` records) and replays it
R times on the card. It prints one JSON line a program: its records by
kind, the eager (aten) ops one replay issues, by the family that issued
them (each ``ops/`` function the executor calls, each kernel wrapper,
"executor" for the rest), the wall ms of each synchronized replay, and
the device time of the kernels one replay runs (torch.profiler), summed
and by kernel name.

``chip_smoke.py`` keeps its filter programs during its decodes with
``is_filter_program`` and counts and profiles their replays with
``family_ops`` and ``device_ms``; this command does the same for one
stream's frame, on its own.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir)
DEFAULTS = (("config 2", "bench_cache/e2e_1080p_inter_cdef_727de0883e7e.ivf",
             3),
            ("config 3",
             "bench_cache/e2e_1080p_10bit_grain_lr_6d42abf87190.ivf", 2))
FILTER_KINDS = ("dbk", "cdef", "sres", "lrw", "lrs")


def is_filter_program(sig):
    """Whether a program signature (``models/frame_exec``) is a frame's
    filter program: plane inputs and a filter record."""
    return bool(sig[6]) and any(r[0] in FILTER_KINDS for r in sig[0])


def keep_filter_program(stream, frame):
    """The execute_program arguments of frame `frame`'s filter program in
    a decode of `stream` on the card."""
    from .. import api
    from ..host.ivf import parse_ivf
    from ..models import frame_exec
    kept = {}
    at = [-1]
    orig = frame_exec.execute_program

    def spy(sig, *args):
        if at[0] == frame and is_filter_program(sig):
            kept.setdefault("program", (sig,) + args)
        return orig(sig, *args)
    with open(stream, "rb") as f:
        _, _, _, frames = parse_ivf(f.read())
    frame_exec.execute_program = spy
    try:
        dec = api.Decoder(api.Settings(device="cuda", apply_grain=False))
        for i, fr in enumerate(frames[:frame + 1]):
            at[0] = i
            dec.send_data(fr.data)
            while dec.get_picture() is not None:
                pass
    finally:
        frame_exec.execute_program = orig
    if "program" not in kept:
        raise SystemExit(f"{stream}: frame {frame} ran no filter program")
    return kept["program"]


def family_ops(frame_exec, wrapped, run):
    """run() under a dispatch mode that gives each aten op to the function
    it ran in: each ops/ function frame_exec calls, each of `wrapped`
    ((module, name) pairs), "executor" for the rest. Returns {family:
    ops}."""
    from torch.utils._python_dispatch import TorchDispatchMode
    stack = ["executor"]
    tally = {}

    class FamilyCount(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            tally[stack[-1]] = tally.get(stack[-1], 0) + 1
            return func(*args, **(kwargs or {}))

    def wrap(fn, name):
        def inner(*a, **k):
            stack.append(name)
            try:
                return fn(*a, **k)
            finally:
                stack.pop()
        return inner
    targets = [(frame_exec, n) for n, o in vars(frame_exec).items()
               if callable(o) and not isinstance(o, type) and
               getattr(o, "__module__", "").startswith(
                   "dav1d_mirror_tpu_torch.ops")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in targets + wrapped]
    for mod, n, fn in saved:
        setattr(mod, n, wrap(fn, n))
    try:
        with FamilyCount():
            run()
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    return tally


def device_ms(run, reps=5):
    """(summed device ms of the kernels one run() launches, {kernel name:
    device ms}), from the second of two profiled steps, each `reps`
    runs, over reps: the first step warms the tracer up (kernels at the
    start of a trace can go unrecorded), and a step of one short run
    (a millisecond of host time) can record no kernel at all in a
    process that has profiled before. The step's own range
    ("ProfilerStep#n", which spans its kernels) is not a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    got = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.append(p.key_averages())) \
            as prof:
        for _ in range(2):
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            prof.step()
    by = {e.key: e.self_device_time_total / 1e3 / reps
          for e in got[0] if e.device_type == DeviceType.CUDA and
          not e.key.startswith("ProfilerStep")}
    return sum(by.values()), dict(sorted(by.items(), key=lambda kv: -kv[1]))


def measure(label, stream, frame, reps):
    """Frame `frame`'s filter program of `stream`, replayed `reps` times
    on the card: the JSON line the module's docstring describes."""
    from ..models import frame_exec
    sig, *args = keep_filter_program(stream, frame)
    kinds = {}
    for rec in sig[0]:
        kinds[rec[0]] = kinds.get(rec[0], 0) + 1

    def run():
        return frame_exec.execute_program(sig, *args)
    run()
    torch.cuda.synchronize()
    wall = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    fams = family_ops(frame_exec, _wrappers(), run)
    dev_ms, by_kernel = device_ms(run)
    return dict(program=f"{label} frame {frame}", stream=stream,
                records=kinds, eager_ops=sum(fams.values()),
                ops_by_family=dict(sorted(fams.items(),
                                          key=lambda kv: -kv[1])),
                wall_ms=wall, device_ms=dev_ms,
                device_ms_by_kernel=by_kernel)


def _wrappers():
    """(module, name) of every kernel wrapper the executor calls."""
    from ..ops import (cdef_cuda, deblock_cuda, itx_cuda, mc_cuda, mcu_cuda,
                       tools_cuda)
    return [(mc_cuda, "mc_hplanes"), (mc_cuda, "mc_unit_batch_hv"),
            (mcu_cuda, "mc_units_run"), (mcu_cuda, "mc_scaled_run"),
            (itx_cuda, "itx_run"), (deblock_cuda, "deblock_frame"),
            (cdef_cuda, "cdef_frame")] + [
        (tools_cuda, n) for n in ("warp_run", "comp_run", "obmc_run")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stream", help="an IVF stream (default: config 2 "
                    "frame 3 and config 3 frame 2)")
    ap.add_argument("--frame", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("filter_ops: torch.cuda is not available", file=sys.stderr)
        return 1
    todo = [("stream", opts.stream, opts.frame)] if opts.stream else \
        [(lb, os.path.join(HERE, s), f) for lb, s, f in DEFAULTS]
    print(f"device {torch.cuda.get_device_name(0)}")
    for label, stream, frame in todo:
        print(json.dumps(measure(label, stream, frame, opts.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
