"""The traced run's two stretches and what they record.

The stage stretch turns on the decoder's own stage spans
(``dav1d_mirror_tpu_torch.utils.trace``: host-entropy, plan, device,
host-pass2, filters, grain, download), each of which synchronises the
card on exit. The profile stretch runs with them off, under
``torch.profiler``, with an annotation around each call into a layer of
the decoder made from the benchmark's side (``layer_spans``), so that no
synchronisation of a stage counts as idle time on the card.
``summarize`` reduces the profiler's trace to device busy time, kernels,
the kernels launched inside the filters' annotation, and the idle gaps
by what the host was doing.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

PREFIX = "bench."
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _wrap(fn, name, record_function):
    def wrapped(*args, **kw):
        with record_function(PREFIX + name):
            return fn(*args, **kw)
    return wrapped


@contextlib.contextmanager
def layer_spans():
    """Annotate the decoder's layers for the profiler while inside: the
    functions ``api.Decoder`` calls for each stage are replaced, for the
    duration, by the same function inside a ``record_function`` range of
    the stage's name."""
    from torch.profiler import record_function
    from dav1d_mirror_tpu_torch import api
    from dav1d_mirror_tpu_torch.host import native_tile
    targets = [(api, "build_frame_program", "plan"),
               (api, "build_intra_frame", "plan"),
               (api, "execute_frame_program", "device"),
               (api, "run_intra_frame", "device"),
               (api, "apply_inloop_filters", "filters"),
               (api, "download_planes", "download"),
               (api, "apply_film_grain", "grain"),
               (native_tile, "code_tile_native", "host-entropy")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    try:
        for mod, attr, name in targets:
            setattr(mod, attr, _wrap(getattr(mod, attr), name,
                                     record_function))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def span(name):
    from torch.profiler import record_function
    return record_function(PREFIX + name)


@contextlib.contextmanager
def profiled(trace_path: str):
    """torch.profiler over the block, its chrome trace written to
    `trace_path`; the block runs inside the ``bench.window`` annotation
    and ``layer_spans``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with layer_spans(), span("window"):
            yield
    prof.export_chrome_trace(trace_path)


def warm_profiler():
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) is paid in set-up and not in the window."""
    import torch
    with tempfile.TemporaryDirectory() as d:
        with profiled(os.path.join(d, "warm.json")):
            if torch.cuda.is_available():
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()


@dataclass
class Profile:
    window_s: float
    busy_s: float                 # union of device operations
    kernels: int
    kernel_s: float
    filters_calls: int            # filter chains run in the window
    filters_kernel_s: float       # kernels launched inside them
    device_ops: list = field(default_factory=list)   # [[name, s]] top 10
    idle_gaps: list = field(default_factory=list)    # [[host span, s]]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _containing(spans_by_tid, tid, t):
    """Whether t lies in one of the sorted, disjoint spans of `tid`."""
    starts, ends = spans_by_tid.get(tid, ((), ()))
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def summarize(events: list) -> Profile | None:
    """The profile of a chrome trace's events (``traceEvents``), within
    the ``bench.window`` annotation; None without that annotation."""
    win = [e for e in events if e.get("ph") == "X" and
           e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, launches, annots = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
            if b > a:
                dev.append((a, b, e))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat == "user_annotation" and e["name"].startswith(PREFIX) \
                and e["name"] != WINDOW:
            annots.append(e)
    filt = {}
    for e in sorted((e for e in annots if e["name"] == PREFIX + "filters"),
                    key=lambda e: float(e["ts"])):
        s, t = filt.setdefault(e["tid"], ([], []))
        s.append(float(e["ts"]))
        t.append(float(e["ts"]) + float(e["dur"]))
    by_name, n_kernels, kernel_us, filters_us = {}, 0, 0.0, 0.0
    for a, b, e in dev:
        name = e["name"][:120]
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if e["cat"] != "kernel":
            continue
        n_kernels += 1
        kernel_us += b - a
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None and _containing(filt, launch["tid"],
                                              float(launch["ts"])):
            filters_us += b - a
    busy = _merge([(a, b) for a, b, _ in dev])
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    # each gap goes to the innermost annotation open at its middle, on
    # any thread: a sweep over the annotations in order of start
    idle, active, nxt = {}, [], 0
    annots.sort(key=lambda e: float(e["ts"]))
    for a, b in gaps:
        mid = (a + b) / 2
        while nxt < len(annots) and float(annots[nxt]["ts"]) <= mid:
            active.append(annots[nxt])
            nxt += 1
        active = [e for e in active
                  if float(e["ts"]) + float(e["dur"]) >= mid]
        name = (min(active, key=lambda e: float(e["dur"]))["name"]
                [len(PREFIX):] if active else "other host work")
        idle[name] = idle.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Profile(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernels=n_kernels, kernel_s=kernel_us * 1e-6,
        filters_calls=sum(1 for e in annots
                          if e["name"] == PREFIX + "filters" and
                          w0 <= float(e["ts"]) <= w1),
        filters_kernel_s=filters_us * 1e-6,
        device_ops=[[n, s * 1e-6] for n, s in top],
        idle_gaps=[[n, s * 1e-6] for n, s in
                   sorted(idle.items(), key=lambda kv: -kv[1])[:10]])


def read_trace(path: str) -> Profile | None:
    with open(path) as f:
        return summarize(json.load(f).get("traceEvents", []))
