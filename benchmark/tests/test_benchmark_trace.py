"""The reduction of a profiler trace (harness/trace.summarize) on
hand-written chrome-trace events."""
import os

import pytest

from harness import trace


def X(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events():
    return [
        X("user_annotation", "bench.window", 100, 1000),
        X("user_annotation", "bench.send_data", 100, 600),
        X("user_annotation", "bench.plan", 110, 200),
        X("user_annotation", "bench.filters", 400, 100),
        X("user_annotation", "bench.filters", 800, 100, tid=2),
        X("cuda_runtime", "cudaLaunchKernel", 320, 5, corr=1),
        X("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=2),
        X("cuda_driver", "cuLaunchKernel", 810, 5, tid=2, corr=3),
        X("cuda_runtime", "cudaLaunchKernel", 950, 5, corr=4),
        X("kernel", "exec_kernel", 330, 40, tid=7, corr=1),
        X("kernel", "deblock_frame_kernel", 420, 10, tid=7, corr=2),
        X("kernel", "cdef_frame_kernel", 820, 30, tid=7, corr=3),
        X("gpu_memcpy", "Memcpy DtoH", 860, 20, tid=7),
        # outside the window: clipped away
        X("kernel", "late_kernel", 1090, 50, tid=7, corr=4),
        X("kernel", "early_kernel", 10, 20, tid=7),
    ]


def test_summarize():
    p = trace.summarize(events())
    assert p.window_s == pytest.approx(1000e-6)
    # busy: [330,370] [420,430] [820,850] [860,880] [1090,1100]
    assert p.busy_s == pytest.approx(110e-6)
    assert p.kernels == 4
    assert p.kernel_s == pytest.approx((40 + 10 + 30 + 10) * 1e-6)
    # kernels launched inside the filters' annotations, on their threads
    assert p.filters_calls == 2
    assert p.filters_kernel_s == pytest.approx(40e-6)
    assert p.device_ops[0] == ["exec_kernel", pytest.approx(40e-6)]
    idle = dict(p.idle_gaps)
    assert sum(idle.values()) == pytest.approx(890e-6)
    # [100,330] mid 215 in plan; [370,420] mid 395 in send_data; [430,820]
    # mid 625 in send_data; [850,860] in the filters of thread 2;
    # [880,1090] mid 985: no annotation
    assert idle["filters"] == pytest.approx(10e-6)
    assert idle["plan"] == pytest.approx(230e-6)
    assert idle["send_data"] == pytest.approx(50e-6 + 390e-6)
    assert idle["other host work"] == pytest.approx(210e-6)


def test_no_window_no_profile():
    assert trace.summarize([e for e in events()
                            if e["name"] != "bench.window"]) is None


def test_no_device_events_reads_idle():
    p = trace.summarize([e for e in events() if e["cat"] not in
                         ("kernel", "gpu_memcpy")])
    assert p.busy_s == 0 and p.kernels == 0 and p.filters_kernel_s == 0


def _record(profile, config):
    """A traced run's record with one 1080p 8-bit 4:2:0 picture in each
    stretch."""
    import numpy as np
    from harness import drive, spec
    from harness.record import Record
    planes = (np.zeros((1080, 1920), np.uint8),
              np.zeros((540, 960), np.uint8), np.zeros((540, 960), np.uint8))
    stretches = []
    for t0 in (0.0, 1.0):
        s = drive.Stretch(t0, 1.0)
        s.visits.append(drive.Visit(0, 1, [drive.Picture(
            planes, 8, t0 + 0.5, 0.5, False)], 0.5))
        stretches.append(s)
    cell = spec.Cell("c.serial", 1, config, {})
    return Record(cell, "NVIDIA H100 80GB HBM3", 1.0, stretches, {},
                  profile)


def _roofline():
    from conftest import BENCH
    from harness import spec
    return spec.load_reader(os.path.dirname(BENCH), "filters_roofline_pct")


def test_filters_roofline_from_the_pictures():
    p = trace.Profile(1.0, 0.1, 10, 0.01, filters_calls=4,
                      filters_kernel_s=4 * 2 * 3110400 / 3.35e12 * 10)
    rec = _record(p, {"inloop_filters": ["deblock", "cdef"]})
    assert rec.profile_stretch is rec.stretches[1]
    assert _roofline()(rec) == pytest.approx(10.0)


@pytest.mark.parametrize("calls,filters_s", [(0, 0.0), (4, 0.0)])
def test_filters_roofline_refuses_filters_it_cannot_see(calls, filters_s):
    p = trace.Profile(1.0, 0.1, 10, 0.01, filters_calls=calls,
                      filters_kernel_s=filters_s)
    with pytest.raises(RuntimeError):
        _roofline()(_record(p, {"inloop_filters": ["deblock"]}))
    # a stream that codes no filter has no share to report
    assert _roofline()(_record(p, {})) is None
