#!/usr/bin/env python3
"""Run one benchmark cell of dav1d_mirror_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for. Set-up builds or loads the port's kernels and native library (into
their fixed directories inside the checkout), reads the configuration's
stream pool, opens one ``api.Decoder`` with the traffic's settings and
decodes the first ``WARM_UNITS`` frames of a pool stream to warm up. The window then decodes the pool's
streams in an order drawn from ``--seed`` for ``--seconds``
(harness/drive.py). With ``--trace 1`` the window is two stretches, the
decoder's stage spans on in the first and torch.profiler on in the
last ``PROFILE_S`` seconds (harness/trace.py), and the cell's per-layer
metrics are reported;
with ``--trace 0`` its end-to-end metrics. Every picture the window
returned is then held to the reference decode's plane hashes
(harness/compare.py), and the last line of standard output is one JSON
object: correct, attempted, failed, metrics, device, (breakdown,) checks.

Exits 2, printing no result, without CUDA or with fewer cards than the
cell asks for; 3 if a module of the JAX package or of JAX is loaded at
the end; 1 on any other failure.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)
# the CUDA driver's kernel cache at a fixed path inside the checkout
os.environ["CUDA_CACHE_PATH"] = os.path.join(HERE, ".cache", "cuda")

from harness import compare, drive, pool as pool_mod, spec  # noqa: E402
from harness import trace as trace_mod  # noqa: E402
from harness.record import Record  # noqa: E402

# the traced run's profile stretch: its last PROFILE_S seconds at most
# (half the window if that is shorter), which keeps the profiler's trace
# to a few hundred MB; the stage stretch takes the rest
PROFILE_S = 10.0
# set-up decodes this many frames of a pool stream, a keyframe and inter
# frames, which run every kernel and shape of the window's frames
WARM_UNITS = 9


def warm(dec, stream, delay: int):
    """Decode the first WARM_UNITS frames of a pool stream the way the
    window does."""
    dec.flush()
    taken = 0
    for i, unit in enumerate(stream.units[:WARM_UNITS], 1):
        dec.send_data(unit)
        while i - taken >= delay and dec.get_picture() is not None:
            taken += 1
    dec.drain()
    while dec.get_picture() is not None:
        pass


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else None


def run_cell(root: str, cell: spec.Cell, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None):
    """Set up, measure and check one run of `cell`. Returns (the result
    object, {number compared: (value, limit)})."""
    import torch
    from dav1d_mirror_tpu_torch import api
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")
    if cuda:
        from dav1d_mirror_tpu_torch.ops import cuda_build
        cuda_build.build()
    pool = pool_mod.load_pool(root, cell.config)
    settings = api.Settings(device=device, **cell.traffic["settings"])
    delay = api.get_frame_delay(settings)
    grain_key = "grain" if settings.apply_grain else "nograin"
    dec = api.Decoder(settings)
    warm(dec, pool[0], delay)
    if trace:
        trace_mod.warm_profiler()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec = Record(cell, torch.cuda.get_device_name(0) if cuda else "cpu",
                 time.perf_counter() - t_start)

    order = pool_mod.stream_order(len(pool), seed)
    if not trace:
        rec.stretches = [drive.drive(dec, pool, order, delay, seconds)]
    else:
        from dav1d_mirror_tpu_torch.utils import trace as stage_trace
        profile_s = min(PROFILE_S, seconds / 2)
        stage_trace.reset()
        stage_trace.enable(True)
        try:
            staged = drive.drive(dec, pool, order, delay,
                                 seconds - profile_s)
            rec.stages = {k: t for k, (t, _) in stage_trace.stats().items()}
        finally:
            stage_trace.enable(False)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            with trace_mod.profiled(path):
                profiled = drive.drive(dec, pool, order, delay, profile_s,
                                       span=trace_mod.span)
            rec.profile = trace_mod.read_trace(path)
        rec.stretches = [staged, profiled]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dec.close()
    del dec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = compare.compare(rec.visits(), pool, grain_key)
    limits = {k: (checks[k], lim) for k, lim in compare.LIMITS.items()}
    correct = checks["checked"] > 0 and all(v <= lim for v, lim in
                                            limits.values())
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name, entry in wanted.items():
        value = spec.load_reader(root, name)(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": rec.device_name,
           "count": cell.chips if cuda else 0, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": checks["attempted"],
              "failed": checks["failed_pictures"],
              "metrics": metrics, "device": dev}
    if trace and rec.profile is not None:
        dev["busy_s"] = rec.profile.busy_s
        dev["window_s"] = rec.profile.window_s
        result["breakdown"] = {"device_ops": rec.profile.device_ops,
                               "idle_gaps": rec.profile.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in limits.items()}
    print(f"{cell.name} seed {seed}: setup {rec.setup_s:.3f} s, "
          f"{len(rec.pictures())} pictures in the window, "
          f"{checks['checked']} checked: {checks['wrong_pictures']} "
          f"wrong, {checks['missing_pictures']} missing; device "
          f"{rec.device_name} "
          f"({dev.get('power_limit')})", file=sys.stderr)
    return result, limits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, limits = run_cell(ROOT, cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    bad = compare.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, (v, lim) in limits.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
