#!/usr/bin/env python3
"""Smoke test of dav1d_mirror_tpu_torch on one CUDA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. It

1. builds the package's kernels (both CUDA sources, one nvcc each, side by
   side) and its native host library from the checkout's sources;
2. decodes the 9-frame 1080p 8-bit inter + deblock + CDEF stream
   (bench_cache/e2e_1080p_inter_cdef_727de0883e7e.ivf) through
   ``Decoder(Settings(device="cuda"))``, asserts its md5, and asserts that
   both kernel launch counters moved during that decode;
3. runs each kernel's wrapper on the card at the shapes the decode gave
   it, for bit depths 8/10/12, all four unit sizes, put and prep, and
   requires ``torch.equal`` with the kernel's plain PyTorch version, then
   times kernel and plain version with CUDA events;
4. prints the kernel table, the decode's per-frame times and stage split,
   one JSON line of kernel numbers, the card's name and power limit, and
   as the last line the device JSON.

With ``--profile DIR`` it also writes a torch.profiler table of two
steady inter frames to DIR. Any failure raises: the script then exits
non-zero and prints no result. Without a CUDA device it exits non-zero
before doing anything.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STREAM = os.path.join(HERE, "bench_cache",
                      "e2e_1080p_inter_cdef_727de0883e7e.ivf")
STREAM_MD5 = "383c08fe120aef29ce8709efdab36187"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def build_all():
    """Build the native host library (on import) and the CUDA kernels
    (nvcc with -Xptxas -v, to print registers and spills)."""
    t0 = time.perf_counter()
    from dav1d_mirror_tpu_torch.host import native  # builds on import
    t_native = time.perf_counter() - t0
    from dav1d_mirror_tpu_torch.ops import mc_cuda
    t0 = time.perf_counter()
    logs = mc_cuda.build(["-Xptxas", "-v"])
    t_cuda = time.perf_counter() - t0
    print(f"build: cuda kernels {t_cuda:.2f} s ({', '.join(logs) or 'cached'}),"
          f" native host library {t_native:.2f} s ({native.LIB._name})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


class ShapeLog:
    """Wraps the two kernel wrappers during the decode to record the
    shapes the main path gives them (counts stay the wrappers' own), and
    the program executor to tally the op kinds of each frame."""

    def __init__(self, mc_cuda, frame_exec):
        self.mc_cuda = mc_cuda
        self.frame_exec = frame_exec
        self.hplanes = []   # (R, H, W, C, bd)
        self.vpass = []     # (B, uw, uh, C, H, w_mid, bd)
        self.frame_ops = []  # per frame: {op kind: count}
        self._orig = (mc_cuda.mc_hplanes, mc_cuda.mc_unit_batch_hv,
                      frame_exec.execute_program)

    def on_frame(self, i):
        self.frame_ops.append({})

    def __enter__(self):
        hp, vp, ex = self._orig

        def rec_ex(sig, *args):
            ops = self.frame_ops[-1]
            for rec in sig[0]:
                ops[rec[0]] = ops.get(rec[0], 0) + 1
            return ex(sig, *args)

        def rec_hp(ref_stack, combos, bd):
            self.hplanes.append(tuple(ref_stack.shape) +
                                (combos.shape[0], bd))
            return hp(ref_stack, combos, bd)

        def rec_vp(args, uw, uh, bd, prep):
            self.vpass.append((args[1].shape[0], uw, uh) +
                              tuple(args[0].shape) + (bd,))
            return vp(args, uw, uh, bd, prep)

        self.mc_cuda.mc_hplanes = rec_hp
        self.mc_cuda.mc_unit_batch_hv = rec_vp
        self.frame_exec.execute_program = rec_ex
        return self

    def __exit__(self, *exc):
        (self.mc_cuda.mc_hplanes, self.mc_cuda.mc_unit_batch_hv,
         self.frame_exec.execute_program) = self._orig


def decode(api, MD5Muxer, frames, torch, on_frame=None):
    dec = api.Decoder(api.Settings(device="cuda"))
    mux = MD5Muxer()
    times = []
    for i, fr in enumerate(frames):
        if on_frame is not None:
            on_frame(i)
        t0 = time.perf_counter()
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            mux.write(pic)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return mux.digest(), mux.n, times


def time_ms(torch, fn, warmup, iters):
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def kernel_phase(torch, np, mc, mc_cuda, shapes):
    """Each kernel against its plain version on the card, at the decode's
    shapes, for bd 8/10/12 (and, for the V-pass, the four unit sizes,
    put and prep). Returns the per-kernel rows of the JSON line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    rows = []

    # ---- H-plane kernel: the largest luma call of the decode ----
    R, H, W, C, _ = max(shapes.hplanes, key=lambda s: (s[1] * s[2], s[3]))
    hp_cases = []
    max_err = 0
    timed = None
    for bd in (8, 10, 12):
        refs = torch.from_numpy(rng.integers(
            0, 1 << bd, (R, H, W), dtype=np.int32)).to(dev)
        n_ref = max(1, min(R, 2))   # combos over a couple of references
        combos = np.stack([rng.integers(0, n_ref, C),
                           rng.integers(0, 6, C),
                           rng.integers(1, 16, C)], 1).astype(np.int32)
        combos_t = torch.from_numpy(combos).to(dev)
        got = mc_cuda.mc_hplanes(refs, combos_t, bd)
        want = mc.mc_hplanes(refs, combos_t, bd)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), \
            f"mc_hplanes differs from its plain version at bd {bd}"
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        max_err = max(max_err, err)
        hp_cases.append(f"bd{bd} C={C} {R}x{H}x{W}")
        if bd == 8:
            timed = (refs, combos_t, combos)
    refs, combos_t, combos = timed
    k_ms = time_ms(torch, lambda: mc_cuda.mc_hplanes(refs, combos_t, 8),
                   3, 20)
    p_ms = time_ms(torch, lambda: mc.mc_hplanes(refs, combos_t, 8), 1, 5)
    n_used = len(np.unique(combos[:, 0]))
    hp_bytes = n_used * H * W * 4 + C * 3 * 4 + C * H * (W + 22) * 2
    hp_ops = C * H * (W + 22) * 16
    rows.append(dict(
        name="mc_hplanes", route="cuda",
        source="dav1d_mirror_tpu_torch/csrc/mc_hplanes.cu",
        replaces="dav1d_mirror_tpu/ops/mc_pallas.py:226",
        launches=None, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
        bound_ms=max(hp_bytes / HBM_BYTES_PER_S,
                     hp_ops / CUDA_CORE_OPS_PER_S) * 1e3,
        bound_by=("bytes" if hp_bytes / HBM_BYTES_PER_S >=
                  hp_ops / CUDA_CORE_OPS_PER_S else "operations"),
        library_ms=None, cases=hp_cases,
        shape=f"R={R} H={H} W={W} C={C} bd=8"))

    # ---- V-pass kernel: every unit size the decode used (and the four
    # of 4 and 8 pixels) at its largest decode batch ----
    by_unit = {}
    for B, uw, uh, Cs, Hs, w_mid, _ in shapes.vpass:
        if B > by_unit.get((uw, uh), (0,))[0]:
            by_unit[(uw, uh)] = (B, Cs, Hs, w_mid)
    biggest = max(by_unit.values())
    for unit in ((8, 8), (8, 4), (4, 8), (4, 4)):
        by_unit.setdefault(unit, biggest)
    vp_cases = []
    max_err = 0
    main_unit = max(by_unit, key=lambda u: by_unit[u][0])
    timed = None
    for (uw, uh), (B, Cs, Hs, w_mid) in sorted(by_unit.items()):
        Wd = w_mid - 22
        for bd in (8, 10, 12):
            hstack = torch.from_numpy(rng.integers(
                -(1 << 14), 1 << 14, (Cs, Hs, w_mid),
                dtype=np.int16)).to(dev)
            cols = [rng.integers(0, Cs, B), rng.integers(-40, Hs + 30, B),
                    rng.integers(-15, Wd, B), rng.integers(1, 16, B),
                    rng.integers(0, 3, B)]
            cols = [torch.from_numpy(c.astype(np.int32)).to(dev)
                    for c in cols]
            for prep in (False, True):
                args = (hstack, *cols)
                got = mc_cuda.mc_unit_batch_hv(args, uw, uh, bd, prep)
                want = mc.mc_unit_batch_hv(args, uw, uh, bd, prep)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (
                    f"mc_vpass differs from its plain version: unit "
                    f"{uw}x{uh} bd {bd} prep {prep}")
                max_err = max(max_err, int((got - want).abs().max()))
                vp_cases.append(f"{uw}x{uh} bd{bd} "
                                f"{'prep' if prep else 'put'} B={B}")
                if bd == 8 and not prep:
                    unit_ms = time_ms(torch, lambda: mc_cuda.mc_unit_batch_hv(
                        args, uw, uh, 8, False), 3, 20)
                    print(f"  mc_vpass {uw}x{uh} B={B} bd8 put: "
                          f"{unit_ms:.4f} ms")
                    if (uw, uh) == main_unit:
                        timed = (args, uw, uh, B)
    args, uw, uh, B = timed
    k_ms = time_ms(torch, lambda: mc_cuda.mc_unit_batch_hv(
        args, uw, uh, 8, False), 3, 50)
    p_ms = time_ms(torch, lambda: mc.mc_unit_batch_hv(
        args, uw, uh, 8, False), 2, 20)
    vp_bytes = B * ((uh + 7) * uw * 2 + 5 * 4 + uh * uw * 4)
    vp_ops = B * uh * uw * 16
    rows.append(dict(
        name="mc_vpass", route="cuda",
        source="dav1d_mirror_tpu_torch/csrc/mc_vpass.cu",
        replaces="dav1d_mirror_tpu/ops/mc_pallas.py:41",
        launches=None, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
        bound_ms=max(vp_bytes / HBM_BYTES_PER_S,
                     vp_ops / CUDA_CORE_OPS_PER_S) * 1e3,
        bound_by=("bytes" if vp_bytes / HBM_BYTES_PER_S >=
                  vp_ops / CUDA_CORE_OPS_PER_S else "operations"),
        library_ms=None, cases=vp_cases,
        shape=f"B={B} unit={uw}x{uh} C={args[0].shape[0]} bd=8 put"))
    return rows


def profile_frames(torch, api, MD5Muxer, frames, out_dir):
    """torch.profiler table over two steady inter frames."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    dec = api.Decoder(api.Settings(device="cuda"))
    mux = MD5Muxer()
    for fr in frames[:3]:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            mux.write(pic)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fr in frames[3:5]:
            dec.send_data(fr.data)
            while (pic := dec.get_picture()) is not None:
                mux.write(pic)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    for key in ("cuda_time_total", "cpu_time_total"):
        path = os.path.join(out_dir, f"profile_by_{key}.txt")
        with open(path, "w") as f:
            f.write(ka.table(sort_by=key, row_limit=60))
    print(f"profile: tables written to {out_dir}")
    print(ka.table(sort_by="cuda_time_total", row_limit=15))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also write torch.profiler tables to DIR")
    opts = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    # ---- 1. card and build ----
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    build_all()

    import numpy as np
    from dav1d_mirror_tpu_torch import api
    from dav1d_mirror_tpu_torch.host.ivf import parse_ivf
    from dav1d_mirror_tpu_torch.models import frame_exec
    from dav1d_mirror_tpu_torch.ops import mc, mc_cuda
    from dav1d_mirror_tpu_torch.output import MD5Muxer
    from dav1d_mirror_tpu_torch.utils import stages

    # ---- main path (run first: the kernel phase uses its shapes) ----
    with open(STREAM, "rb") as f:
        _, _, _, frames = parse_ivf(f.read())
    mc_cuda.HPLANES_LAUNCHES = 0
    mc_cuda.VPASS_LAUNCHES = 0
    with ShapeLog(mc_cuda, frame_exec) as shapes:
        digest, n_pics, times = decode(api, MD5Muxer, frames, torch,
                                       shapes.on_frame)
    launches = {"mc_hplanes": mc_cuda.HPLANES_LAUNCHES,
                "mc_vpass": mc_cuda.VPASS_LAUNCHES}
    assert n_pics == len(frames) == 9, (n_pics, len(frames))
    assert digest == STREAM_MD5, f"md5 {digest} != {STREAM_MD5}"
    assert launches["mc_hplanes"] > 0 and launches["mc_vpass"] > 0, \
        launches
    # second pass with the stage split on (it synchronizes per stage)
    stages.reset()
    stages.enabled = True
    digest2, _, times2 = decode(api, MD5Muxer, frames, torch)
    stages.enabled = False
    assert digest2 == STREAM_MD5, f"md5 {digest2} (staged pass)"
    split = stages.seconds()

    # ---- 2. kernel phase ----
    rows = kernel_phase(torch, np, mc, mc_cuda, shapes)
    for r in rows:
        r["launches"] = launches[r["name"]]
        print(f"kernel {r['name']}: equal to plain in "
              f"{len(r['cases'])} cases; at {r['shape']}: "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{r['launches']} launches in the decode")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    table = [{k: r[k] for k in keys} for r in rows]
    print("kernels: " + json.dumps(table))

    # ---- 3. main path report ----
    ms = [t * 1e3 for t in times]
    steady = times[2:]
    print(f"main path: {len(frames)} frames, md5 {digest} (expected "
          f"{STREAM_MD5}), launches {launches}")
    print("frame ms: " + ", ".join(f"{t:.1f}" for t in ms))
    for i, ops in enumerate(shapes.frame_ops):
        print(f"frame {i} ops: " + ", ".join(
            f"{k} {v}" for k, v in sorted(ops.items())))
    print(f"frame 0 (keyframe, cold) {ms[0]:.1f} ms; frame 1 (first "
          f"inter, kernel load) {ms[1]:.1f} ms; steady fps over frames "
          f"2-{len(frames) - 1}: {len(steady) / sum(steady):.3f}")
    total = sum(times2)
    print("stage split (staged pass, %.1f ms total): " % (total * 1e3) +
          ", ".join(f"{k} {v * 1e3:.1f} ms ({100 * v / total:.1f}%)"
                    for k, v in sorted(split.items(),
                                       key=lambda kv: -kv[1])))
    if opts.profile:
        profile_frames(torch, api, MD5Muxer, frames, opts.profile)

    # ---- 4. result lines ----
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
