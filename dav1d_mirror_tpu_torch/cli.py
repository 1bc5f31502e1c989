# Ported from dav1d_mirror_tpu/cli.py (without its TPU routing flags).
"""Command-line decoder (the analogue of tools/dav1d.c).

    python -m dav1d_mirror_tpu_torch.cli -i in.ivf -o out.yuv --muxer yuv

Options mirror the reference CLI (tools/dav1d_cli_parse.c:69-92): input
probing across ivf/annexb/section5, muxer selection, --verify <hash>,
--limit/--skip, --filmgrain, --inloopfilters, --oppoint, --device for the
torch device of the pixel stage (CUDA by default), --intraengine for the
device intra engine, and fps statistics."""
from __future__ import annotations

import argparse
import sys
import time

from .api import (Decoder, Settings, INLOOPFILTER_ALL,
                  DECODEFRAMETYPE_ALL, DECODEFRAMETYPE_REFERENCE,
                  DECODEFRAMETYPE_INTRA, DECODEFRAMETYPE_KEY)
from .host.demux import container_fps, open_demuxer
from .output import open_muxer


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="dav1d_mirror_tpu_torch",
                                description="AV1 decoder, pixel stage in "
                                            "PyTorch/CUDA")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--muxer", default=None,
                   choices=["null", "md5", "xxh3", "yuv", "y4m2"])
    p.add_argument("--verify", metavar="HASH",
                   help="exit non-zero unless the md5/xxh3 of the decoded "
                        "planes matches")
    p.add_argument("--limit", type=int, default=0,
                   help="stop after N frames")
    p.add_argument("--skip", type=int, default=0,
                   help="skip decoding of the first N temporal units")
    p.add_argument("--threads", type=int, default=0,
                   help="Settings.n_threads: > 1 pipelines the decode "
                        "(entropy || build || pixels || download)")
    p.add_argument("--framedelay", type=int, default=0,
                   help="Settings.max_frame_delay: > 1 pipelines the "
                        "decode, with this many frames in flight")
    p.add_argument("--filmgrain", type=int, default=None,
                   help="enable film grain application (default: 1, "
                        "except if muxer is md5 or xxh3, as the reference "
                        "CLI, tools/dav1d_cli_parse.c:143,440)")
    p.add_argument("--oppoint", type=int, default=0)
    p.add_argument("--alllayers", type=int, default=1)
    p.add_argument("--sizelimit", type=int, default=0)
    p.add_argument("--outputinvisible", type=int, default=0)
    p.add_argument("--inloopfilters", default="all",
                   choices=["none", "deblock", "cdef", "restoration",
                            "all"])
    p.add_argument("--decodeframetype", default="all",
                   choices=["all", "reference", "intra", "key"],
                   help="decode and return only this class of frames")
    p.add_argument("--strict", type=int, default=0,
                   help="strict standard compliance")
    p.add_argument("--frametimes", metavar="FILE",
                   help="dump per-frame decode times (one ns value per "
                        "line, like the reference CLI)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the decode to "
                        "DIR/trace.json (chrome://tracing, Perfetto)")
    p.add_argument("--tracestats", action="store_true",
                   help="print per-stage decode timing summary to stderr")
    p.add_argument("--realtime", action="store_true",
                   help="pace output to the container frame rate "
                        "(tools/dav1d.c:93 synchronization)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pixel stage (default: cuda; "
                        "cpu runs it on the host)")
    p.add_argument("--intraengine", dest="intraengine", default=None,
                   action="store_true",
                   help="reconstruct intra blocks with the device intra "
                        "engine (models/intra) (default: off, the hybrid "
                        "route: intra blocks in the native host walk)")
    p.add_argument("--no-intraengine", dest="intraengine",
                   action="store_false",
                   help="the hybrid route (the default)")
    p.add_argument("-q", "--quiet", action="store_true")
    return p.parse_args(argv)


_ILF = {"none": 0, "deblock": 1, "cdef": 2, "restoration": 4,
        "all": INLOOPFILTER_ALL}
_DFT = {"all": DECODEFRAMETYPE_ALL, "reference": DECODEFRAMETYPE_REFERENCE,
        "intra": DECODEFRAMETYPE_INTRA, "key": DECODEFRAMETYPE_KEY}


def main(argv=None):
    args = parse_args(argv)
    if args.verify and not args.muxer:
        args.muxer = "md5"
    if not args.muxer:
        args.muxer = "null" if args.output in ("-", "/dev/null") else "yuv"
    if args.filmgrain is None:
        # dav1d_cli_parse.c:143 — grain off by default for hash muxers
        args.filmgrain = 0 if args.muxer in ("md5", "xxh3") else 1

    with open(args.input, "rb") as f:
        data = f.read()
    name, units = open_demuxer(data)
    fps = container_fps(data)

    settings = Settings(
        n_threads=args.threads,
        max_frame_delay=args.framedelay,
        apply_grain=bool(args.filmgrain),
        operating_point=args.oppoint,
        all_layers=bool(args.alllayers),
        frame_size_limit=args.sizelimit,
        output_invisible_frames=bool(args.outputinvisible),
        inloop_filters=_ILF[args.inloopfilters],
        decode_frame_type=_DFT[args.decodeframetype],
        strict_std_compliance=bool(args.strict),
        device=args.device,
        intra_engine=args.intraengine,
    )
    dec = Decoder(settings)
    mux = open_muxer(args.muxer, args.output, fps=fps)

    from .utils import trace
    if args.tracestats:
        trace.enable()
        trace.reset()

    prof = None
    if args.profile:
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(args.profile, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if dec.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()

    n = 0
    frametimes = [] if args.frametimes else None
    t0 = time.perf_counter()
    for i, obus in enumerate(units):
        if i < args.skip:
            continue
        tu0 = time.perf_counter_ns()
        dec.send_obus(obus)
        while True:
            pic = dec.get_picture()
            if pic is None:
                break
            if args.realtime and fps[0]:
                target = t0 + n * fps[1] / fps[0]
                delay = target - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            mux.write(pic)
            n += 1
            if frametimes is not None:
                frametimes.append(time.perf_counter_ns() - tu0)
                tu0 = time.perf_counter_ns()
        if args.limit and n >= args.limit:
            break
    dec.drain()
    while (pic := dec.get_picture()) is not None:
        mux.write(pic)
        n += 1
    if frametimes is not None:
        with open(args.frametimes, "w") as f:
            f.write("".join(f"{t}\n" for t in frametimes))
    digest = mux.finish()
    dt = time.perf_counter() - t0
    if prof is not None:
        if dec.device.type == "cuda":
            torch.cuda.synchronize(dec.device)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))

    if not args.quiet:
        rate = n / dt if dt else 0.0
        print(f"Decoded {n} frames in {dt:.3f}s ({rate:.2f} fps) "
              f"[{name} container]", file=sys.stderr)
    if args.tracestats:
        trace.report(out=sys.stderr)
        trace.enable(False)

    if args.verify:
        if digest != args.verify.strip().lower():
            print(f"Verification failed: got {digest}, "
                  f"expected {args.verify}", file=sys.stderr)
            return 1
        if not args.quiet:
            print("Verified.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
