#!/usr/bin/env python
"""Write the streams of tests/streams_torch/ and print their md5.

    python tools_dev/gen_torch_streams.py [--seed N]

Run from the repo root. Two streams, both from config 2's own parameters
(bench.E2E_CONFIGS["e2e_1080p_inter_cdef"]: 8-bit 4:2:0, q 80, switchable
tx, deblock and CDEF), made by tests/torch_streams.build_tools_stream
(tests/test_e2e_inter.build_stream with random global motion on each
inter frame):

- e2e_1080p_inter_tools.ivf: 1920x1080, a keyframe and 4 inter frames
  with order hints, compound references (distance weights, wedge and
  difference-weighted masks), local and global warped motion, OBMC and
  inter-intra;
- lossless_128x64.ivf: 128x64 at q 0, 4 frames (lossless WHT residuals).

Each is decoded by the JAX package's host reference path
(Settings(use_tpu_inter=False, use_tpu_filters=False)); its md5 is
printed, with the count of each block family of the inter frames. The
tools stream's seed must give every family at least one block: the
script fails otherwise.
"""
import argparse
import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# block families the tools stream must contain
FAMILIES = ("avg", "dist-weighted", "seg", "wedge", "local warp",
            "global warp", "obmc", "inter-intra")


def _families(fhdr, coders, counts):
    """Tally the block families of one inter frame."""
    from dav1d_mirror_tpu.models.ref_decoder import _gmv_warp_params
    for c in coders:
        for b in c.blocks:
            if b.intra:
                continue
            if b.comp_type:
                # dav1d CompInterType order (tilecoder.COMP_INTER_*)
                fam = {1: "dist-weighted", 2: "avg", 3: "seg",
                       4: "wedge"}[b.comp_type]
                counts[fam] = counts.get(fam, 0) + 1
                if b.inter_mode == 6 and any(
                        _gmv_warp_params(fhdr, b.ref[i], False) is not None
                        for i in (0, 1)):
                    counts["global warp"] = counts.get("global warp", 0) + 1
                continue
            if b.interintra_type:
                counts["inter-intra"] = counts.get("inter-intra", 0) + 1
            if b.motion_mode == 1:
                counts["obmc"] = counts.get("obmc", 0) + 1
            elif b.motion_mode == 2 and b.warp is not None and \
                    b.warp.type > 1:
                counts["local warp"] = counts.get("local warp", 0) + 1
            elif b.inter_mode == 2 and \
                    _gmv_warp_params(fhdr, b.ref[0], False) is not None:
                counts["global warp"] = counts.get("global warp", 0) + 1


def reference_md5(data):
    """(md5, frames, family counts) from the JAX host reference path."""
    import dav1d_mirror_tpu.api as japi
    from dav1d_mirror_tpu.models import ref_decoder as rd
    from dav1d_mirror_tpu.output import MD5Muxer
    from dav1d_mirror_tpu.host.ivf import parse_ivf
    counts = {}
    orig = rd.recon_frame

    def spy(seq, fhdr, coders, *args, **kw):
        if fhdr.frame_type not in (0, 2):
            _families(fhdr, coders, counts)
        return orig(seq, fhdr, coders, *args, **kw)

    rd.recon_frame = spy
    try:
        _, _, _, frames = parse_ivf(data)
        dec = japi.Decoder(japi.Settings(use_tpu_inter=False,
                                         use_tpu_filters=False))
        mux = MD5Muxer()
        for fr in frames:
            dec.send_data(fr.data)
            while (pic := dec.get_picture()) is not None:
                mux.write(pic)
    finally:
        rd.recon_frame = orig
    return mux.digest(), mux.n, counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    import torch_streams as ts
    ap.add_argument("--seed", type=int, default=ts.TOOLS_SEED,
                    help=f"seed of the tools stream (default "
                         f"{ts.TOOLS_SEED})")
    opts = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")

    os.makedirs(ts.DIR, exist_ok=True)
    jobs = (("e2e_1080p_inter_tools.ivf", ts.TOOLS, opts.seed, True),
            ("lossless_128x64.ivf", ts.LOSSLESS, ts.LOSSLESS_SEED, False))
    ok = True
    for name, cfg, seed, gmv in jobs:
        _, data, n = ts.build_tools_stream(cfg, seed, gmv)
        with open(ts.DIR / name, "wb") as f:
            f.write(data)
        md5, n_pics, counts = reference_md5(data)
        assert n_pics == n, (name, n_pics, n)
        print(f"{name}: seed {seed}, {len(data)} bytes, {n_pics} frames, "
              f"file md5 {hashlib.md5(data).hexdigest()}")
        print(f"  families: " + ", ".join(
            f"{k} {counts.get(k, 0)}" for k in FAMILIES))
        print(f"  decoded md5 {md5}")
        if name.startswith("e2e_1080p"):
            missing = [k for k in FAMILIES if not counts.get(k)]
            if missing:
                print(f"  MISSING families: {missing}")
                ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
