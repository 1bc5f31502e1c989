#!/usr/bin/env python
"""Write the streams of tests/streams_torch/ and print their md5.

    python tools_dev/gen_torch_streams.py [--seed N] [--only NAME]

Run from the repo root. Four streams, all from config 2's own
parameters (bench.E2E_CONFIGS["e2e_1080p_inter_cdef"]: 8-bit 4:2:0, q 80,
switchable tx, deblock and CDEF), made by tests/torch_streams.py:

- e2e_1080p_inter_tools.ivf (build_tools_stream: tests/test_e2e_inter.
  build_stream with random global motion on each inter frame):
  1920x1080, a keyframe and 4 inter frames with order hints, compound
  references (distance weights, wedge and difference-weighted masks),
  local and global warped motion, OBMC and inter-intra;
- lossless_128x64.ivf: 128x64 at q 0, 4 frames (lossless WHT residuals);
- e2e_1080p_superres.ivf (build_superres_stream): 1920x1080, a keyframe
  coded at super-res denominator 16 and 4 inter frames coded at
  denominators 16, 12, none and 9 (coded widths 960, 1280, 1920, 1707),
  with compound references, OBMC and inter-intra;
- e2e_1080p_sharded.ivf (build_sharded_stream): 1920x1080, one tile, a
  keyframe and 4 inter frames whose every block is inter: single-reference
  translational, or compound average or distance-weighted, which is the
  scope of the sharded inter decode (parallel/tile_decode.py).

Each is decoded by the JAX package's host reference path
(Settings(use_tpu_inter=False, use_tpu_filters=False)); its md5 is
printed, with the count of each block family of the inter frames, and
for the super-res stream the coded width of each frame and the count of
scaled puts, scaled compound sides and scaled OBMC laps by horizontal
step. The tools stream's seed must give every family at least one
block, the super-res stream's every kind of scaled MC, and the sharded
stream's both compound kinds with no block outside the sharded inter
decode's scope: the script fails otherwise. ``--only`` writes one of them.
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


# block kinds of the sharded stream's inter frames; both compound kinds
# must occur
SHARDED_KINDS = ("single-ref", "avg", "dist-weighted")


def _sharded_kinds(fhdr, coders, counts):
    """Tally the block kinds of one inter frame and count, as "outside",
    the blocks the sharded inter decode refuses (parallel/tile_decode.py
    :305 of the JAX package: intra, OBMC / warp, inter-intra, masked
    compound, a warping global motion)."""
    from dav1d_mirror_tpu.models.ref_decoder import _gmv_warp_params
    from dav1d_mirror_tpu.host.tilecoder import T_BLOCK_DIM
    for c in coders:
        for b in c.blocks:
            bw4, bh4 = (int(v) for v in T_BLOCK_DIM[b.bs][:2])
            kind = {0: "single-ref", 1: "dist-weighted",
                    2: "avg"}.get(b.comp_type)
            outside = (b.intra or b.motion_mode or b.interintra_type or
                       kind is None)
            if b.comp_type and b.inter_mode == 6:
                outside |= any(_gmv_warp_params(fhdr, b.ref[i], False)
                               is not None for i in (0, 1))
            if not b.comp_type and b.inter_mode == 2 and \
                    fhdr.gmv[b.ref[0]].type > 1 and min(bw4, bh4) > 1:
                outside = True
            kind = "outside" if outside else kind
            counts[kind] = counts.get(kind, 0) + 1


# kinds of scaled MC the super-res stream must contain
SCALED = ("scaled put", "scaled comp side", "scaled obmc lap")


def reference_md5(data):
    """(md5, frames, family counts) from the JAX host reference path. The
    counts also hold the coded widths ("widths") and the scaled MC calls
    by kind and horizontal step ("scaled put step 2048", ...)."""
    import dav1d_mirror_tpu.api as japi
    from dav1d_mirror_tpu.models import ref_decoder as rd
    from dav1d_mirror_tpu.output import MD5Muxer
    from dav1d_mirror_tpu.host.ivf import parse_ivf
    counts = {"widths": []}
    orig = rd.recon_frame, rd._mc_scaled, rd._obmc
    in_obmc = [False]

    def spy(seq, fhdr, coders, *args, **kw):
        counts["widths"].append(fhdr.width[0])
        if fhdr.frame_type not in (0, 2):
            _families(fhdr, coders, counts)
            _sharded_kinds(fhdr, coders, counts)
        return orig[0](seq, fhdr, coders, *args, **kw)

    def spy_scaled(*args):
        prep, step = args[-1], args[-2]
        kind = ("scaled obmc lap" if in_obmc[0] else
                "scaled comp side" if prep else "scaled put")
        k = f"{kind} step {step[0]}"
        counts[k] = counts.get(k, 0) + 1
        counts[kind] = counts.get(kind, 0) + 1
        return orig[1](*args)

    def spy_obmc(*args):
        in_obmc[0] = True
        try:
            return orig[2](*args)
        finally:
            in_obmc[0] = False

    rd.recon_frame, rd._mc_scaled, rd._obmc = spy, spy_scaled, spy_obmc
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
        rd.recon_frame, rd._mc_scaled, rd._obmc = orig
    return mux.digest(), mux.n, counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    import torch_streams as ts
    ap.add_argument("--seed", type=int, default=ts.TOOLS_SEED,
                    help=f"seed of the tools stream (default "
                         f"{ts.TOOLS_SEED})")
    ap.add_argument("--only", default=None,
                    help="write only this stream (a file name)")
    opts = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")

    os.makedirs(ts.DIR, exist_ok=True)
    jobs = (("e2e_1080p_inter_tools.ivf",
             lambda: ts.build_tools_stream(ts.TOOLS, opts.seed)),
            ("lossless_128x64.ivf",
             lambda: ts.build_tools_stream(ts.LOSSLESS, ts.LOSSLESS_SEED,
                                           False)),
            ("e2e_1080p_superres.ivf",
             lambda: ts.build_superres_stream(ts.SUPERRES,
                                              ts.SUPERRES_SEED)),
            ("e2e_1080p_sharded.ivf",
             lambda: ts.build_sharded_stream(ts.SHARDED, ts.SHARDED_SEED)))
    ok = True
    for name, build in jobs:
        if opts.only and name != opts.only:
            continue
        _, data, n = build()
        with open(ts.DIR / name, "wb") as f:
            f.write(data)
        md5, n_pics, counts = reference_md5(data)
        assert n_pics == n, (name, n_pics, n)
        print(f"{name}: {len(data)} bytes, {n_pics} frames, "
              f"file md5 {hashlib.md5(data).hexdigest()}")
        print(f"  families: " + ", ".join(
            f"{k} {counts.get(k, 0)}" for k in FAMILIES))
        print(f"  decoded md5 {md5}")
        if name.startswith("e2e_1080p_superres"):
            print(f"  coded widths {counts['widths']}")
            print("  " + ", ".join(f"{k} {v}" for k, v in sorted(
                counts.items()) if k.startswith("scaled")))
            missing = [k for k in SCALED if not counts.get(k)]
            if missing:
                print(f"  MISSING scaled MC: {missing}")
                ok = False
        elif name.startswith("e2e_1080p_sharded"):
            print("  kinds: " + ", ".join(
                f"{k} {counts.get(k, 0)}" for k in
                SHARDED_KINDS + ("outside",)))
            if counts.get("outside") or not (counts.get("avg") and
                                             counts.get("dist-weighted")):
                print("  OUT OF SCOPE: a block outside the sharded inter "
                      "decode, or a compound kind missing")
                ok = False
        elif name.startswith("e2e_1080p"):
            missing = [k for k in FAMILIES if not counts.get(k)]
            if missing:
                print(f"  MISSING families: {missing}")
                ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
