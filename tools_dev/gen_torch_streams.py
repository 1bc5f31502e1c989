#!/usr/bin/env python
"""Write the streams of tests/streams_torch/ and print their md5.

    python tools_dev/gen_torch_streams.py [--seed N] [--only NAME]

Run from the repo root. Six streams from config 2's own parameters
(bench.E2E_CONFIGS["e2e_1080p_inter_cdef"]: q 80, switchable tx,
deblock and CDEF; 8-bit 4:2:0 but for the two profile streams), and
seven small format streams, made by tests/torch_streams.py:

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
  scope of the sharded inter decode (parallel/tile_decode.py);
- e2e_1080p_422_12bit.ivf (AV1's Professional profile): the tools
  stream's coding at 12-bit 4:2:2, with loop restoration (switchable on
  Y, self-guided on U, Wiener on V) and film grain with Cb and Cr points
  of their own and a lag-3 auto-regression; its md5 is printed with
  grain and without;
- e2e_1080p_444_10bit.ivf (AV1's High profile): the tools stream's
  coding at 10-bit 4:4:4 with screen-content tools (palette blocks in
  inter frames too);
- the FORMATS streams: 64x64 streams of tests/test_e2e_features.py's
  CONFIGS 0-4 (12-bit, 12-bit 4:4:4, 4:2:2 at 8, 10 and 12 bit) and of
  tests/test_e2e_inter.py's monochrome and palette-on-inter configs.

Each is decoded by the JAX package's host reference path
(Settings(use_tpu_inter=False, use_tpu_filters=False)); its md5 is
printed, with the count of each block family of the inter frames, and
for the super-res stream the coded width of each frame and the count of
scaled puts, scaled compound sides and scaled OBMC laps by horizontal
step. The tools stream's seed must give every family at least one
block, the super-res stream's every kind of scaled MC, and the sharded
stream's both compound kinds with no block outside the sharded inter
decode's scope: the script fails otherwise. Each profile stream must
also hold every family, a sub-8x8 chroma inter block (at 4:2:2 dav1d's
sub-8x8 case, a 4-pixel-wide luma block whose chroma joins its
neighbours'; at 4:4:4 a 4-pixel luma side, whose chroma is 4 pixels), the
Professional stream restoration units of both Wiener and self-guided
kind on Y, and the High stream a palette block in an inter frame.
``--only`` writes one of them.
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


def _format_tools(seq, fhdr, coders, counts):
    """Tally the sub-8x8 chroma inter blocks and the palette blocks of an
    inter frame, and the restoration units of each kind on Y of every
    frame ("lr wiener", "lr sgr")."""
    from dav1d_mirror_tpu.host.tilecoder import T_BLOCK_DIM
    for c in coders:
        for (p, _, _), lr in c.lr_units.items():
            if p == 0 and lr["type"] in (2, 3):
                k = "lr wiener" if lr["type"] == 2 else "lr sgr"
                counts[k] = counts.get(k, 0) + 1
        if fhdr.frame_type in (0, 2):
            continue
        for b in c.blocks:
            bw4, bh4 = (int(v) for v in T_BLOCK_DIM[b.bs][:2])
            if seq.ss_hor or seq.ss_ver:
                sub8 = (bw4 == 1 and seq.ss_hor) or (bh4 == 1 and seq.ss_ver)
            else:
                sub8 = bw4 == 1 or bh4 == 1
            if not b.intra and sub8 and not seq.monochrome:
                counts["sub8x8 chroma"] = counts.get("sub8x8 chroma", 0) + 1
            if b.intra and (b.pal_sz[0] or b.pal_sz[1]):
                counts["inter-frame palette"] = \
                    counts.get("inter-frame palette", 0) + 1


# what each profile stream must hold besides FAMILIES
PROFILE_TOOLS = {"e2e_1080p_422_12bit.ivf": ("sub8x8 chroma", "lr wiener",
                                             "lr sgr"),
                 "e2e_1080p_444_10bit.ivf": ("sub8x8 chroma",
                                             "inter-frame palette")}


# the streams with film grain, whose md5 is also printed without it
GRAIN = ("e2e_1080p_422_12bit.ivf",)


# kinds of scaled MC the super-res stream must contain
SCALED = ("scaled put", "scaled comp side", "scaled obmc lap")


def reference_md5(data, grain=True):
    """(md5, frames, family counts) from the JAX host reference path,
    with film grain or without. The
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
        _format_tools(seq, fhdr, coders, counts)
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
                                         use_tpu_filters=False,
                                         apply_grain=grain))
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
             lambda: ts.build_sharded_stream(ts.SHARDED, ts.SHARDED_SEED)),
            ("e2e_1080p_422_12bit.ivf",
             lambda: ts.build_tools_stream(ts.PRO, ts.PRO_SEED)),
            ("e2e_1080p_444_10bit.ivf",
             lambda: ts.build_tools_stream(ts.HIGH, ts.HIGH_SEED))) + tuple(
        (name, lambda name=name: ts.build_format_stream(name))
        for name in ts.FORMATS)
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
        if name.startswith("e2e_1080p"):
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
            need = PROFILE_TOOLS.get(name, ())
            if need:
                print("  " + ", ".join(f"{k} {counts.get(k, 0)}"
                                       for k in need))
            if name in GRAIN:
                md5_plain = reference_md5(data, grain=False)[0]
                print(f"  decoded md5 without grain {md5_plain}")
            missing = [k for k in FAMILIES + need if not counts.get(k)]
            if missing:
                print(f"  MISSING families: {missing}")
                ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
