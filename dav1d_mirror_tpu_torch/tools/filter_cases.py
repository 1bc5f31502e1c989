"""Synthetic cases of the deblock and CDEF kernels, and their check on the
card.

    python3 -m dav1d_mirror_tpu_torch.tools.filter_cases

The case builders (numpy, from a seed) serve ``chip_smoke.py``'s filter
phase and the CPU tests: deblock planes of luma and chroma at bit depths
8, 10 and 12 in the 4:2:0, 4:2:2 and 4:4:4 layouts and monochrome, with
odd edge counts (padding rows and columns past the edges), random edge
maps and maps where neighbouring 16 px (6 px) edges store into the same
pixels, int8 and int32 maps; single passes on a band's transposed view
behind its halo rows, on a view exactly as wide as its edges (the last
edge's taps clamped) and with edge 0 and 1 active (taps wrapped to the
end of the row); CDEF frames in every layout and bit depth with skipped
64x64 units and odd block counts, CDEF planes from per-block maps with
and without a band's halo rows, and direction searches on high-contrast
planes. Run as a module on a machine with a CUDA card, it holds every
case's kernel result to its plain version's (``torch.equal``) and
prints the count.
"""
from __future__ import annotations

import sys

import numpy as np

# deblock plane shapes: (label, (Hp, Wp), (h4, w4), luma); chroma planes of
# a 64x64 luma frame in each layout, luma with odd edge counts in a
# padded plane
DBK_SHAPES = (("luma", (64, 64), (16, 16), True),
              ("luma odd", (80, 96), (17, 21), True),
              ("chroma 4:2:0", (32, 32), (8, 8), False),
              ("chroma 4:2:0 odd", (40, 48), (9, 11), False),
              ("chroma 4:2:2", (64, 32), (16, 8), False),
              ("chroma 4:4:4", (64, 64), (16, 16), False))
# deblock frames (deblock_frame): (label, luma (Hp, Wp), (h4, w4), chroma
# (Hp, Wp), (h4, w4) or None for monochrome); the last one spans several
# of the frame kernel's 64x64 tiles a plane, with pad rows and columns
DBK_FRAMES = (("4:2:0", (64, 64), (16, 16), (32, 32), (8, 8)),
              ("4:2:0 odd", (80, 96), (17, 21), (40, 48), (9, 11)),
              ("4:2:2", (64, 64), (16, 16), (64, 32), (16, 8)),
              ("4:4:4", (64, 64), (16, 16), (64, 64), (16, 16)),
              ("monochrome", (64, 64), (16, 16), None, None),
              ("4:2:0 tiles", (200, 272), (48, 66), (100, 136), (24, 33)))
# CDEF frames: (label, luma (Hp, Wp), (bh4, bw4), ss_hor, ss_ver, mono)
CDEF_SHAPES = (("4:2:0", (64, 64), (16, 16), 1, 1, False),
               ("4:2:0 odd", (80, 96), (17, 21), 1, 1, False),
               ("4:2:2", (64, 64), (16, 16), 1, 0, False),
               ("4:4:4", (64, 64), (16, 16), 0, 0, False),
               ("monochrome", (64, 64), (16, 16), 0, 0, True))
HALO = 8   # parallel/filter_shard.HALO: the band deblock's halo rows


def smooth_plane(rng, h, w, bd, cell=4, noise=3):
    """Blocky content: flat cell x cell squares plus noise up to `noise`
    (at 8 bits), so that the filters' flatness and activity masks take
    both values; cell=16 with noise=1 is flat enough for the 16 px
    filter to write all six taps of most edges."""
    cells = rng.integers(0, 1 << bd, (-(-h // cell), -(-w // cell)))
    base = np.repeat(np.repeat(cells, cell, 0), cell, 1)[:h, :w]
    lo = 0 if noise == 1 else -noise
    noise = rng.integers(lo, noise + 1, (h, w)) << (bd - 8)
    return np.clip(base + noise, 0, (1 << bd) - 1).astype(np.int32)


def lf_luts(sharpness):
    """(e_lut, i_lut) int32 of a sharpness (ops/spec_consts.calc_eih)."""
    from ..ops.spec_consts import calc_eih
    return calc_eih(sharpness)


def content(rng, h, w, bd, kind):
    """A plane for maps of `kind` (lf_maps): blocky for "random", flat
    16x16 cells for "conflict", where neighbouring wide edges then both
    store."""
    if kind == "conflict":
        return smooth_plane(rng, h, w, bd, cell=16, noise=1)
    return smooth_plane(rng, h, w, bd)


def lf_maps(rng, h4, w4, luma, kind):
    """(edge class map, level map, fallback level map) int32: "random"
    classes and levels, or "conflict": every edge the widest class at a
    high level, so neighbouring edges store into the same pixels."""
    top = 2 if luma else 1
    if kind == "random":
        edge = rng.integers(-1, top + 1, (h4, w4))
        lvl = rng.integers(0, 64, (h4, w4))
    else:
        edge = np.where(rng.random((h4, w4)) < 0.9, top,
                        rng.integers(-1, top, (h4, w4)))
        lvl = rng.integers(32, 64, (h4, w4))
    prev = rng.integers(0, 64, (h4, w4))
    return tuple(a.astype(np.int32) for a in (edge, lvl, prev))


def deblock_plane_cases(rng):
    """[(label, kwargs of ops/loopfilter.deblock_plane as numpy arrays)]:
    every shape of DBK_SHAPES at bd 8/10/12 with random and conflicting
    maps; int8 maps in every second case (the executor's narrow side
    buffer); LUTs int32."""
    out = []
    for label, (Hp, Wp), (h4, w4), luma in DBK_SHAPES:
        for bd in (8, 10, 12):
            for kind in ("random", "conflict"):
                ev, lv, lvp = lf_maps(rng, h4, w4, luma, kind)
                eh, lh, lhp = lf_maps(rng, h4, w4, luma, kind)
                narrow = len(out) % 2 == 1
                maps = [m.astype(np.int8) if narrow else m
                        for m in (ev, eh, lv, lvp, lh, lhp)]
                e_lut, i_lut = lf_luts(int(rng.integers(0, 8)))
                out.append((f"deblock_plane {label} {Hp}x{Wp} h4={h4} "
                            f"w4={w4} bd{bd} {kind} maps "
                            f"{'int8' if narrow else 'int32'}", dict(
                                plane=content(rng, Hp, Wp, bd, kind),
                                edge_v=maps[0], edge_h=maps[1],
                                lvl_v=maps[2], lvl_v_prev=maps[3],
                                lvl_h=maps[4], lvl_h_prev=maps[5],
                                e_lut=e_lut, i_lut=i_lut, luma=luma,
                                bitdepth=bd)))
    return out


def deblock_frame_cases(rng):
    """[(label, kwargs of ops/loopfilter.deblock_frame as numpy arrays)]:
    every frame of DBK_FRAMES at bd 8/10/12 with random and conflicting
    maps, and "wrap": conflicting maps with 16 px luma edges at x = 4 and
    y = 4, whose p taps and stores wrap to the plane's last columns and
    rows, the luma plane's sides of edge 1 flat a step apart; int8 maps in every second case (the executor's narrow side
    buffer); LUTs int32."""
    out = []
    for label, lshape, l4, cshape, c4 in DBK_FRAMES:
        shapes = [(lshape, l4, True)] + ([(cshape, c4, False)] * 2
                                         if cshape else [])
        for bd in (8, 10, 12):
            for kind in ("random", "conflict", "wrap"):
                mk = "conflict" if kind == "wrap" else kind
                narrow = len(out) % 2 == 1
                kw = dict(planes=[], edge_v=[], edge_h=[], lvl_v=[],
                          lvl_h=[])
                for (Hp, Wp), (h4, w4), luma in shapes:
                    ev, lv, _ = lf_maps(rng, h4, w4, luma, mk)
                    eh, lh, _ = lf_maps(rng, h4, w4, luma, mk)
                    plane = content(rng, Hp, Wp, bd, mk)
                    if kind == "wrap" and luma:
                        # edge 1's 16 px filter reads the last 3 columns
                        # (rows) as p4..p6 and stores p4 and p5 into the
                        # last two: flat p and q sides a step apart, so
                        # that it writes new values there
                        ev[:, 1] = eh[1, :] = 2
                        step = np.minimum(plane[:, :1] + (8 << (bd - 8)),
                                          (1 << bd) - 1)
                        plane[:, :4] = plane[:, Wp - 3:] = plane[:, :1]
                        plane[:, 4:11] = step
                        step = np.minimum(plane[:1] + (8 << (bd - 8)),
                                          (1 << bd) - 1)
                        plane[:4] = plane[Hp - 3:] = plane[:1]
                        plane[4:11] = step
                    kw["planes"].append(plane)
                    for k, m in (("edge_v", ev), ("edge_h", eh),
                                 ("lvl_v", lv), ("lvl_h", lh)):
                        kw[k].append(m.astype(np.int8) if narrow else m)
                kw["e_lut"], kw["i_lut"] = lf_luts(int(rng.integers(0, 8)))
                kw["bitdepth"] = bd
                out.append((f"deblock_frame {label} {lshape[0]}x{lshape[1]}"
                            f" bd{bd} {kind} maps "
                            f"{'int8' if narrow else 'int32'}", kw))
    return out


def deblock_pass_cases(rng):
    """[(label, plane, view builder, kwargs of ops/loopfilter._apply_pass,
    transposed)]: the view builder maps the plane's tensor to the view the
    pass runs on (a band's transpose behind HALO rows, base = HALO, its
    maps read as transposed views (`transposed`); a view exactly 4 n_e
    wide; edges 0 and 1 active so their p taps wrap)."""
    out = []
    for luma in (True, False):
        for bd in (8, 10, 12):
            e_lut, i_lut = lf_luts(int(rng.integers(0, 8)))
            # a band: (HALO + 4 nb) rows, its H pass on ext.T[:4 w4]
            nb, w4 = 5, 13
            ext = content(rng, HALO + 4 * nb, 4 * w4 + 12, bd, "conflict")
            eh, lh, lhp = lf_maps(rng, nb, w4, luma, "conflict")
            eh[0] = 2 if luma else 1   # the band's top edge reads its halo
            out.append((f"apply_pass band H pass base {HALO} "
                        f"{'luma' if luma else 'chroma'} bd{bd}",
                        ext, lambda t, w4=w4: t.T[:4 * w4],
                        dict(edge_idx=eh, lvl_cur=lh, lvl_prev=lhp,
                             e_lut=e_lut, i_lut=i_lut, luma=luma,
                             bitdepth=bd, base=HALO), True))
            # exactly 4 n_e wide, edges 0 and 1 active (wrapped taps)
            for kind in ("random", "conflict"):
                n_er, n_e = 6, 9
                rows = content(rng, 4 * n_er, 4 * n_e, bd, kind)
                ev, lv, lvp = lf_maps(rng, n_er, n_e, luma, kind)
                ev[:, :2] = 2 if luma else 1
                out.append((f"apply_pass V pass {4 * n_e} wide, edges 0-1 "
                            f"active, {kind} {'luma' if luma else 'chroma'} "
                            f"bd{bd}", rows, lambda t: t,
                            dict(edge_idx=ev, lvl_cur=lv, lvl_prev=lvp,
                                 e_lut=e_lut, i_lut=i_lut, luma=luma,
                                 bitdepth=bd, base=0), False))
    return out


def cdef_frame_cases(rng):
    """[(label, kwargs of ops/cdef.cdef_frame as numpy arrays)]: every
    layout of CDEF_SHAPES at bd 8/10/12 (damping 3..6 + bd - 8), a
    skipped 64x64 unit (index -1) among coded ones, noskip and strength
    tables random (strength index 0 zero)."""
    out = []
    for label, (Hp, Wp), (bh4, bw4), ssh, ssv, mono in CDEF_SHAPES:
        for bd in (8, 10, 12):
            planes = [smooth_plane(rng, Hp, Wp, bd)]
            if not mono:
                planes += [smooth_plane(rng, Hp >> ssv, Wp >> ssh, bd)
                           for _ in range(2)]
            n64y, n64x = -(-bh4 // 16), -(-bw4 // 16)
            idx = rng.integers(1, 8, (n64y, n64x))
            idx.flat[0] = -1 if idx.size > 1 else idx.flat[0]
            ystr = rng.integers(0, 16, 8) << 2 | rng.integers(0, 4, 8)
            uvstr = rng.integers(0, 16, 8) << 2 | rng.integers(0, 4, 8)
            ystr[0] = uvstr[0] = 0
            out.append((f"cdef_frame {label} {Hp}x{Wp} bh4={bh4} "
                        f"bw4={bw4} bd{bd}", dict(
                            planes=planes, cdef_idx_map=idx.astype(np.int32),
                            noskip4=rng.random((bh4, bw4)) < 0.7,
                            y_strengths=ystr.astype(np.int32),
                            uv_strengths=uvstr.astype(np.int32),
                            damping=int(rng.integers(3, 7)) + bd - 8,
                            bitdepth=bd, ss_hor=ssh, ss_ver=ssv,
                            monochrome=mono)))
    return out


def cdef_plane_cases(rng):
    """[(label, kwargs of ops/cdef.cdef_filter_plane as numpy arrays)]:
    per-block maps at block sizes 8x8, 4x8, 8x4 and 4x4, bd 8/10/12, with
    and without a band's halo rows (real pixels above, MISSING below), in
    a plane larger than the filtered region."""
    out = []
    for bw, bh in ((8, 8), (4, 8), (8, 4), (4, 4)):
        for bd in (8, 10, 12):
            for halo in (False, True):
                hb, wb = 5, 7
                plane = smooth_plane(rng, hb * bh + 6, wb * bw + 10, bd)
                sh = bd - 8
                pri = rng.integers(0, 16, (hb, wb)) << sh
                sec = np.array([0, 1, 2, 4])[rng.integers(0, 4, (hb, wb))]
                act = rng.random((hb, wb)) < 0.8
                if halo:   # the top block row reads the halo rows
                    act[0] = True
                    pri[0] = np.maximum(pri[0], 4 << sh)
                kw = dict(plane=plane, src=plane,
                          dir_map=rng.integers(0, 8, (hb, wb)).astype(
                              np.int32),
                          pri_map=pri.astype(np.int32),
                          sec_map=(sec << sh).astype(np.int32),
                          damping=int(rng.integers(3, 7)) + sh - (bw < 8),
                          active=act,
                          bitdepth=bd, bw=bw, bh=bh)
                if halo:   # the band above continues the region's rows
                    W = plane.shape[1]
                    top = plane[:2] + (rng.integers(-2, 3, (2, W)) << sh)
                    kw["halo"] = (np.clip(top, 0, (1 << bd) - 1).astype(
                        np.int32), np.full((2, W), -32768, np.int32))
                out.append((f"cdef_filter_plane {bw}x{bh} blocks bd{bd}"
                            + (" halo" if halo else ""), kw))
    return out


def cdef_dir_cases(rng):
    """[(label, kwargs of ops/cdef.cdef_dir)]: smooth and high-contrast
    (0 or the bit depth's maximum) planes, bd 8/10/12, odd block
    counts."""
    out = []
    for bd in (8, 10, 12):
        for kind in ("smooth", "contrast"):
            h8, w8 = 9, 13
            if kind == "smooth":
                plane = smooth_plane(rng, 8 * h8 + 4, 8 * w8 + 8, bd)
            else:
                plane = (rng.random((8 * h8 + 4, 8 * w8 + 8)) < 0.5) * \
                    ((1 << bd) - 1)
            out.append((f"cdef_dir {kind} bd{bd} {h8}x{w8} blocks", dict(
                plane=plane.astype(np.int32), h8=h8, w8=w8, bitdepth=bd)))
    return out


def cdef_4k_case(rng):
    """(label, kwargs of ops/cdef.cdef_frame): a 2160x3840 4:2:0 10-bit
    frame with every block active (every 64x64 unit coded, no 4x4
    skipped, every strength index with primary and secondary
    strengths)."""
    bd, (Hp, Wp) = 10, (2160, 3840)
    bh4, bw4 = Hp // 4, Wp // 4
    planes = [smooth_plane(rng, Hp, Wp, bd)] + [
        smooth_plane(rng, Hp >> 1, Wp >> 1, bd) for _ in range(2)]
    idx = rng.integers(0, 8, (-(-bh4 // 16), -(-bw4 // 16)))
    ystr = rng.integers(1, 16, 8) << 2 | rng.integers(1, 4, 8)
    uvstr = rng.integers(1, 16, 8) << 2 | rng.integers(1, 4, 8)
    return (f"cdef_frame 4K 4:2:0 {Hp}x{Wp} bd{bd} every block active",
            dict(planes=planes, cdef_idx_map=idx.astype(np.int32),
                 noskip4=np.ones((bh4, bw4), bool),
                 y_strengths=ystr.astype(np.int32),
                 uv_strengths=uvstr.astype(np.int32),
                 damping=int(rng.integers(3, 7)) + bd - 8, bitdepth=bd,
                 ss_hor=1, ss_ver=1, monochrome=False))


def to_torch(v, dev):
    """numpy arrays (also inside dicts, lists and tuples) as tensors on
    dev."""
    import torch
    if isinstance(v, dict):
        return {k: to_torch(x, dev) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    if isinstance(v, (list, tuple)):
        return type(v)(to_torch(x, dev) for x in v)
    return v


def check_all(torch, dev, seed=2026):
    """Every synthetic case through the kernel wrappers and the plain
    versions on `dev`: [(label, equal)] (the wrappers' launches counted
    as usual)."""
    from ..ops import cdef, cdef_cuda, deblock_cuda, loopfilter
    rng = np.random.default_rng(seed)
    res = []

    def eq(a, b):
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(map(eq, a, b))
        return torch.equal(a, b)
    for label, kw in deblock_plane_cases(rng):
        a = to_torch(kw, dev)
        src = a["plane"].clone()
        got = deblock_cuda.deblock_plane(**a)
        ok = eq(got, loopfilter.deblock_plane(**a)) and eq(a["plane"], src)
        res.append((label, ok))
    for label, plane, view, kw, transposed in deblock_pass_cases(rng):
        a = to_torch(kw, dev)
        if transposed:
            for k in ("edge_idx", "lvl_cur", "lvl_prev"):
                a[k] = a[k].T
        got, want = to_torch(plane, dev), to_torch(plane, dev)
        deblock_cuda.apply_pass(view(got), **a)
        loopfilter._apply_pass(view(want), **a)
        res.append((label, eq(got, want)))
    for label, kw in cdef_frame_cases(rng):
        a = to_torch(kw, dev)
        a["planes"] = tuple(a["planes"])
        res.append((label, eq(cdef_cuda.cdef_frame(**a),
                              cdef.cdef_frame(**a))))
    for label, kw in cdef_plane_cases(rng):
        a = to_torch(kw, dev)
        res.append((label, eq(cdef_cuda.cdef_filter_plane(**a),
                              cdef.cdef_filter_plane(**a))))
    for label, kw in cdef_dir_cases(rng):
        a = to_torch(kw, dev)
        res.append((label, eq(cdef_cuda.cdef_dir(**a), cdef.cdef_dir(**a))))
    for label, kw in deblock_frame_cases(rng):
        a = to_torch(kw, dev)
        src = [p.clone() for p in a["planes"]]
        got = deblock_cuda.deblock_frame(**a)
        ok = eq(got, loopfilter.deblock_frame(**a)) and eq(a["planes"], src)
        res.append((label, ok))
    label, kw = cdef_4k_case(rng)
    a = to_torch(kw, dev)
    a["planes"] = tuple(a["planes"])
    res.append((label, eq(cdef_cuda.cdef_frame(**a), cdef.cdef_frame(**a))))
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("filter_cases: torch.cuda is not available", file=sys.stderr)
        return 1
    res = check_all(torch, torch.device("cuda"))
    torch.cuda.synchronize()
    bad = [lb for lb, ok in res if not ok]
    for lb in bad:
        print(f"UNEQUAL: {lb}")
    print(f"filter_cases: {len(res) - len(bad)} of {len(res)} cases "
          f"torch.equal with the plain versions on "
          f"{torch.cuda.get_device_name(0)}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
