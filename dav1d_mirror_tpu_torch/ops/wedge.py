# Copied from dav1d_mirror_tpu/ops/ref/wedge.py.
"""Wedge and inter-intra blend masks (dav1d src/wedge.c, built at runtime).

dav1d_init_ii_wedge_masks:212: six 64x64 master wedge templates from three
8-tap border profiles, per-block-size codebooks of 16 (direction, offset)
entries with per-entry master sign, and 2:1-subsampled chroma variants with
sign-dependent rounding. Inter-intra masks: DC (flat 32), and per-size
vertical/horizontal/smooth ramps from a shared 32-entry weight table.
"""
from __future__ import annotations

import numpy as np

(WEDGE_HORIZONTAL, WEDGE_VERTICAL, WEDGE_OBLIQUE27, WEDGE_OBLIQUE63,
 WEDGE_OBLIQUE117, WEDGE_OBLIQUE153) = range(6)

_CB_HGTW = [(WEDGE_OBLIQUE27, 4, 4), (WEDGE_OBLIQUE63, 4, 4),
            (WEDGE_OBLIQUE117, 4, 4), (WEDGE_OBLIQUE153, 4, 4),
            (WEDGE_HORIZONTAL, 4, 2), (WEDGE_HORIZONTAL, 4, 4),
            (WEDGE_HORIZONTAL, 4, 6), (WEDGE_VERTICAL, 4, 4),
            (WEDGE_OBLIQUE27, 4, 2), (WEDGE_OBLIQUE27, 4, 6),
            (WEDGE_OBLIQUE153, 4, 2), (WEDGE_OBLIQUE153, 4, 6),
            (WEDGE_OBLIQUE63, 2, 4), (WEDGE_OBLIQUE63, 6, 4),
            (WEDGE_OBLIQUE117, 2, 4), (WEDGE_OBLIQUE117, 6, 4)]
_CB_HLTW = [(WEDGE_OBLIQUE27, 4, 4), (WEDGE_OBLIQUE63, 4, 4),
            (WEDGE_OBLIQUE117, 4, 4), (WEDGE_OBLIQUE153, 4, 4),
            (WEDGE_VERTICAL, 2, 4), (WEDGE_VERTICAL, 4, 4),
            (WEDGE_VERTICAL, 6, 4), (WEDGE_HORIZONTAL, 4, 4),
            (WEDGE_OBLIQUE27, 4, 2), (WEDGE_OBLIQUE27, 4, 6),
            (WEDGE_OBLIQUE153, 4, 2), (WEDGE_OBLIQUE153, 4, 6),
            (WEDGE_OBLIQUE63, 2, 4), (WEDGE_OBLIQUE63, 6, 4),
            (WEDGE_OBLIQUE117, 2, 4), (WEDGE_OBLIQUE117, 6, 4)]
_CB_HEQW = [(WEDGE_OBLIQUE27, 4, 4), (WEDGE_OBLIQUE63, 4, 4),
            (WEDGE_OBLIQUE117, 4, 4), (WEDGE_OBLIQUE153, 4, 4),
            (WEDGE_HORIZONTAL, 4, 2), (WEDGE_HORIZONTAL, 4, 6),
            (WEDGE_VERTICAL, 2, 4), (WEDGE_VERTICAL, 6, 4),
            (WEDGE_OBLIQUE27, 4, 2), (WEDGE_OBLIQUE27, 4, 6),
            (WEDGE_OBLIQUE153, 4, 2), (WEDGE_OBLIQUE153, 4, 6),
            (WEDGE_OBLIQUE63, 2, 4), (WEDGE_OBLIQUE63, 6, 4),
            (WEDGE_OBLIQUE117, 2, 4), (WEDGE_OBLIQUE117, 6, 4)]

# (w, h, bs_index, codebook, signs); BS indices per dav1d levels.h BlockSize
_FILLS = [
    (32, 32, 7, _CB_HEQW, 0x7BFB),
    (32, 16, 8, _CB_HLTW, 0x7BEB),
    (32, 8, 9, _CB_HLTW, 0x6BEB),
    (16, 32, 11, _CB_HGTW, 0x7BEB),
    (16, 16, 12, _CB_HEQW, 0x7BFB),
    (16, 8, 13, _CB_HLTW, 0x7BEB),
    (8, 32, 15, _CB_HGTW, 0x7AEB),
    (8, 16, 16, _CB_HGTW, 0x7BEB),
    (8, 8, 17, _CB_HEQW, 0x7BFB),
]

_II_WEIGHTS_1D = np.asarray(
    [60, 52, 45, 39, 34, 30, 26, 22, 19, 17, 15, 13, 11, 10, 8, 7,
     6, 6, 5, 4, 4, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1], np.int32)

# bs -> (w, h) of the II nondc mask buffer per chroma layout idx
# (dav1d wedge.c ASSIGN_NONDC_II_OFFSET)
_II_SIZES = {
    7: ((32, 32), (16, 32), (16, 16)),
    8: ((32, 32), (16, 16), (16, 16)),
    11: ((16, 32), (8, 32), (8, 16)),
    12: ((16, 16), (8, 16), (8, 8)),
    13: ((16, 16), (8, 8), (8, 8)),
    16: ((8, 16), (4, 16), (4, 8)),
    17: ((8, 8), (4, 8), (4, 4)),
}

_state = {}


def _insert_border(dst, src, ctr):
    """dav1d wedge.c insert_border:89 (one 64-entry mask row)."""
    if ctr > 4:
        dst[:ctr - 4] = 0
    lo = max(ctr, 4) - 4
    n = min(64 - ctr, 8)
    s0 = max(4 - ctr, 0)
    dst[lo:lo + n] = src[s0:s0 + n]
    if ctr < 60:
        dst[ctr + 4:] = 64


def _build():
    if _state:
        return
    border = {
        "odd": np.asarray([1, 2, 6, 18, 37, 53, 60, 63], np.uint8),
        "even": np.asarray([1, 4, 11, 27, 46, 58, 62, 63], np.uint8),
        "vert": np.asarray([0, 2, 7, 21, 43, 57, 62, 64], np.uint8),
    }
    master = np.zeros((6, 64, 64), np.uint8)
    for y in range(64):
        _insert_border(master[WEDGE_VERTICAL][y], border["vert"], 32)
    ctr = 48
    for y in range(0, 64, 2):
        _insert_border(master[WEDGE_OBLIQUE63][y], border["even"], ctr)
        _insert_border(master[WEDGE_OBLIQUE63][y + 1], border["odd"],
                       ctr - 1)
        ctr -= 1
    master[WEDGE_OBLIQUE27] = master[WEDGE_OBLIQUE63].T
    master[WEDGE_HORIZONTAL] = master[WEDGE_VERTICAL].T
    master[WEDGE_OBLIQUE117] = master[WEDGE_OBLIQUE63][:, ::-1]
    master[WEDGE_OBLIQUE153] = master[WEDGE_OBLIQUE27][:, ::-1]

    wedge = {}  # (c, bs, sign) -> list of 16 masks
    for w, hh, bs, cb, signs in _FILLS:
        m444 = []
        c422 = [[None] * 16, [None] * 16]
        c420 = [[None] * 16, [None] * 16]
        s = signs
        for n in range(16):
            sign = s & 1
            s >>= 1
            direction, xoff, yoff = cb[n]
            y0 = 32 - (hh * yoff >> 3)
            x0 = 32 - (w * xoff >> 3)
            blk = master[direction][y0:y0 + hh, x0:x0 + w].astype(np.int32)
            if sign:
                blk = 64 - blk
            m444.append(blk.astype(np.uint8))

            def chroma(luma, csign, ss_ver):
                lu = luma.astype(np.int32)
                sums = lu[:, 0::2] + lu[:, 1::2] + 1
                if ss_ver:
                    sums = sums[0::2] + sums[1::2]
                return ((sums - csign) >> (1 + ss_ver)).astype(np.uint8)

            c422[sign][n] = chroma(blk, 0, 0)
            c422[1 - sign][n] = chroma(blk, 1, 0)
            c420[sign][n] = chroma(blk, 0, 1)
            c420[1 - sign][n] = chroma(blk, 1, 1)
        wedge[(0, bs, 0)] = m444
        wedge[(0, bs, 1)] = m444
        for sgn in (0, 1):
            wedge[(1, bs, sgn)] = c422[sgn]
            wedge[(2, bs, sgn)] = c420[sgn]
    _state["wedge"] = wedge

    ii = {}
    nondc = {}
    for (w, hh, step) in [(32, 32, 1), (16, 32, 1), (16, 16, 2), (8, 32, 1),
                          (8, 16, 2), (8, 8, 4), (4, 16, 2), (4, 8, 4),
                          (4, 4, 8)]:
        ys = _II_WEIGHTS_1D[np.minimum(np.arange(hh) * step, 31)]
        xs = _II_WEIGHTS_1D[np.minimum(np.arange(w) * step, 31)]
        mv = np.repeat(ys[:, None], w, axis=1).astype(np.uint8)
        mh = np.repeat(xs[None, :], hh, axis=0).astype(np.uint8)
        msm = _II_WEIGHTS_1D[np.minimum(np.minimum.outer(
            np.arange(hh), np.arange(w)) * step, 31)].astype(np.uint8)
        nondc[(w, hh)] = (mv, mh, msm)
    dc = np.full((32, 32), 32, np.uint8)
    for bs, sizes in _II_SIZES.items():
        for c in range(3):
            w, hh = sizes[c]
            mv, mh, msm = nondc[(w, hh)]
            ii[(c, bs)] = (dc, mv, mh, msm)
    _state["ii"] = ii


def wedge_mask(c, bs, sign, idx):
    """c: 0=444, 1=422, 2=420 (dav1d chr_layout_idx); returns (h, w)."""
    _build()
    return _state["wedge"][(c, bs, sign)][idx]


def ii_mask(c, bs, interintra_type, interintra_mode, wedge_idx):
    """dav1d wedge.h II_MASK:82. INTER_INTRA_BLEND -> ii ramp masks,
    else the sign-0 wedge mask."""
    _build()
    if interintra_type == 1:  # INTER_INTRA_BLEND
        return _state["ii"][(c, bs)][interintra_mode]
    return _state["wedge"][(c, bs, 0)][wedge_idx]
