# Copied from dav1d_mirror_tpu/host/refmvs.py.
"""Motion-vector reference list construction (host entropy stage).

Behavioral mirror of dav1d src/refmvs.c (dav1d_refmvs_find:348, scan_row:97,
scan_col:136, add_spatial_candidate:41, add_temporal_candidate:193,
mv_projection:175, splat_mv_c:909) and the gmv helpers in src/env.h
(get_gmv_2d:479, fix_mv_precision:468).

Dav1d keeps a 35-row ring of refmvs_block rows per superblock row; here the
tile keeps a full-frame dense array (same semantics: scans are bounded to
<= 3 rows above the current block and never cross tile starts). MV units are
1/8 px, stored as plain ints; INVALID marks intra blocks.
"""
from __future__ import annotations

import numpy as np

from ..data.tables import TABLES

T_BLOCK_DIM = TABLES["block_dimensions"]

INVALID = -32768  # mv.y == mv.x == INVALID <=> dav1d INVALID_MV (0x80008000)

DIV_MULT = [0, 16384, 8192, 5461, 4096, 3276, 2730, 2340,
            2048, 1820, 1638, 1489, 1365, 1260, 1170, 1092,
            1024, 963, 910, 862, 819, 780, 744, 712,
            682, 655, 630, 606, 585, 564, 546, 528]


def iclip(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def apply_sign(v, s):
    return -v if s < 0 else v


def fix_int_mv_precision(mv):
    """dav1d env.h fix_int_mv_precision:461 (round-to-nearest-int px)."""
    y, x = mv
    x = (x - (x >> 15) + 3) & ~7
    y = (y - (y >> 15) + 3) & ~7
    # match C's int16 wraparound semantics
    return (_s16(y), _s16(x))


def _s16(v):
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def fix_mv_precision(hdr, mv):
    """dav1d env.h fix_mv_precision:468."""
    if hdr.force_integer_mv:
        return fix_int_mv_precision(mv)
    if not hdr.hp:
        y, x = mv
        return (_s16((y - (y >> 15)) & ~1), _s16((x - (x >> 15)) & ~1))
    return mv


WM_TYPE_IDENTITY, WM_TYPE_TRANSLATION, WM_TYPE_ROT_ZOOM, WM_TYPE_AFFINE = \
    range(4)


def get_gmv_2d(gm, bx4, by4, bw4, bh4, hdr):
    """dav1d env.h get_gmv_2d:479. gm: headers.WarpedMotionParams."""
    t = gm.type
    if t == WM_TYPE_IDENTITY:
        return (0, 0)
    if t == WM_TYPE_TRANSLATION:
        res = (gm.matrix[0] >> 13, gm.matrix[1] >> 13)
        if hdr.force_integer_mv:
            res = fix_int_mv_precision(res)
        return res
    x = bx4 * 4 + bw4 * 2 - 1
    y = by4 * 4 + bh4 * 2 - 1
    xc = (gm.matrix[2] - (1 << 16)) * x + gm.matrix[3] * y + gm.matrix[0]
    yc = (gm.matrix[5] - (1 << 16)) * y + gm.matrix[4] * x + gm.matrix[1]
    shift = 16 - (3 - (0 if hdr.hp else 1))
    rnd = (1 << shift) >> 1
    res = (apply_sign(((abs(yc) + rnd) >> shift) << (0 if hdr.hp else 1), yc),
           apply_sign(((abs(xc) + rnd) >> shift) << (0 if hdr.hp else 1), xc))
    res = (_s16(res[0]), _s16(res[1]))
    if hdr.force_integer_mv:
        res = fix_int_mv_precision(res)
    return res


def mv_projection(mv, num, den):
    """dav1d refmvs.c mv_projection:175; AV1 spec 7.9.3 round/clip."""
    assert 0 < den < 32 and -32 < num < 32
    frac = num * DIV_MULT[den]
    y = mv[0] * frac
    x = mv[1] * frac
    return (iclip((y + 8192 + (-1 if y < 0 else 0)) >> 14, -0x3FFF, 0x3FFF),
            iclip((x + 8192 + (-1 if x < 0 else 0)) >> 14, -0x3FFF, 0x3FFF))


class TemporalMvs:
    """Per-frame saved 8x8-granularity MVs (dav1d refmvs_temporal_block)."""

    def __init__(self, ih8, w8pad):
        self.mv = np.zeros((ih8, w8pad, 2), np.int16)   # (y, x)
        self.ref = np.zeros((ih8, w8pad), np.uint8)     # 0 = invalid


class RefmvsFrame:
    """Per-frame refmvs context (dav1d refmvs_frame, spatial part).

    r_* arrays are full-frame dense (4x4 granularity): ref (2), mv (2x2),
    bs, mf (bit0: globalmv-candidate, bit1: newmv).
    """

    def __init__(self, fhdr, seq, iw4, ih4, ref_poc=None):
        self.frm_hdr = fhdr
        self.iw8 = (fhdr.width[0] + 7) >> 3
        self.ih8 = (fhdr.height + 7) >> 3
        self.iw4 = self.iw8 << 1
        self.ih4 = self.ih8 << 1
        h4, w4 = ih4, iw4
        self.ref = np.zeros((h4, w4, 2), np.int8)
        self.ref[:, :, 0] = 0
        self.ref[:, :, 1] = -1
        self.mv = np.full((h4, w4, 2, 2), INVALID, np.int16)  # [..,i,(y,x)]
        self.bs = np.zeros((h4, w4), np.uint8)
        self.mf = np.zeros((h4, w4), np.uint8)
        self.n_mfmvs = 0
        self.use_ref_frame_mvs = 0  # temporal MVs wired in later
        self.sign_bias = [0] * 7
        self.pocdiff = [0] * 7
        self.mfmv_sign = [0] * 7
        self.mfmv_ref = []
        self.mfmv_ref2cur = []
        self.mfmv_ref2ref = []
        self.rp_ref = [None] * 7
        # padded 8x8-granularity stride (dav1d rp_stride = r_stride >> 1)
        self.w8pad = ((fhdr.width[0] + 127) & ~127) >> 3
        self.rp = TemporalMvs(self.ih8, self.w8pad)
        self.rp_proj_mv = np.full((ih4 >> 1, self.w8pad, 2), INVALID,
                                  np.int16)
        self.rp_proj_ref = np.zeros((ih4 >> 1, self.w8pad), np.uint8)
        if ref_poc is not None and seq.order_hint:
            # dav1d refmvs.c dav1d_refmvs_init_frame:837-845
            from .obu import get_poc_diff
            nb = seq.order_hint_n_bits
            poc = fhdr.frame_offset
            for i in range(7):
                diff = get_poc_diff(nb, ref_poc[i], poc)
                self.sign_bias[i] = int(diff > 0)
                self.mfmv_sign[i] = int(diff < 0)
                self.pocdiff[i] = iclip(get_poc_diff(nb, poc, ref_poc[i]),
                                        -31, 31)

    def setup_temporal(self, seq, fhdr, ref_poc, ref_ref_poc, rp_ref):
        """dav1d refmvs.c dav1d_refmvs_init_frame:847-892 (motion-field MV
        source selection). rp_ref: 7 TemporalMvs (refidx-resolved) or None;
        ref_ref_poc: 7x7 pocs of each reference's own references."""
        from .obu import get_poc_diff
        self.rp_ref = list(rp_ref)
        self.mfmv_ref = []
        self.mfmv_ref2cur = []
        self.mfmv_ref2ref = []
        nb = seq.order_hint_n_bits
        if not (fhdr.use_ref_frame_mvs and nb):
            self.use_ref_frame_mvs = 0
            return
        total = 2
        if rp_ref[0] is not None and ref_ref_poc[0][6] != ref_poc[3]:
            self.mfmv_ref.append(0)  # last
            total = 3
        if rp_ref[4] is not None and \
                get_poc_diff(nb, ref_poc[4], fhdr.frame_offset) > 0:
            self.mfmv_ref.append(4)  # bwd
        if rp_ref[5] is not None and \
                get_poc_diff(nb, ref_poc[5], fhdr.frame_offset) > 0:
            self.mfmv_ref.append(5)  # altref2
        if len(self.mfmv_ref) < total and rp_ref[6] is not None and \
                get_poc_diff(nb, ref_poc[6], fhdr.frame_offset) > 0:
            self.mfmv_ref.append(6)  # altref
        if len(self.mfmv_ref) < total and rp_ref[1] is not None:
            self.mfmv_ref.append(1)  # last2
        for r in self.mfmv_ref:
            rpoc = ref_poc[r]
            diff1 = get_poc_diff(nb, rpoc, fhdr.frame_offset)
            if abs(diff1) > 31:
                self.mfmv_ref2cur.append(None)  # INT_MIN
                self.mfmv_ref2ref.append([0] * 7)
            else:
                self.mfmv_ref2cur.append(-diff1 if r < 4 else diff1)
                r2r = []
                for m in range(7):
                    diff2 = get_poc_diff(nb, rpoc, ref_ref_poc[r][m])
                    r2r.append(0 if diff2 < 0 or diff2 > 31 else diff2)
                self.mfmv_ref2ref.append(r2r)
        self.use_ref_frame_mvs = int(len(self.mfmv_ref) > 0)

    def save_tmvs_frame(self):
        """dav1d refmvs.h dav1d_refmvs_save_tmvs:140 + save_tmvs_c:763,
        over the whole frame (equivalent to per-sbrow calls since the
        spatial arrays are final)."""
        for y in range(self.ih8):
            x = 0
            while x < self.iw8:
                cy, cx = 2 * y + 1, 2 * x + 1
                bw8 = (int(T_BLOCK_DIM[self.bs[cy, cx]][0]) + 1) >> 1
                r1 = int(self.ref[cy, cx, 1])
                r0 = int(self.ref[cy, cx, 0])
                if r1 > 0 and self.mfmv_sign[r1 - 1] and \
                        (abs(int(self.mv[cy, cx, 1, 0])) |
                         abs(int(self.mv[cy, cx, 1, 1]))) < 4096:
                    mvv, refv = self.mv[cy, cx, 1], r1
                elif r0 > 0 and self.mfmv_sign[r0 - 1] and \
                        (abs(int(self.mv[cy, cx, 0, 0])) |
                         abs(int(self.mv[cy, cx, 0, 1]))) < 4096:
                    mvv, refv = self.mv[cy, cx, 0], r0
                else:
                    mvv, refv = (0, 0), 0
                self.rp.mv[y, x:x + bw8] = mvv
                self.rp.ref[y, x:x + bw8] = refv
                x += bw8

    def load_tmvs_rows(self, col_start8, col_end8, row_start8, row_end8):
        """dav1d refmvs.c load_tmvs_c:690: project reference motion fields
        into rp_proj for one superblock row band."""
        row_end8 = min(row_end8, self.ih8)
        col_start8i = max(col_start8 - 8, 0)
        col_end8i = min(col_end8 + 8, self.iw8)
        self.rp_proj_mv[row_start8:row_end8, col_start8:col_end8] = INVALID
        for n, ref in enumerate(self.mfmv_ref):
            ref2cur = self.mfmv_ref2cur[n]
            if ref2cur is None:
                continue
            ref_sign = ref - 4
            rp = self.rp_ref[ref]
            r2r = self.mfmv_ref2ref[n]
            for y in range(row_start8, row_end8):
                y_sb_align = y & ~7
                y_proj_start = max(y_sb_align, row_start8)
                y_proj_end = min(y_sb_align + 8, row_end8)
                x = col_start8i
                while x < col_end8i:
                    b_ref = int(rp.ref[y, x])
                    if not b_ref:
                        x += 1
                        continue
                    ref2ref = r2r[b_ref - 1]
                    if not ref2ref:
                        x += 1
                        continue
                    b_mv = (int(rp.mv[y, x, 0]), int(rp.mv[y, x, 1]))
                    offy, offx = mv_projection(b_mv, ref2cur, ref2ref)
                    pos_x = x + apply_sign(abs(offx) >> 6,
                                           -offx if ref_sign < 0 else offx)
                    pos_y = y + apply_sign(abs(offy) >> 6,
                                           -offy if ref_sign < 0 else offy)
                    if y_proj_start <= pos_y < y_proj_end:
                        while True:
                            x_sb_align = x & ~7
                            if max(x_sb_align - 8, col_start8) <= pos_x < \
                                    min(x_sb_align + 16, col_end8):
                                self.rp_proj_mv[pos_y, pos_x] = b_mv
                                self.rp_proj_ref[pos_y, pos_x] = ref2ref
                            x += 1
                            if x >= col_end8i:
                                break
                            if int(rp.ref[y, x]) != b_ref or \
                                    (int(rp.mv[y, x, 0]),
                                     int(rp.mv[y, x, 1])) != b_mv:
                                break
                            pos_x += 1
                    else:
                        while True:
                            x += 1
                            if x >= col_end8i:
                                break
                            if int(rp.ref[y, x]) != b_ref or \
                                    (int(rp.mv[y, x, 0]),
                                     int(rp.mv[y, x, 1])) != b_mv:
                                break

    def splat_mv(self, by4, bx4, bw4, bh4, ref0, ref1, mv0, mv1, bs, mf):
        """dav1d refmvs.c splat_mv_c:909 (block fill)."""
        self.ref[by4:by4 + bh4, bx4:bx4 + bw4, 0] = ref0
        self.ref[by4:by4 + bh4, bx4:bx4 + bw4, 1] = ref1
        self.mv[by4:by4 + bh4, bx4:bx4 + bw4, 0] = mv0
        self.mv[by4:by4 + bh4, bx4:bx4 + bw4, 1] = mv1
        self.bs[by4:by4 + bh4, bx4:bx4 + bw4] = bs
        self.mf[by4:by4 + bh4, bx4:bx4 + bw4] = mf


class _Cand:
    __slots__ = ("mv", "weight")

    def __init__(self, mv, weight):
        self.mv = mv          # ((y,x),(y,x))
        self.weight = weight


def _add_spatial_candidate(stack, weight, rf, cy, cx, ref, gmv):
    """dav1d refmvs.c add_spatial_candidate:41. Returns (newmv, refmv)."""
    bmv = rf.mv[cy, cx]
    if bmv[0, 0] == INVALID and bmv[0, 1] == INVALID:
        return 0, 0
    bref = rf.ref[cy, cx]
    bmf = int(rf.mf[cy, cx])
    if ref[1] == -1:
        for n in range(2):
            if bref[n] == ref[0]:
                if (bmf & 1) and gmv[0] is not None:
                    cand = gmv[0]
                else:
                    cand = (int(bmv[n, 0]), int(bmv[n, 1]))
                newmv = bmf >> 1
                for c in stack:
                    if c.mv[0] == cand:
                        c.weight += weight
                        return newmv, 1
                if len(stack) < 8:
                    stack.append(_Cand((cand, None), weight))
                return newmv, 1
        return 0, 0
    if bref[0] == ref[0] and bref[1] == ref[1]:
        c0 = gmv[0] if ((bmf & 1) and gmv[0] is not None) else \
            (int(bmv[0, 0]), int(bmv[0, 1]))
        c1 = gmv[1] if ((bmf & 1) and gmv[1] is not None) else \
            (int(bmv[1, 0]), int(bmv[1, 1]))
        cand = (c0, c1)
        newmv = bmf >> 1
        for c in stack:
            if c.mv == cand:
                c.weight += weight
                return newmv, 1
        if len(stack) < 8:
            stack.append(_Cand(cand, weight))
        return newmv, 1
    return 0, 0


def _scan_row(stack, rf, ref, gmv, cy, cx0, bw4, w4, max_rows, step):
    """dav1d refmvs.c scan_row:97. Returns (n_rows, newmv, refmv)."""
    have_newmv = have_refmv = 0
    cand_bw4 = int(T_BLOCK_DIM[rf.bs[cy, cx0]][0])
    ln = max(step, min(bw4, cand_bw4))
    if bw4 <= cand_bw4:
        weight = 2 if bw4 == 1 else \
            max(2, min(2 * max_rows, int(T_BLOCK_DIM[rf.bs[cy, cx0]][1])))
        nm, rm = _add_spatial_candidate(stack, ln * weight, rf, cy, cx0,
                                        ref, gmv)
        return weight >> 1, nm, rm
    x = 0
    while True:
        nm, rm = _add_spatial_candidate(stack, ln * 2, rf, cy, cx0 + x,
                                        ref, gmv)
        have_newmv |= nm
        have_refmv |= rm
        x += ln
        if x >= w4:
            return 1, have_newmv, have_refmv
        cand_bw4 = int(T_BLOCK_DIM[rf.bs[cy, cx0 + x]][0])
        ln = max(step, cand_bw4)


def _scan_col(stack, rf, ref, gmv, cy0, cx, bh4, h4, max_cols, step):
    """dav1d refmvs.c scan_col:136."""
    have_newmv = have_refmv = 0
    cand_bh4 = int(T_BLOCK_DIM[rf.bs[cy0, cx]][1])
    ln = max(step, min(bh4, cand_bh4))
    if bh4 <= cand_bh4:
        weight = 2 if bh4 == 1 else \
            max(2, min(2 * max_cols, int(T_BLOCK_DIM[rf.bs[cy0, cx]][0])))
        nm, rm = _add_spatial_candidate(stack, ln * weight, rf, cy0, cx,
                                        ref, gmv)
        return weight >> 1, nm, rm
    y = 0
    while True:
        nm, rm = _add_spatial_candidate(stack, ln * 2, rf, cy0 + y, cx,
                                        ref, gmv)
        have_newmv |= nm
        have_refmv |= rm
        y += ln
        if y >= h4:
            return 1, have_newmv, have_refmv
        cand_bh4 = int(T_BLOCK_DIM[rf.bs[cy0 + y, cx]][1])
        ln = max(step, cand_bh4)


def _add_temporal_candidate(stack, rf, cy, cx, ref, tgmv, want_gctx):
    """dav1d refmvs.c add_temporal_candidate:193. Returns globalmv_ctx or
    None if not computed."""
    my = int(rf.rp_proj_mv[cy, cx, 0])
    mx = int(rf.rp_proj_mv[cy, cx, 1])
    if my == INVALID and mx == INVALID:
        return None
    bref = int(rf.rp_proj_ref[cy, cx])
    mv0 = mv_projection((my, mx), rf.pocdiff[ref[0] - 1], bref)
    mv0 = fix_mv_precision(rf.frm_hdr, mv0)
    gctx = None
    if ref[1] == -1:
        if want_gctx:
            gctx = int((abs(mv0[1] - tgmv[0][1]) |
                        abs(mv0[0] - tgmv[0][0])) >= 16)
        for c in stack:
            if c.mv[0] == mv0:
                c.weight += 2
                return gctx
        if len(stack) < 8:
            stack.append(_Cand((mv0, None), 2))
        return gctx
    mv1 = mv_projection((my, mx), rf.pocdiff[ref[1] - 1], bref)
    mv1 = fix_mv_precision(rf.frm_hdr, mv1)
    pair = (mv0, mv1)
    for c in stack:
        if c.mv == pair:
            c.weight += 2
            return gctx
    if len(stack) < 8:
        stack.append(_Cand(pair, 2))
    return gctx


def _add_single_extended(stack, rf, cy, cx, sign, sign_bias):
    """dav1d refmvs.c add_single_extended_candidate:296."""
    for n in range(2):
        cand_ref = int(rf.ref[cy, cx, n])
        if cand_ref <= 0:
            return
        my, mx = int(rf.mv[cy, cx, n, 0]), int(rf.mv[cy, cx, n, 1])
        if sign ^ sign_bias[cand_ref - 1]:
            my, mx = -my, -mx
        cand = (my, mx)
        for c in stack:
            if c.mv[0] == cand:
                break
        else:
            stack.append(_Cand((cand, None), 2))


def _add_compound_extended(same, same_count, rf, cy, cx, sign0, sign1, ref,
                           sign_bias):
    """dav1d refmvs.c add_compound_extended_candidate:239.

    same: list of 4 slots [same0, same1, diff0, diff1] of mv lists.
    """
    for n in range(2):
        cand_ref = int(rf.ref[cy, cx, n])
        if cand_ref <= 0:
            return
        my, mx = int(rf.mv[cy, cx, n, 0]), int(rf.mv[cy, cx, n, 1])
        if cand_ref == ref[0]:
            if same_count[0] < 2:
                same[0].append((my, mx))
                same_count[0] += 1
            if same_count[3] < 2:
                if sign1 ^ sign_bias[cand_ref - 1]:
                    same[3].append((-my, -mx))
                else:
                    same[3].append((my, mx))
                same_count[3] += 1
        elif cand_ref == ref[1]:
            if same_count[1] < 2:
                same[1].append((my, mx))
                same_count[1] += 1
            if same_count[2] < 2:
                if sign0 ^ sign_bias[cand_ref - 1]:
                    same[2].append((-my, -mx))
                else:
                    same[2].append((my, mx))
                same_count[2] += 1
        else:
            if same_count[2] < 2:
                same[2].append((-my, -mx) if sign0 ^ sign_bias[cand_ref - 1]
                               else (my, mx))
                same_count[2] += 1
            if same_count[3] < 2:
                same[3].append((-my, -mx) if sign1 ^ sign_bias[cand_ref - 1]
                               else (my, mx))
                same_count[3] += 1


def refmvs_find(rf: RefmvsFrame, tile, ref, bs, edge_flags, by4, bx4):
    """dav1d refmvs.c dav1d_refmvs_find:348.

    rf: RefmvsFrame; tile: object with col_start/col_end/row_start/row_end
    (4px units, clipped by caller to frame); ref: (ref0, ref1) 1-based with
    -1 for none. Returns (mvstack, n_mvs, ctx): mvstack is a list of
    (mv0, mv1, weight) padded to >= 2 entries; n_mvs is the real count
    (dav1d's *cnt).
    """
    b_dim = T_BLOCK_DIM[bs]
    bw4, bh4 = int(b_dim[0]), int(b_dim[1])
    tile_col_end = min(tile.col_end, rf.iw4)
    tile_row_end = min(tile.row_end, rf.ih4)
    w4 = min(min(bw4, 16), tile_col_end - bx4)
    h4 = min(min(bh4, 16), tile_row_end - by4)

    hdr = rf.frm_hdr
    if ref[0] > 0:
        gm = hdr.gmv[ref[0] - 1]
        tg0 = get_gmv_2d(gm, bx4, by4, bw4, bh4, hdr)
        g0 = tg0 if gm.type > WM_TYPE_TRANSLATION else None
    else:
        tg0 = (0, 0)
        g0 = None
    if ref[1] > 0:
        gm = hdr.gmv[ref[1] - 1]
        tg1 = get_gmv_2d(gm, bx4, by4, bw4, bh4, hdr)
        g1 = tg1 if gm.type > WM_TYPE_TRANSLATION else None
    else:
        tg1 = None
        g1 = None
    gmv = (g0, g1)
    tgmv = (tg0, tg1)

    stack: list[_Cand] = []
    have_newmv = have_col_mvs = have_row_mvs = 0
    max_rows = 0
    n_rows = -1  # ~0
    b_top_y = None
    if by4 > tile.row_start:
        max_rows = min((by4 - tile.row_start + 1) >> 1, 2 + (bh4 > 1))
        b_top_y = by4 - 1
        n_rows, nm, rm = _scan_row(stack, rf, ref, gmv, b_top_y, bx4,
                                   bw4, w4, max_rows, 4 if bw4 >= 16 else 1)
        have_newmv |= nm
        have_row_mvs |= rm

    max_cols = 0
    n_cols = -1
    if bx4 > tile.col_start:
        max_cols = min((bx4 - tile.col_start + 1) >> 1, 2 + (bw4 > 1))
        n_cols, nm, rm = _scan_col(stack, rf, ref, gmv, by4, bx4 - 1,
                                   bh4, h4, max_cols, 4 if bh4 >= 16 else 1)
        have_newmv |= nm
        have_col_mvs |= rm

    # top/right (EDGE_I444_TOP_HAS_RIGHT == 1)
    if n_rows != -1 and (edge_flags & 1) and max(bw4, bh4) <= 16 and \
            bw4 + bx4 < tile_col_end:
        nm, rm = _add_spatial_candidate(stack, 4, rf, b_top_y, bx4 + bw4,
                                        ref, gmv)
        have_newmv |= nm
        have_row_mvs |= rm

    nearest_match = have_col_mvs + have_row_mvs
    nearest_cnt = len(stack)
    for c in stack:
        c.weight += 640

    # temporal candidates (dav1d refmvs.c:417-452)
    globalmv_ctx = hdr.use_ref_frame_mvs
    if rf.use_ref_frame_mvs:
        by8, bx8 = by4 >> 1, bx4 >> 1
        step_h = 2 if bw4 >= 16 else 1
        step_v = 2 if bh4 >= 16 else 1
        w8 = min((w4 + 1) >> 1, 8)
        h8 = min((h4 + 1) >> 1, 8)
        for y in range(0, h8, step_v):
            for x in range(0, w8, step_h):
                g = _add_temporal_candidate(stack, rf, by8 + y, bx8 + x,
                                            ref, tgmv, not (x | y))
                if g is not None:
                    globalmv_ctx = g
        if min(bw4, bh4) >= 2 and max(bw4, bh4) < 16:
            bh8, bw8 = bh4 >> 1, bw4 >> 1
            has_bottom = by8 + bh8 < min(tile_row_end >> 1,
                                         (by8 & ~7) + 8)
            if has_bottom and bx8 - 1 >= max(tile.col_start >> 1,
                                             bx8 & ~7):
                _add_temporal_candidate(stack, rf, by8 + bh8, bx8 - 1,
                                        ref, None, False)
            if bx8 + bw8 < min(tile_col_end >> 1, (bx8 & ~7) + 8):
                if has_bottom:
                    _add_temporal_candidate(stack, rf, by8 + bh8,
                                            bx8 + bw8, ref, None, False)
                if by8 + bh8 - 1 < min(tile_row_end >> 1, (by8 & ~7) + 8):
                    _add_temporal_candidate(stack, rf, by8 + bh8 - 1,
                                            bx8 + bw8, ref, None, False)
    assert len(stack) <= 8

    # top/left ("secondary")
    if n_rows != -1 and n_cols != -1:
        _, rm = _add_spatial_candidate(stack, 4, rf, b_top_y, bx4 - 1,
                                       ref, gmv)
        have_row_mvs |= rm

    # secondary top & left edges (8x8 granularity)
    base = by4 & ~31
    for n in (2, 3):
        if n_rows != -1 and n > n_rows and n <= max_rows:
            cy = base + (((by4 & 31) - 2 * n + 1) | 1)
            add, _, rm = _scan_row(stack, rf, ref, gmv, cy, bx4 | 1,
                                   bw4, w4, 1 + max_rows - n,
                                   4 if bw4 >= 16 else 2)
            n_rows += add
            have_row_mvs |= rm
        if n_cols != -1 and n > n_cols and n <= max_cols:
            cy = base + ((by4 & 31) | 1)
            add, _, rm = _scan_col(stack, rf, ref, gmv, cy,
                                   (bx4 - n * 2 + 1) | 1,
                                   bh4, h4, 1 + max_cols - n,
                                   4 if bh4 >= 16 else 2)
            n_cols += add
            have_col_mvs |= rm

    ref_match_count = have_col_mvs + have_row_mvs

    if nearest_match == 0:
        refmv_ctx = min(2, ref_match_count)
        newmv_ctx = 1 if ref_match_count > 0 else 0
    elif nearest_match == 1:
        refmv_ctx = min(ref_match_count * 3, 4)
        newmv_ctx = 3 - have_newmv
    else:
        refmv_ctx = 5
        newmv_ctx = 5 - have_newmv

    # stable-ish bubble sort by weight (dav1d order-preserving)
    def _sort_range(lo, hi):
        ln = hi
        while ln > lo:
            last = lo
            for n in range(lo + 1, ln):
                if stack[n - 1].weight < stack[n].weight:
                    stack[n - 1], stack[n] = stack[n], stack[n - 1]
                    last = n
            ln = last

    _sort_range(0, nearest_cnt)
    _sort_range(nearest_cnt, len(stack))

    if ref[1] > 0:
        if len(stack) < 2:
            sign0 = rf.sign_bias[ref[0] - 1]
            sign1 = rf.sign_bias[ref[1] - 1]
            sz4 = min(w4, h4)
            same = [[], [], [], []]
            same_count = [0, 0, 0, 0]
            if n_rows != -1:
                x = 0
                while x < sz4:
                    _add_compound_extended(same, same_count, rf, b_top_y,
                                           bx4 + x, sign0, sign1, ref,
                                           rf.sign_bias)
                    x += int(T_BLOCK_DIM[rf.bs[b_top_y, bx4 + x]][0])
            if n_cols != -1:
                y = 0
                while y < sz4:
                    _add_compound_extended(same, same_count, rf, by4 + y,
                                           bx4 - 1, sign0, sign1, ref,
                                           rf.sign_bias)
                    y += int(T_BLOCK_DIM[rf.bs[by4 + y, bx4 - 1]][1])
            # merge: fill each component list to 2 from diff, then tgmv
            comp = [[], []]
            for n in range(2):
                m = list(same[n])
                if len(m) < 2:
                    d = same[2 + n]
                    for dm in d:
                        m.append(dm)
                        if len(m) == 2:
                            break
                while len(m) < 2:
                    m.append(tgmv[n])
                comp[n] = m
            ext = [(comp[0][0], comp[1][0]), (comp[0][1], comp[1][1])]
            n0 = len(stack)
            if n0 == 1 and stack[0].mv == ext[0]:
                ext[0] = ext[1]
            for i in range(n0, 2):
                stack.append(_Cand(ext[i - n0], 2))

        left = -(bx4 + bw4 + 4) * 4 * 8
        right = (rf.iw4 - bx4 + 4) * 4 * 8
        top = -(by4 + bh4 + 4) * 4 * 8
        bottom = (rf.ih4 - by4 + 4) * 4 * 8
        for c in stack:
            m0 = (iclip(c.mv[0][0], top, bottom), iclip(c.mv[0][1], left,
                                                        right))
            m1 = c.mv[1] if c.mv[1] is not None else (0, 0)
            m1 = (iclip(m1[0], top, bottom), iclip(m1[1], left, right))
            c.mv = (m0, m1)

        r = refmv_ctx >> 1
        if r == 0:
            ctx = min(newmv_ctx, 1)
        elif r == 1:
            ctx = 1 + min(newmv_ctx, 3)
        else:
            ctx = iclip(3 + newmv_ctx, 4, 7)
        return ([(c.mv[0], c.mv[1], c.weight) for c in stack], len(stack),
                ctx)

    if len(stack) < 2 and ref[0] > 0:
        sign = rf.sign_bias[ref[0] - 1]
        sz4 = min(w4, h4)
        if n_rows != -1:
            x = 0
            while x < sz4 and len(stack) < 2:
                _add_single_extended(stack, rf, b_top_y, bx4 + x, sign,
                                     rf.sign_bias)
                x += int(T_BLOCK_DIM[rf.bs[b_top_y, bx4 + x]][0])
        if n_cols != -1:
            y = 0
            while y < sz4 and len(stack) < 2:
                _add_single_extended(stack, rf, by4 + y, bx4 - 1, sign,
                                     rf.sign_bias)
                y += int(T_BLOCK_DIM[rf.bs[by4 + y, bx4 - 1]][1])

    # clamping
    if stack:
        left = -(bx4 + bw4 + 4) * 4 * 8
        right = (rf.iw4 - bx4 + 4) * 4 * 8
        top = -(by4 + bh4 + 4) * 4 * 8
        bottom = (rf.ih4 - by4 + 4) * 4 * 8
        for c in stack:
            c.mv = ((iclip(c.mv[0][0], top, bottom),
                     iclip(c.mv[0][1], left, right)), c.mv[1])

    n_mvs = len(stack)
    out = [(c.mv[0], c.mv[1], c.weight) for c in stack]
    for _ in range(len(out), 2):
        out.append((tgmv[0], None, 0))

    ctx = (refmv_ctx << 4) | (globalmv_ctx << 3) | newmv_ctx
    return out, n_mvs, ctx
