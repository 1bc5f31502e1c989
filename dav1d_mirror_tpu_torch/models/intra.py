# Ported from dav1d_mirror_tpu/models/tpu_intra.py (the planner is a copy).
"""Device intra reconstruction: a host-planned wave scan.

The sequential-neighbour dependency of intra prediction (dav1d
src/recon_tmpl.c:1195-1596 interleaves it per block) is re-expressed for
the device: after the host entropy pass, every prediction unit's
geometry, mode and edge availability are known, so the host gives each
unit a wave number (1 + the latest wave of any cell its edges can read)
and the device runs one loop over the waves. Each wave predicts all of
its units in one batch (ops/ipred), adds the residuals the inverse
transforms computed beforehand, and scatters them into the planes.
Palette pixels do not depend on reconstruction and are placed first;
filter-intra cells keep a prediction plane of their own for their
in-block order (they read *predicted*, not reconstructed, in-block
neighbours: dav1d filter_intra_c).

Two drivers emit the engine into a frame program (models/frame_exec):
``build_intra_frame`` for a frame whose blocks are all intra (keyframes),
and ``emit_mixed_intra`` for an inter frame whose only host work would
be plain intra blocks (models/inter.build_frame_program). Bit-exact with
the reference decoder's intra reconstruction.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.tables import TABLES
from ..host import headers as h
from ..ops import ipred as P
from ..ops.ipred import (TILE, PAD, PADT, NPARAMS,
                         DC_PRED, LEFT_DC_PRED, TOP_DC_PRED,
                         DC_128_PRED, VERT_PRED, HOR_PRED, Z1_PRED,
                         Z2_PRED, Z3_PRED, SMOOTH_PRED, SMOOTH_V_PRED,
                         SMOOTH_H_PRED, PAETH_PRED, FILTER_PRED,
                         CFL_MODE, PAL_MODE, MODE_TO_ANGLE, EDGES,
                         get_upsample, get_filter_strength)

T_BLOCK_DIM = TABLES["block_dimensions"]
T_TXFM = TABLES["txfm_dimensions"]
SMOOTH_MODES = (9, 10, 11)      # coded modes
ANGLE_SMOOTH_EDGE_FLAG = 512
CFL_CODED = 13                  # tilecoder CFL_PRED
FILTER_CODED = 13               # tilecoder FILTER_PRED (y_mode)


# ------------------------------------------------------------------
# host parameter precompute
# ------------------------------------------------------------------
def _ctz(v):
    return (v & -v).bit_length() - 1


def _dc_params(p, mode, w, h, bitdepth):
    """ops/ref/ipred.dc_value as bias/shift/mult (host precompute)."""
    if mode == DC_128_PRED:
        p[P.P_DC_BIAS] = (1 << bitdepth) >> 1 if bitdepth > 8 else 128
        p[P.P_DC_MULT] = 1
        return
    if mode == TOP_DC_PRED:
        p[P.P_DC_BIAS] = w >> 1
        p[P.P_DC_USE_TOP] = 1
        p[P.P_DC_SH1] = _ctz(w)
    elif mode == LEFT_DC_PRED:
        p[P.P_DC_BIAS] = h >> 1
        p[P.P_DC_USE_LEFT] = 1
        p[P.P_DC_SH1] = _ctz(h)
    else:
        p[P.P_DC_BIAS] = (w + h) >> 1
        p[P.P_DC_USE_TOP] = p[P.P_DC_USE_LEFT] = 1
        p[P.P_DC_SH1] = _ctz(w + h)
    p[P.P_DC_MULT] = 1
    if mode == DC_PRED and w != h:
        if bitdepth == 8:
            m2, m4, base = 0x5556, 0x3334, 16
        else:
            m2, m4, base = 0xAAAB, 0x6667, 17
        p[P.P_DC_MULT] = m4 if (w > h * 2 or h > w * 2) else m2
        p[P.P_DC_SH2] = base


def _z_params(p, mode, w, h, angle_in, max_w, max_h):
    """Z-mode derived-edge parameters (_z1/_z2/_z3 headers)."""
    is_sm = (angle_in >> 9) & 1
    eief = angle_in >> 10
    angle = angle_in & 511
    gu = get_upsample
    gf = get_filter_strength
    DR = TABLES["dr_intra_derivative"]
    p[P.P_FLT_TO_T] = p[P.P_FLT_TO_L] = 1
    p[P.P_UPS_TO_T] = p[P.P_UPS_TO_L] = 1
    if mode == Z1_PRED:
        dx = int(DR[angle >> 1])
        us = gu(w + h, 90 - angle, is_sm) if eief else 0
        p[P.P_US_ABOVE] = us
        if us:
            p[P.P_UPS_HSZ_T] = w + h
            p[P.P_UPS_FRM_T] = -1
            p[P.P_UPS_TO_T] = w + min(w, h)
            p[P.P_MAX_BASE_X] = 2 * (w + h) - 2
            dx <<= 1
        else:
            fs = gf(w + h, 90 - angle, is_sm) if eief else 0
            p[P.P_FS_ABOVE] = fs
            if fs:
                p[P.P_FLT_SZ_T] = w + h
                p[P.P_FLT_LIM_FROM_T] = 0
                p[P.P_FLT_LIM_TO_T] = w + h
                p[P.P_FLT_FRM_T] = -1
                p[P.P_FLT_TO_T] = w + min(w, h)
                p[P.P_MAX_BASE_X] = w + h - 1
            else:
                p[P.P_MAX_BASE_X] = w + min(w, h) - 1
        p[P.P_DX] = dx
    elif mode == Z2_PRED:
        dy = int(DR[(angle - 90) >> 1])
        dx = int(DR[(180 - angle) >> 1])
        usl = gu(w + h, 180 - angle, is_sm) if eief else 0
        usa = gu(w + h, angle - 90, is_sm) if eief else 0
        p[P.P_US_LEFT] = usl
        p[P.P_US_ABOVE] = usa
        if usa:
            dx <<= 1
        else:
            p[P.P_FS_ABOVE] = gf(w + h, angle - 90, is_sm) if eief else 0
            p[P.P_FLT_LIM_TO_T] = max_w
        if usl:
            dy <<= 1
        else:
            p[P.P_FS_LEFT] = gf(w + h, 180 - angle, is_sm) if eief else 0
            p[P.P_FLT_LIM_TO_L] = max_h
        p[P.P_DX] = dx
        p[P.P_DY] = dy
    elif mode == Z3_PRED:
        dy = int(DR[(270 - angle) >> 1])
        us = gu(w + h, angle - 180, is_sm) if eief else 0
        p[P.P_US_LEFT] = us
        if us:
            p[P.P_UPS_HSZ_L] = w + h
            p[P.P_UPS_FRM_L] = max(w - h, 0)
            p[P.P_UPS_TO_L] = w + h + 1
            p[P.P_MAX_BASE_Y] = 2 * (w + h) - 2
            dy <<= 1
        else:
            fs = gf(w + h, angle - 180, is_sm) if eief else 0
            p[P.P_FS_LEFT] = fs
            if fs:
                p[P.P_FLT_SZ_L] = w + h
                p[P.P_FLT_LIM_FROM_L] = 0
                p[P.P_FLT_LIM_TO_L] = w + h
                p[P.P_FLT_FRM_L] = max(w - h, 0)
                p[P.P_FLT_TO_L] = w + h + 1
                p[P.P_MAX_BASE_Y] = w + h - 1
            else:
                p[P.P_MAX_BASE_Y] = h + min(w, h) - 1
        p[P.P_DY] = dy


def _convert_mode(mode, angle, have_left, have_top):
    """ipred_prepare coded->impl mode conversion; returns (m, angle)."""
    if 1 <= mode <= 8:
        angle = MODE_TO_ANGLE[mode - 1] + 3 * angle
        if angle <= 90:
            return (Z1_PRED if angle < 90 and have_top else VERT_PRED,
                    angle)
        if angle < 180:
            return Z2_PRED, angle
        return (Z3_PRED if angle > 180 and have_left else HOR_PRED, angle)
    if mode == 0:
        return [[DC_128_PRED, TOP_DC_PRED],
                [LEFT_DC_PRED, DC_PRED]][have_left][have_top], angle
    if mode == 12:
        return [[DC_128_PRED, VERT_PRED],
                [HOR_PRED, PAETH_PRED]][have_left][have_top], angle
    return {9: SMOOTH_PRED, 10: SMOOTH_V_PRED, 11: SMOOTH_H_PRED,
            13: FILTER_PRED}[mode], angle


def _edge_geom(p, impl_mode, x, y, w_t, h_t, edge_flags, tw, th, ief):
    """prepare_intra_edges availability geometry into the param vector.
    x/y unit pos in 4px units (plane coords); w_t/h_t tile col/row end."""
    have_left = int(p[P.P_HAVE_LEFT])
    have_top = int(p[P.P_HAVE_TOP])
    nl, nt, ntl, ntr, nbl = EDGES[impl_mode]
    p[P.P_NEEDS_LEFT] = nl
    p[P.P_NEEDS_TOP] = nt
    p[P.P_NEEDS_TL] = ntl
    p[P.P_NEEDS_TR] = ntr
    p[P.P_NEEDS_BL] = nbl
    sz_l = th << 2
    sz_t = tw << 2
    p[P.P_PXH_LEFT] = min(sz_l, (h_t - y) << 2) if have_left else 0
    have_bl = 0 if (not have_left or y + th >= h_t) else \
        (edge_flags & 8)
    p[P.P_PXH_BL] = min(sz_l, (h_t - y - th) << 2) if have_bl else 0
    p[P.P_PXH_TOP] = min(sz_t, (w_t - x) << 2) if have_top else 0
    have_tr = 0 if (not have_top or x + tw >= w_t) else \
        (edge_flags & 1)
    p[P.P_PXH_TR] = min(sz_t, (w_t - x - tw) << 2) if have_tr else 0
    p[P.P_HTFR] = int(have_top and (nt or ntl or (nl and not have_left)))
    p[P.P_Z2TLF] = int(ntl and impl_mode == Z2_PRED and tw + th >= 6 and
                       ief)


# ------------------------------------------------------------------
# plan builder
# ------------------------------------------------------------------
class IntraPlan:
    def __init__(self):
        self.items = []         # (param_vec, wave)
        self.filter_items = []
        self.max_wave = 0

    def wave_rows(self):
        """The plan by wave: ((rows, offs) of the main units, (rows, offs)
        of the filter-intra cells). rows: (U, NPARAMS) int32 in wave order
        (insertion order within a wave); offs: (n_waves + 1,) int64, wave
        w's rows are rows[offs[w]:offs[w + 1]]. The reference pads each
        wave to the largest one instead (IntraPlan.finalize)."""
        n_waves = self.max_wave + 1

        def pack(lst):
            rows = np.zeros((len(lst), NPARAMS), np.int32)
            waves = np.zeros(len(lst), np.int64)
            for i, (pv, wv) in enumerate(lst):
                rows[i] = pv
                waves[i] = wv
            order = np.argsort(waves, kind="stable")
            offs = np.zeros(n_waves + 1, np.int64)
            np.cumsum(np.bincount(waves, minlength=n_waves), out=offs[1:])
            return rows[order], offs

        return pack(self.items), pack(self.filter_items)


def build_intra_plan(seq, fhdr, coder, done, plan: IntraPlan):
    """Emit prediction units for one tile's intra blocks into `plan`.

    `done`: list of 3 int32 grids (plane 4px-unit dims, frame-wide)
    holding the wave at which each cell completes (0 = ready at start).
    Shared across tiles (tiles are spatially disjoint; edges never cross
    tile starts)."""
    bitdepth = seq.bitdepth
    ss_hor = 1 if seq.layout != h.PIXEL_LAYOUT_I444 else 0
    ss_ver = 1 if seq.layout == h.PIXEL_LAYOUT_I420 else 0
    monochrome = seq.layout == h.PIXEL_LAYOUT_I400
    keyframe = fhdr.frame_type in (0, 2)
    ief = seq.intra_edge_filter
    ief_flag = ief << 10
    bw, bh = coder.bw, coder.bh
    ch_w = (bw + ss_hor) >> ss_hor
    ch_h = (bh + ss_ver) >> ss_ver
    sb_step = coder.sb_step

    a_mode = np.zeros(bw + 32, np.uint8)
    a_intra = np.full(bw + 32, 1 if keyframe else 0, np.uint8)
    a_uvmode = np.zeros(bw + 32, np.uint8)
    l_mode = np.zeros(32, np.uint8)
    l_intra = np.full(32, 1 if keyframe else 0, np.uint8)
    l_uvmode = np.zeros(32, np.uint8)
    cur_sbrow = -1

    def sm_flag(mode_arr, intra_arr, idx):
        if not intra_arr[idx]:
            return 0
        return ANGLE_SMOOTH_EDGE_FLAG if mode_arr[idx] in SMOOTH_MODES \
            else 0

    def sm_uv_flag(uvmode_arr, idx):
        return ANGLE_SMOOTH_EDGE_FLAG if uvmode_arr[idx] in SMOOTH_MODES \
            else 0

    def dep_wave(pl, x, y, tw, th, w_t, h_t, have_left, have_top,
                 extra=0):
        g = done[pl]
        mx = extra
        if have_top:
            x0 = max(x - 1, 0)
            x1 = min(x + 2 * tw, w_t)
            seg = g[y - 1, x0:x1]
            if seg.size:
                mx = max(mx, int(seg.max()))
        if have_left:
            y1 = min(y + 2 * th, h_t)
            seg = g[y:y1, x - 1]
            if seg.size:
                mx = max(mx, int(seg.max()))
        return mx + 1

    def mark_done(pl, x, y, tw, th, wave):
        g = done[pl]
        g[y:y + th, x:x + tw] = wave
        plan.max_wave = max(plan.max_wave, wave)

    def subtile(p0, wave, uw_px, uh_px, out):
        for oy in range(0, uh_px, TILE):
            for ox in range(0, uw_px, TILE):
                p = p0.copy()
                p[P.P_OX] = ox
                p[P.P_OY] = oy
                p[P.P_PX] = p0[P.P_PX] + ox
                p[P.P_PY] = p0[P.P_PY] + oy
                p[P.P_VALID] = 1
                out.append((p, wave))

    for b in coder.blocks:
        sbrow = b.by // sb_step
        if sbrow != cur_sbrow:
            cur_sbrow = sbrow
            l_mode[:] = 0
            l_intra[:] = 1 if keyframe else 0
            l_uvmode[:] = 0

        b_dim = T_BLOCK_DIM[b.bs]
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        bx, by = b.bx, b.by
        by4 = by & 31
        cby4 = by4 >> ss_ver

        if not b.intra:
            a_intra[bx:bx + bw4] = 0
            l_intra[by4:by4 + bh4] = 0
            if not monochrome:
                cbw4_i = (bw4 + ss_hor) >> ss_hor
                cbh4_i = (bh4 + ss_ver) >> ss_ver
                if (bw4 > ss_hor or bx & 1) and (bh4 > ss_ver or by & 1):
                    a_uvmode[(bx >> ss_hor):(bx >> ss_hor) + cbw4_i] = 0
                    l_uvmode[cby4:cby4 + cbh4_i] = 0
            continue

        w4 = min(bw4, bw - bx)
        h4 = min(bh4, bh - by)
        cw4 = (w4 + ss_hor) >> ss_hor
        ch4 = (h4 + ss_ver) >> ss_ver
        cbw4 = (bw4 + ss_hor) >> ss_hor
        cbh4 = (bh4 + ss_ver) >> ss_ver
        has_chroma = (not monochrome and
                      (bw4 > ss_hor or bx & 1) and (bh4 > ss_ver or by & 1))
        t_dim = T_TXFM[b.tx]
        uv_t_dim = T_TXFM[b.uvtx]
        tw, th = int(t_dim[0]), int(t_dim[1])
        ctw, cth = int(uv_t_dim[0]), int(uv_t_dim[1])
        is_cfl = has_chroma and b.uv_mode == CFL_CODED

        for init_y in range(0, h4, 16):
            sub_h4 = min(h4, 16 + init_y)
            sub_ch4 = min(ch4, (init_y + 16) >> ss_ver)
            for init_x in range(0, w4, 16):
                sub_w4 = min(w4, init_x + 16)
                intra_flags = (sm_flag(a_mode, a_intra, bx + init_x) |
                               sm_flag(l_mode, l_intra, by4 + init_y) |
                               ief_flag)
                sb_has_tr = 1 if init_x + 16 < w4 else 0 if init_y else \
                    (b.edge_flags & 1)
                sb_has_bl = 0 if init_x else 1 if init_y + 16 < h4 else \
                    (b.edge_flags & 8)

                # ---- luma ----
                y = init_y
                while y < sub_h4:
                    x = init_x
                    while x < sub_w4:
                        ux, uy = bx + x, by + y
                        have_left = int(ux > coder.col_start)
                        have_top = int(uy > coder.row_start)
                        p0 = np.zeros(NPARAMS, np.int32)
                        p0[P.P_PLANE] = 0
                        p0[P.P_PX] = ux * 4
                        p0[P.P_PY] = uy * 4
                        p0[P.P_W] = tw * 4
                        p0[P.P_H] = th * 4
                        p0[P.P_HAVE_LEFT] = have_left
                        p0[P.P_HAVE_TOP] = have_top

                        if b.pal_sz[0]:
                            # palette pixels pre-placed; residual-only
                            wave = dep_wave(0, ux, uy, tw, th,
                                            coder.col_end, coder.row_end,
                                            have_left, have_top)
                            p0[P.P_MODE] = PAL_MODE
                            subtile(p0, wave, tw * 4, th * 4, plan.items)
                            mark_done(0, ux, uy, min(tw, bw - ux),
                                      min(th, bh - uy), wave)
                            x += tw
                            continue

                        edge_flags = (
                            (0 if ((y > init_y or not sb_has_tr) and
                                   (x + tw >= sub_w4)) else 1) |
                            (0 if (x > init_x or
                                   (not sb_has_bl and y + th >= sub_h4))
                             else 8))
                        m, angle = _convert_mode(b.y_mode, b.y_angle,
                                                 have_left, have_top)
                        _edge_geom(p0, m, ux, uy, coder.col_end,
                                   coder.row_end, edge_flags, tw, th, ief)
                        p0[P.P_MODE] = m
                        if m in (DC_PRED, LEFT_DC_PRED, TOP_DC_PRED,
                                 DC_128_PRED):
                            _dc_params(p0, m, tw * 4, th * 4, bitdepth)
                        elif m in (Z1_PRED, Z2_PRED, Z3_PRED):
                            _z_params(p0, m, tw * 4, th * 4,
                                      angle | intra_flags,
                                      4 * bw - 4 * ux, 4 * bh - 4 * uy)

                        if m == FILTER_PRED:
                            p0[P.P_MISC] = b.y_angle
                            p0[P.P_BPX] = ux * 4
                            p0[P.P_BPY] = uy * 4
                            base_wave = dep_wave(
                                0, ux, uy, tw, th, coder.col_end,
                                coder.row_end, have_left, have_top)
                            cell_w = np.zeros((th, tw), np.int64)
                            for cy in range(th):
                                for cx in range(tw):
                                    wv = base_wave
                                    if cx:
                                        wv = max(wv,
                                                 int(cell_w[cy, cx - 1])
                                                 + 1)
                                    if cy:
                                        wv = max(wv,
                                                 int(cell_w[cy - 1, cx])
                                                 + 1)
                                    cell_w[cy, cx] = wv
                                    p = p0.copy()
                                    p[P.P_PX] = (ux + cx) * 4
                                    p[P.P_PY] = (uy + cy) * 4
                                    p[P.P_OX] = cx * 4
                                    p[P.P_OY] = cy * 4
                                    p[P.P_VALID] = 1
                                    plan.filter_items.append((p, wv))
                            wave = int(cell_w.max())
                        else:
                            wave = dep_wave(0, ux, uy, tw, th,
                                            coder.col_end, coder.row_end,
                                            have_left, have_top)
                            subtile(p0, wave, tw * 4, th * 4, plan.items)
                        mark_done(0, ux, uy, min(tw, bw - ux),
                                  min(th, bh - uy), wave)
                        x += tw
                    y += th

                if not has_chroma:
                    continue

                # ---- CFL prediction (whole chroma block, first pass) ----
                cbx = bx >> ss_hor
                cby = by >> ss_ver
                c_colstart = coder.col_start >> ss_hor
                c_rowstart = coder.row_start >> ss_ver
                c_colend = coder.col_end >> ss_hor
                c_rowend = coder.row_end >> ss_ver
                if is_cfl and init_x == 0 and init_y == 0:
                    ysrc_x = 4 * (bx & ~ss_hor)
                    ysrc_y = 4 * (by & ~ss_ver)
                    furthest_r = ((cw4 << ss_hor) + tw - 1) & ~(tw - 1)
                    furthest_b = ((ch4 << ss_ver) + th - 1) & ~(th - 1)
                    w_pad = cbw4 - (furthest_r >> ss_hor)
                    h_pad = cbh4 - (furthest_b >> ss_ver)
                    lx0, ly0 = ysrc_x // 4, ysrc_y // 4
                    lw_ = min(cbw4 << ss_hor, bw - lx0)
                    lh_ = min(cbh4 << ss_ver, bh - ly0)
                    luma_wave = int(done[0][ly0:ly0 + lh_,
                                            lx0:lx0 + lw_].max())
                    for pl in range(2):
                        if not b.cfl_alpha[pl]:
                            continue
                        have_left = int(cbx > c_colstart)
                        have_top = int(cby > c_rowstart)
                        p0 = np.zeros(NPARAMS, np.int32)
                        p0[P.P_PLANE] = 1 + pl
                        p0[P.P_PX] = cbx * 4
                        p0[P.P_PY] = cby * 4
                        p0[P.P_W] = ctw * 4
                        p0[P.P_H] = cth * 4
                        p0[P.P_HAVE_LEFT] = have_left
                        p0[P.P_HAVE_TOP] = have_top
                        p0[P.P_MODE] = CFL_MODE
                        dc_m, _ = _convert_mode(0, 0, have_left, have_top)
                        _edge_geom(p0, dc_m, cbx, cby, c_colend, c_rowend,
                                   0, ctw, cth, 0)
                        _dc_params(p0, dc_m, ctw * 4, cth * 4, bitdepth)
                        p0[P.P_MISC] = b.cfl_alpha[pl]
                        p0[P.P_YSRC_X] = ysrc_x
                        p0[P.P_YSRC_Y] = ysrc_y
                        p0[P.P_CFL_WCL] = cbw4 * 4 - 4 * w_pad
                        p0[P.P_CFL_HCL] = cbh4 * 4 - 4 * h_pad
                        p0[P.P_CFL_LOG2SZ] = \
                            ((cbw4 * 4).bit_length() - 1) + \
                            ((cbh4 * 4).bit_length() - 1)
                        wave = dep_wave(1 + pl, cbx, cby, ctw, cth,
                                        c_colend, c_rowend, have_left,
                                        have_top, extra=luma_wave)
                        subtile(p0, wave, ctw * 4, cth * 4, plan.items)
                        mark_done(1 + pl, cbx, cby,
                                  min(ctw, ch_w - cbx),
                                  min(cth, ch_h - cby), wave)

                sm_uv_fl = (sm_uv_flag(a_uvmode, (bx + init_x) >> ss_hor) |
                            sm_uv_flag(l_uvmode,
                                       cby4 + (init_y >> ss_ver)))
                uv_sb_has_tr = (1 if ((init_x + 16) >> ss_hor) < cw4 else
                                0 if init_y else
                                b.edge_flags & (4 >> (seq.layout - 1)))
                uv_sb_has_bl = (0 if init_x else
                                1 if ((init_y + 16) >> ss_ver) < ch4 else
                                b.edge_flags & (32 >> (seq.layout - 1)))
                sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
                max_w_uv = (4 * bw + ss_hor - 4 * (bx & ~ss_hor)) >> ss_hor
                max_h_uv = (4 * bh + ss_ver - 4 * (by & ~ss_ver)) >> ss_ver
                for pl in range(2):
                    y = init_y >> ss_ver
                    while y < sub_ch4:
                        x = init_x >> ss_hor
                        while x < sub_cw4:
                            xpos = (bx >> ss_hor) + x
                            ypos = (by >> ss_ver) + y
                            do_pred = not ((is_cfl and b.cfl_alpha[pl]) or
                                           b.pal_sz[1])
                            have_left = int(xpos > c_colstart)
                            have_top = int(ypos > c_rowstart)
                            p0 = np.zeros(NPARAMS, np.int32)
                            p0[P.P_PLANE] = 1 + pl
                            p0[P.P_PX] = xpos * 4
                            p0[P.P_PY] = ypos * 4
                            p0[P.P_W] = ctw * 4
                            p0[P.P_H] = cth * 4
                            p0[P.P_HAVE_LEFT] = have_left
                            p0[P.P_HAVE_TOP] = have_top
                            if do_pred:
                                edge_flags = (
                                    (0 if ((y > (init_y >> ss_ver) or
                                            not uv_sb_has_tr) and
                                           (x + ctw >= sub_cw4)) else 1) |
                                    (0 if (x > (init_x >> ss_hor) or
                                           (not uv_sb_has_bl and
                                            y + cth >= sub_ch4)) else 8))
                                uv_mode = 0 if is_cfl else b.uv_mode
                                m, angle = _convert_mode(
                                    uv_mode, b.uv_angle, have_left,
                                    have_top)
                                _edge_geom(p0, m, xpos, ypos, c_colend,
                                           c_rowend, edge_flags, ctw,
                                           cth, ief)
                                p0[P.P_MODE] = m
                                if m in (DC_PRED, LEFT_DC_PRED,
                                         TOP_DC_PRED, DC_128_PRED):
                                    _dc_params(p0, m, ctw * 4, cth * 4,
                                               bitdepth)
                                elif m in (Z1_PRED, Z2_PRED, Z3_PRED):
                                    _z_params(p0, m, ctw * 4, cth * 4,
                                              (angle | ief_flag) |
                                              sm_uv_fl, max_w_uv,
                                              max_h_uv)
                                wave = dep_wave(1 + pl, xpos, ypos, ctw,
                                                cth, c_colend, c_rowend,
                                                have_left, have_top)
                            else:
                                # cfl/palette-covered: residual-only
                                wave = int(done[1 + pl][ypos, xpos]) + 1
                                p0[P.P_MODE] = PAL_MODE
                            subtile(p0, wave, ctw * 4, cth * 4,
                                    plan.items)
                            mark_done(1 + pl, xpos, ypos,
                                      min(ctw, ch_w - xpos),
                                      min(cth, ch_h - ypos), wave)
                            x += ctw
                        y += cth

        y_mode_nofilt = 0 if b.y_mode == FILTER_CODED else b.y_mode
        a_mode[bx:bx + bw4] = y_mode_nofilt
        a_intra[bx:bx + bw4] = 1
        l_mode[by4:by4 + bh4] = y_mode_nofilt
        l_intra[by4:by4 + bh4] = 1
        if has_chroma:
            a_uvmode[(bx >> ss_hor):(bx >> ss_hor) + cbw4] = b.uv_mode
            l_uvmode[cby4:cby4 + cbh4] = b.uv_mode


def wave_families(rows, offs):
    """Per wave, the sorted tuple of ops/ipred mode families its units
    use (host side: the scan computes only these)."""
    out = []
    for w in range(len(offs) - 1):
        modes = np.unique(rows[offs[w]:offs[w + 1], P.P_MODE])
        out.append(tuple(sorted({P.FAMILY_OF[int(m)] for m in modes})))
    return tuple(out)


# ------------------------------------------------------------------
# device wave scan
# ------------------------------------------------------------------
def _tile_targets(p, n, Hp, Wp, valid, sink, extent=True):
    """Flat indices of (K, n, n) tiles at each unit's (px, py) in a stack
    of (Hp, Wp) planes (the unit's P_PLANE selects one): the reference's
    row-major flat scatter, whose out-of-range indices are dropped. The
    pixels of invalid units, off their plane or (with `extent`) outside
    the unit's (P_W, P_H) extent go to `sink`, an element past the
    stack's end."""
    dev = p.device
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    ys = p[:, P.P_PY, None, None] + PADT + ar[None, :, None]
    xs = p[:, P.P_PX, None, None] + PADT + ar[None, None, :]
    inplane = ys * Wp + xs
    keep = valid[:, None, None] & (inplane >= 0) & (inplane < Hp * Wp)
    if extent:
        keep = keep & (ar[None, :, None] + p[:, P.P_OY, None, None] <
                       p[:, P.P_H, None, None]) & \
            (ar[None, None, :] + p[:, P.P_OX, None, None] <
             p[:, P.P_W, None, None])
    flat = p[:, P.P_PLANE, None, None].to(torch.int64) * (Hp * Wp) + inplane
    return torch.where(keep, flat, sink).reshape(-1)


def intra_scan(planes, res, main_rows, main_offs, filt_rows, filt_offs,
               bitdepth, ss_hor, ss_ver, main_fams=None):
    """The wave scan. planes/res: (n_planes, Hp, Wp) int32 padded planes,
    every plane in the luma-padded shape. main_rows/filt_rows: (U, NPARAMS)
    int32 device tensors of the main units and filter-intra cells in wave
    order; main_offs/filt_offs: host int sequences of n_waves + 1 offsets
    (IntraPlan.wave_rows). main_fams: per wave, the mode families to
    compute (wave_families; None = all). Returns the reconstructed planes
    as a new (n_planes, Hp, Wp) tensor.

    Within a wave, main units predict from the planes as they stood
    before the wave, then scatter; then the filter-intra cells run on the
    updated planes and the filter prediction plane. The loop never waits
    for the device: masked lanes write to one sink element past the end
    of the flat planes, the only index that repeats."""
    n_planes, Hp, Wp = planes.shape
    N = n_planes * Hp * Wp
    dev = planes.device
    bd_max = (1 << bitdepth) - 1
    flat = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    flat[:N] = planes.reshape(-1)
    resf = res.reshape(-1)
    luma = flat[:Hp * Wp].view(Hp, Wp)
    predf = torch.zeros(Hp * Wp + 1, dtype=torch.int32, device=dev)
    predp = predf[:Hp * Wp].view(Hp, Wp)
    n_waves = len(main_offs) - 1
    for w in range(n_waves):
        a, b = int(main_offs[w]), int(main_offs[w + 1])
        if b > a:
            mp = main_rows[a:b]
            fams = None if main_fams is None else main_fams[w]
            base = mp[:, P.P_PLANE] * (Hp * Wp)
            bpx = mp[:, P.P_PX] - mp[:, P.P_OX] - 1 + PADT
            bpy = mp[:, P.P_PY] - mp[:, P.P_OY] - 1 + PADT
            ts = P.gather_window(flat, Hp, Wp, bpy, bpx, 1, 130,
                                 base)[:, 0]
            ls = P.gather_window(flat, Hp, Wp, bpy, bpx, 130, 1,
                                 base)[:, :, 0]
            oy = mp[:, P.P_PY] + PADT
            ox = mp[:, P.P_PX] + PADT
            own = P.gather_window(flat, Hp, Wp, oy, ox, TILE, TILE, base)
            luma_reg = None
            if fams is None or "cfl" in fams:
                luma_reg = P.gather_window(
                    flat, Hp, Wp, mp[:, P.P_YSRC_Y] + PADT,
                    mp[:, P.P_YSRC_X] + PADT, 64, 64)
            pred = P.pred_main_tile(ts, ls, own, luma_reg, mp, bitdepth,
                                    ss_hor, ss_ver, fams)
            rtile = P.gather_window(resf, Hp, Wp, oy, ox, TILE, TILE, base)
            # CFL covers a whole block whose residuals are added by the
            # per-tx follow-up units: scatter pure prediction
            rtile = torch.where(mp[:, P.P_MODE, None, None] == CFL_MODE, 0,
                                rtile)
            out = (pred + rtile).clamp(0, bd_max)
            valid = (mp[:, P.P_VALID] > 0) & (mp[:, P.P_PLANE] < n_planes)
            flat[_tile_targets(mp, TILE, Hp, Wp, valid, N)] = \
                out.reshape(-1)

        a, b = int(filt_offs[w]), int(filt_offs[w + 1])
        if b > a:
            fp = filt_rows[a:b]
            fpred = P.pred_filter_cell(luma, predp, fp, bitdepth)
            rtile = P.gather_window(resf, Hp, Wp, fp[:, P.P_PY] + PADT,
                                    fp[:, P.P_PX] + PADT, 4, 4)
            fout = (fpred + rtile).clamp(0, bd_max)
            # filter-intra cells are luma (P_PLANE 0): the same indices
            # address the prediction plane, whose sink is element Hp*Wp
            tgt = _tile_targets(fp, 4, Hp, Wp, fp[:, P.P_VALID] > 0,
                                Hp * Wp, extent=False)
            predf[tgt] = fpred.reshape(-1)
            flat[torch.where(tgt == Hp * Wp, N, tgt)] = fout.reshape(-1)
    return flat[:N].view(n_planes, Hp, Wp)


# ------------------------------------------------------------------
# frame drivers
# ------------------------------------------------------------------
def _layout(seq, n_planes, bw, bh):
    """(ss_hor, ss_ver, (Hp, Wp), plane_dims): the scan's luma-padded
    plane shape and each plane's reconstructed extent."""
    ss_hor = 1 if seq.layout != h.PIXEL_LAYOUT_I444 else 0
    ss_ver = 1 if seq.layout == h.PIXEL_LAYOUT_I420 else 0
    ch_w = (bw + ss_hor) >> ss_hor
    ch_h = (bh + ss_ver) >> ss_ver
    dims = [(bh * 4, bw * 4)] + [(ch_h * 4, ch_w * 4)] * (n_planes - 1)
    return ss_hor, ss_ver, (bh * 4 + PADT + PAD, bw * 4 + PADT + PAD), dims


def _emit_palette(prog, coders, n_planes, ss_hor, ss_ver):
    """Palette pixels as 4x4-tile scatters (no reconstruction dependency:
    placed before the scan, which passes them through)."""
    tiles = [[] for _ in range(n_planes)]   # (vals (4, 4), y, x)
    for coder in coders:
        for b in coder.blocks:
            if not b.intra or (not b.pal_sz[0] and not b.pal_sz[1]):
                continue
            b_dim = T_BLOCK_DIM[b.bs]
            bw4, bh4 = int(b_dim[0]), int(b_dim[1])
            if b.pal_sz[0]:
                px_ = np.asarray(b.pal[0], np.int64)[b.pal_idx_y]
                py0, px0 = 4 * b.by + PADT, 4 * b.bx + PADT
                for oy in range(0, bh4 * 4, 4):
                    for ox in range(0, bw4 * 4, 4):
                        tiles[0].append((px_[oy:oy + 4, ox:ox + 4],
                                         py0 + oy, px0 + ox))
            if b.pal_sz[1] and n_planes > 1 and \
                    (bw4 > ss_hor or b.bx & 1) and \
                    (bh4 > ss_ver or b.by & 1):
                cbw4 = (bw4 + ss_hor) >> ss_hor
                cbh4 = (bh4 + ss_ver) >> ss_ver
                py0 = 4 * (b.by >> ss_ver) + PADT
                px0 = 4 * (b.bx >> ss_hor) + PADT
                for pl in (1, 2):
                    pv_ = np.asarray(b.pal[pl], np.int64)[b.pal_idx_uv]
                    for oy in range(0, cbh4 * 4, 4):
                        for ox in range(0, cbw4 * 4, 4):
                            tiles[pl].append(
                                (pv_[oy:oy + 4, ox:ox + 4],
                                 py0 + oy, px0 + ox))
    for pl, lst in enumerate(tiles):
        if lst:
            prog.op("palset", pl,
                    prog.emit(np.stack([v for v, _, _ in lst])),
                    prog.emit(np.asarray([y for _, y, _ in lst], np.int32)),
                    prog.emit(np.asarray([x for _, _, x in lst], np.int32)))


def _emit_residuals(prog, iplans, bitdepth):
    """The engine's residual planes: one sparse bucket per (plane, tx
    size), the transform type as per-block data (lossless WHT buckets on
    their own), written at +PADT."""
    from ..ops.itx_meta import TX_INFO, WHT_WHT
    from .frame_exec import ItxRun, compact_cf
    prog.op("newres")
    with ItxRun(prog, "raw") as run:     # one work list for the buckets
        for (pl, tx, is_wht), lst in sorted(iplans.items()):
            w_t, h_t, _ = TX_INFO[tx]
            sh, sw = min(h_t, 32), min(w_t, 32)
            vals, pos, _ = compact_cf(lst.cf)
            # 8 bpc coefficients fit int16; positions always do (<= 1024)
            h_vals = prog.emit16(vals) if bitdepth == 8 else prog.emit(vals)
            h_pos = prog.emit16(pos)
            h_ys, h_xs = prog.emit(lst.ys + PADT), prog.emit(lst.xs + PADT)
            if is_wht:
                run.op("resrawc", pl, tx, WHT_WHT, sh, sw, h_vals, h_pos,
                       h_ys, h_xs)
            else:
                run.op("resrawmc", pl, sh, sw, tx, h_vals, h_pos,
                       prog.emit(lst.sel[:, 0]), prog.emit(lst.sel[:, 1]),
                       h_ys, h_xs)


def _emit_scan(prog, seq, fhdr, coders, n_planes, ss_hor, ss_ver):
    """Plan the frame's prediction units and emit the wave scan."""
    bw, bh = coders[0].bw, coders[0].bh
    ch_w = (bw + ss_hor) >> ss_hor
    ch_h = (bh + ss_ver) >> ss_ver
    done = [np.zeros((bh, bw), np.int32),
            np.zeros((ch_h, ch_w), np.int32),
            np.zeros((ch_h, ch_w), np.int32)]
    plan = IntraPlan()
    for coder in coders:
        build_intra_plan(seq, fhdr, coder, done, plan)
    (mrows, moffs), (frows, foffs) = plan.wave_rows()
    prog.op("intrascan", prog.emit(mrows), tuple(int(v) for v in moffs),
            wave_families(mrows, moffs), prog.emit(frows),
            tuple(int(v) for v in foffs), ss_hor, ss_ver, n_planes)


def build_intra_frame(seq, fhdr, coders, bufs):
    """Plan and pack the device reconstruction of a frame whose blocks are
    all intra: palette tiles, the residual planes, the wave scan, and a
    crop of each plane to bufs.planes' shape, as one FrameProgram."""
    from .frame_exec import FrameProgram
    from .plan_vec import plan_residuals_vec
    n_planes = len(bufs.planes)
    ss_hor, ss_ver, (Hp, Wp), dims = _layout(seq, n_planes, coders[0].bw,
                                             coders[0].bh)
    prog = FrameProgram(n_planes, seq.bitdepth, [(Hp, Wp)] * n_planes,
                        out_dtype=bufs.planes[0].dtype)
    _emit_palette(prog, coders, n_planes, ss_hor, ss_ver)
    # every block is intra: every residual feeds the engine (class 3)
    rv = plan_residuals_vec(coders, [np.full(c.native_arrays[0].shape[0], 3,
                                             np.uint8) for c in coders])
    if rv is None:
        raise ValueError("coefficient records are not in decode order")
    _emit_residuals(prog, rv[2], seq.bitdepth)
    _emit_scan(prog, seq, fhdr, coders, n_planes, ss_hor, ss_ver)
    for i in range(n_planes):
        ph, pw = dims[i]
        fh, fw = bufs.planes[i].shape
        prog.op("crop", i, PADT, PADT, ph, pw, fh, fw)
    prog.op("out")   # native-dtype planes for the filters and the refs
    return prog


def run_intra_frame(prog, bufs, device):
    """Execute build_intra_frame's program on `device`. The planes stay
    on the device (bufs.dev_planes), where the filter chain reads them."""
    from .frame_exec import run_frame_program
    out, _ = run_frame_program(prog, (), device)
    bufs.dev_planes = list(out)
    return bufs


def recon_intra_frame(seq, fhdr, coders, bufs, device):
    """Device reconstruction of an intra frame (no inter or intrabc
    blocks): build_intra_frame, then run_intra_frame."""
    return run_intra_frame(build_intra_frame(seq, fhdr, coders, bufs), bufs,
                           device)


def emit_mixed_intra(prog, seq, fhdr, coders, iplans, plane_shapes):
    """Emit the engine into an inter frame's program (models/inter.
    build_frame_program), after every inter prediction and residual op:

      embed (planes -> padded layout) -> palset -> newres -> resrawmc /
      resrawc (the intra residual planes) -> intrascan (inter pixels are
      wave 0) -> crop back to plane_shapes.

    So every pixel an intra unit's edges can read, inter (wave 0) or an
    earlier wave's intra, is final when its wave runs; dav1d interleaves
    the same dependency per block in decode order (recon_tmpl.c:1195)."""
    n_planes = len(plane_shapes)
    ss_hor, ss_ver, (Hp, Wp), dims = _layout(seq, n_planes, coders[0].bw,
                                             coders[0].bh)
    for pl in range(n_planes):
        ph, pw = dims[pl]
        prog.op("embed", pl, Hp, Wp, ph, pw, PADT)
    _emit_palette(prog, coders, n_planes, ss_hor, ss_ver)
    _emit_residuals(prog, iplans, seq.bitdepth)
    _emit_scan(prog, seq, fhdr, coders, n_planes, ss_hor, ss_ver)
    for pl in range(n_planes):
        ph, pw = dims[pl]
        fh, fw = plane_shapes[pl]
        prog.op("crop", pl, PADT, PADT, ph, pw, fh, fw)
