# Ported from dav1d_mirror_tpu/ops/ipred_tpu.py; get_upsample and
# get_filter_strength copied from dav1d_mirror_tpu/ops/ref/ipred.py,
# MODE_TO_ANGLE and EDGES from dav1d_mirror_tpu/ops/ref/ipred_prepare.py.
"""Batched intra predictors of the device intra engine (models/intra).

dav1d's intra kernels (src/ipred_tmpl.c:93-542, src/ipred_prepare_tmpl.c:76)
over a batch of K prediction units at once: every function takes a leading
unit dimension K. Each unit's 257-entry top-left edge buffer is rebuilt on
the device from two 130-pixel plane strips plus the host-planned
availability geometry in its parameter row, so the wave scan's only
sequential state is the reconstructed planes.

Unit parameters are an int32 (K, NPARAMS) tensor; field indices are the
P_* constants. All arithmetic is int32, as in the reference: products
wrap as int32 and right shifts of negative values are arithmetic. Where
the reference gathers through one-hot float32 matmuls (a TPU device's
cheap gather), this module indexes with integer gathers, and every index
is clamped into its source: a window start as JAX clamps a dynamic_slice
start, an element index into the vector (the reference's callers keep
the indices of the selected mode in range, so the clamp only touches
lanes whose result the final mode select discards).
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.tables import TABLES

# physical output tile (units larger than this are split into windows)
TILE = 16
# padded-plane margins (models/intra pads planes with these)
PAD = 160  # right/bottom margin; left/top margin is PADT
PADT = 8

# implementation modes (dav1d src/ipred.h order) + extras
(DC_PRED, VERT_PRED, HOR_PRED, LEFT_DC_PRED, TOP_DC_PRED, DC_128_PRED,
 Z1_PRED, Z2_PRED, Z3_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
 PAETH_PRED, FILTER_PRED) = range(14)
CFL_MODE = 14
PAL_MODE = 15

# ---- param vector fields ----
(P_PLANE, P_PX, P_PY, P_OX, P_OY, P_W, P_H, P_MODE,
 P_HAVE_LEFT, P_HAVE_TOP, P_NEEDS_LEFT, P_NEEDS_TOP, P_NEEDS_TL,
 P_NEEDS_TR, P_NEEDS_BL, P_PXH_LEFT, P_PXH_BL, P_PXH_TOP, P_PXH_TR,
 P_HTFR, P_Z2TLF,
 P_DC_USE_TOP, P_DC_USE_LEFT, P_DC_BIAS, P_DC_SH1, P_DC_MULT, P_DC_SH2,
 P_DX, P_DY, P_US_ABOVE, P_US_LEFT, P_FS_ABOVE, P_FS_LEFT,
 P_MAX_BASE_X, P_MAX_BASE_Y,
 P_FLT_SZ_T, P_FLT_LIM_FROM_T, P_FLT_LIM_TO_T, P_FLT_FRM_T, P_FLT_TO_T,
 P_FLT_SZ_L, P_FLT_LIM_FROM_L, P_FLT_LIM_TO_L, P_FLT_FRM_L, P_FLT_TO_L,
 P_UPS_HSZ_T, P_UPS_FRM_T, P_UPS_TO_T,
 P_UPS_HSZ_L, P_UPS_FRM_L, P_UPS_TO_L,
 P_MISC,           # filter: filt_idx; cfl: alpha (signed)
 P_YSRC_X, P_YSRC_Y, P_CFL_WCL, P_CFL_HCL, P_CFL_LOG2SZ,
 P_BPX, P_BPY, P_VALID) = range(60)
NPARAMS = 60

C = 128  # edge-buffer center

MODE_TO_ANGLE = [90, 180, 45, 135, 113, 157, 203, 67]

# needs_left, needs_top, needs_topleft, needs_topright, needs_bottomleft
EDGES = {
    DC_PRED: (1, 1, 0, 0, 0),
    VERT_PRED: (0, 1, 0, 0, 0),
    HOR_PRED: (1, 0, 0, 0, 0),
    LEFT_DC_PRED: (1, 0, 0, 0, 0),
    TOP_DC_PRED: (0, 1, 0, 0, 0),
    DC_128_PRED: (0, 0, 0, 0, 0),
    Z1_PRED: (0, 1, 1, 1, 0),
    Z2_PRED: (1, 1, 1, 0, 0),
    Z3_PRED: (1, 0, 1, 0, 1),
    SMOOTH_PRED: (1, 1, 0, 0, 0),
    SMOOTH_V_PRED: (1, 1, 0, 0, 0),
    SMOOTH_H_PRED: (1, 1, 0, 0, 0),
    PAETH_PRED: (1, 1, 1, 0, 0),
    FILTER_PRED: (1, 1, 1, 0, 0),
}

# mode families pred_main_tile computes (a wave computes only the
# families its units use; None = all)
FAMILIES = ("dc", "vh", "paeth", "smooth", "z1", "z2", "z3", "cfl", "pal")
FAMILY_OF = {DC_PRED: "dc", LEFT_DC_PRED: "dc", TOP_DC_PRED: "dc",
             DC_128_PRED: "dc", VERT_PRED: "vh", HOR_PRED: "vh",
             PAETH_PRED: "paeth", SMOOTH_PRED: "smooth",
             SMOOTH_V_PRED: "smooth", SMOOTH_H_PRED: "smooth",
             Z1_PRED: "z1", Z2_PRED: "z2", Z3_PRED: "z3", CFL_MODE: "cfl",
             PAL_MODE: "pal"}


def get_filter_strength(wh, angle, is_sm):
    if is_sm:
        if wh <= 8:
            if angle >= 64:
                return 2
            if angle >= 40:
                return 1
        elif wh <= 16:
            if angle >= 48:
                return 2
            if angle >= 20:
                return 1
        elif wh <= 24:
            if angle >= 4:
                return 3
        else:
            return 3
    else:
        if wh <= 8:
            if angle >= 56:
                return 1
        elif wh <= 16:
            if angle >= 40:
                return 1
        elif wh <= 24:
            if angle >= 32:
                return 3
            if angle >= 16:
                return 2
            if angle >= 8:
                return 1
        elif wh <= 32:
            if angle >= 32:
                return 3
            if angle >= 4:
                return 2
            return 1
        else:
            return 3
    return 0


def get_upsample(wh, angle, is_sm):
    return int(angle < 40 and wh <= (16 >> is_sm))


def _filter_taps():
    raw = np.asarray(TABLES["filter_intra_taps"], np.int64).astype(np.int32)
    out = np.zeros((5, 8, 7), np.int32)
    for f in range(5):
        for k in range(8):
            out[f, k] = [raw[f, 2 * k], raw[f, 2 * k + 1],
                         raw[f, 16 + 2 * k], raw[f, 16 + 2 * k + 1],
                         raw[f, 32 + 2 * k], raw[f, 32 + 2 * k + 1],
                         raw[f, 48 + 2 * k]]
    return out


_FILTER_TAPS_NP = _filter_taps()
_EDGE_KERNELS_NP = np.array([[0, 4, 8, 4, 0], [0, 5, 6, 5, 0],
                             [2, 4, 4, 4, 2]], np.int32)
# padded so w+ox..+16 windows stay in-bounds for any (w<=64, ox<=48)
_SM_WEIGHTS_PAD_NP = np.concatenate(
    [np.asarray(TABLES["sm_weights"], np.int32), np.zeros(32, np.int32)])
_UPS_K_NP = np.asarray([-1, 9, 9, -1], np.int32)

_CONST = {}


def _const(name, device):
    """Per-device copy of a constant table (built on first use)."""
    key = (name, str(device))
    t = _CONST.get(key)
    if t is None:
        src = {"taps": _FILTER_TAPS_NP, "edge_k": _EDGE_KERNELS_NP,
               "smw": _SM_WEIGHTS_PAD_NP, "ups_k": _UPS_K_NP}[name]
        t = _CONST[key] = torch.from_numpy(src).to(device)
    return t


def _ar(n, device, start=0):
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


def _col(p, f, nd=1):
    """Field f of every unit as a (K, 1, ...) column (nd trailing 1s)."""
    return p[:, f].reshape((-1,) + (1,) * nd)


def _kb(x, nd):
    """A (K,) tensor as (K, 1, ...) (nd trailing 1s); ints pass."""
    if isinstance(x, torch.Tensor):
        return x.reshape((-1,) + (1,) * nd)
    return x


def _clip(x, lo, hi):
    """jnp.clip: max(x, lo), then min(., hi) (so hi wins if lo > hi)."""
    x = torch.maximum(x, lo) if isinstance(lo, torch.Tensor) else \
        x.clamp(min=lo)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) else \
        x.clamp(max=hi)


def _min(a, b):
    """min of two (K, ...) tensors or ints, elementwise."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not isinstance(a, torch.Tensor):
            a, b = b, a
        return torch.minimum(a, b) if isinstance(b, torch.Tensor) else \
            a.clamp(max=b)
    return min(a, b)


def _take(vec, idx):
    """vec: (K, n); idx: (K, ...) in any range. Returns vec[k, idx[k, ...]]
    with idx clamped into [0, n-1]."""
    n = vec.shape[1]
    flat = idx.reshape(idx.shape[0], -1).clamp(0, n - 1).long()
    return torch.gather(vec, 1, flat).reshape(idx.shape)


def _window(vec, start, n):
    """vec[k, start[k] : start[k] + n] with the start clamped as JAX clamps
    a dynamic_slice start. start: (K,)."""
    s = start.clamp(0, vec.shape[1] - n)
    return torch.gather(vec, 1, (s[:, None] + _ar(n, vec.device)).long())


def _isum(x, dim):
    return x.sum(dim, dtype=torch.int32)


# ------------------------------------------------------------------
# edge assembly (ipred_prepare_tmpl.c semantics, branchless)
# ------------------------------------------------------------------
def edge_build(top_strip, left_strip, p, bitdepth):
    """top_strip[k, i] = plane[py-1, px-1+i] (i in 0..129);
    left_strip[k, j] = plane[py-1+j, px-1] (j in 0..129), at each unit's
    block origin. Returns edge (K, 257) (center C=128), int32."""
    dev = p.device
    have_left = _col(p, P_HAVE_LEFT)
    have_top = _col(p, P_HAVE_TOP)
    bd_half = (1 << bitdepth) >> 1

    # fills
    fill_left = torch.where(_col(p, P_HTFR) > 0, top_strip[:, 1:2],
                            bd_half + 1)
    fill_top = torch.where(have_left > 0, left_strip[:, 1:2], bd_half - 1)

    # ---- left column (edge[C-1-j] = left[j], j = 0..127) ----
    j = _ar(128, dev)[None, :]
    szl = _col(p, P_H)
    pxh_l, pxh_bl = _col(p, P_PXH_LEFT), _col(p, P_PXH_BL)
    # combined strip index for main-left / bottom-left / replication
    last_idx = 1 + torch.minimum(szl - 1, pxh_l - 1)
    li = torch.where(j < szl, 1 + torch.minimum(j, pxh_l - 1),
                     torch.where(pxh_bl > 0,
                                 1 + szl + torch.minimum(j - szl, pxh_bl - 1),
                                 last_idx))
    lvals = _take(left_strip, li)
    # !have_left -> the whole region (incl. bottom-left, which requires
    # have_left) is the fill value
    leftv = torch.where(
        (_col(p, P_NEEDS_LEFT) > 0) &
        (j < torch.where(_col(p, P_NEEDS_BL) > 0, 2 * szl, szl)),
        torch.where(have_left > 0, lvals, fill_left), 0)

    # ---- top row (edge[C+1+i] = top[i], i = 0..127) ----
    i = j
    szt = _col(p, P_W)
    pxh_t, pxh_tr = _col(p, P_PXH_TOP), _col(p, P_PXH_TR)
    tlast_idx = 1 + torch.minimum(szt - 1, pxh_t - 1)
    ti = torch.where(i < szt, 1 + torch.minimum(i, pxh_t - 1),
                     torch.where(pxh_tr > 0,
                                 1 + szt + torch.minimum(i - szt, pxh_tr - 1),
                                 tlast_idx))
    tvals = _take(top_strip, ti)
    topv = torch.where(have_top > 0, tvals, fill_top)
    topv = torch.where(
        (_col(p, P_NEEDS_TOP) > 0) &
        (i < torch.where(_col(p, P_NEEDS_TR) > 0, 2 * szt, szt)), topv, 0)

    # ---- topleft ----
    tl_have_l = torch.where(have_top > 0, top_strip[:, 0:1],
                            left_strip[:, 1:2])
    tl_no_l = torch.where(have_top > 0, top_strip[:, 1:2], bd_half)
    tlv = torch.where(have_left > 0, tl_have_l, tl_no_l)
    tlv = torch.where(_col(p, P_NEEDS_TL) > 0, tlv, 0)

    # Z2 topleft filter (prepare_intra_edges tail); edge[C-1] = leftv[0],
    # edge[C+1] = topv[0]
    filt_tl = ((leftv[:, 0:1] + topv[:, 0:1]) * 5 + tlv * 6 + 8) >> 4
    tlv = torch.where(_col(p, P_Z2TLF) > 0, filt_tl, tlv)

    # edge = [left reversed | topleft | top]
    return torch.cat([leftv.flip(1), tlv, topv], 1).to(torch.int32)


# ------------------------------------------------------------------
# generic edge filtering / upsampling over the edge buffer
# (ops/ref/ipred.py filter_edge / upsample_edge)
# ------------------------------------------------------------------
def _edge_take(edge, base, idx, frm, to):
    """edge[k, base + clip(idx, frm, to-1)]; idx (K, n, m); base, frm,
    to: (K,) tensors or ints."""
    k = _kb(base, 2) + _clip(idx, _kb(frm, 2), _kb(to, 2) - 1)
    return _take(edge, k.expand(edge.shape[0], *k.shape[1:]))


def filter_edge_j(edge, base, sz, lim_from, lim_to, frm, to, strength,
                  n_out):
    """n_out static; returns (K, n_out). Arguments other than edge and
    n_out are (K,) tensors or ints."""
    dev = edge.device
    i = _ar(n_out, dev)[None, :]
    st = strength if isinstance(strength, torch.Tensor) else \
        torch.full((edge.shape[0],), strength, dtype=torch.int32, device=dev)
    # strengths are 0..3; strength 0 takes kernel 0 and its lanes are
    # discarded by the callers' selects
    ker = _const("edge_k", dev)[(st - 1).clamp(0, 2).long()]   # (K, 5)
    taps = _edge_take(edge, base, i[:, :, None] - 2 + _ar(5, dev)[None, None],
                      frm, to)
    s = _isum(taps * ker[:, None, :], 2)
    filt = (s + 8) >> 4
    raw = taps[:, :, 2]
    sz, lim_from, lim_to = _kb(sz, 1), _kb(lim_from, 1), _kb(lim_to, 1)
    use_raw = (i < _min(sz, lim_from)) | (i >= _min(lim_to, sz))
    return torch.where(use_raw, raw, filt)


def upsample_edge_j(edge, base, hsz, frm, to, bitdepth, n_out):
    """returns (K, n_out) with the 2*hsz-1 upsample pattern (even entries
    = src, odd = 4-tap)."""
    dev = edge.device
    i = _ar(n_out, dev)[None, :]
    half = i >> 1
    taps = _edge_take(edge, base,
                      half[:, :, None] - 1 + _ar(4, dev)[None, None], frm,
                      to)
    src = taps[:, :, 1]
    bd_max = (1 << bitdepth) - 1
    s = _isum(taps * _const("ups_k", dev)[None, None, :], 2)
    odd = ((s + 8) >> 4).clamp(0, bd_max)
    # the final entry (i == 2*(hsz-1)) is a plain copy
    return torch.where((i & 1) == 0, src, odd)


# ------------------------------------------------------------------
# per-unit main predictor: (16,16) window at (ox, oy)
# ------------------------------------------------------------------
def _dc_value(edge, p):
    """(K,) DC value of each unit."""
    i = _ar(128, edge.device)[None, :]
    top_sum = _isum(torch.where(i < _col(p, P_W), edge[:, C + 1:C + 129], 0),
                    1)
    left_sum = _isum(torch.where(i < _col(p, P_H),
                                 edge[:, C - 128:C].flip(1), 0), 1)
    dc = (p[:, P_DC_BIAS] + top_sum * p[:, P_DC_USE_TOP] +
          left_sum * p[:, P_DC_USE_LEFT]) >> p[:, P_DC_SH1]
    return (dc * p[:, P_DC_MULT]) >> p[:, P_DC_SH2]


def pred_main_tile(top_strip, left_strip, own, luma_reg, p, bitdepth,
                   ss_hor, ss_ver, fams=None):
    """top_strip/left_strip: (K, 130) strips at each unit's block origin
    (plane[bpy-1, bpx-1..], plane[bpy-1.., bpx-1]); own: (K, 16, 16) the
    current-plane window at (px, py) (palette passthrough); luma_reg:
    (K, 64, 64) luma window at (ysrc_y, ysrc_x) for CFL (may be None when
    no unit is CFL). fams: the mode families to compute (FAMILIES names;
    None = all); a unit whose family is left out predicts 0. Returns the
    (K, 16, 16) int32 prediction (clipped where the reference clips)."""
    dev = p.device
    K = p.shape[0]
    fams = set(FAMILIES) if fams is None else set(fams)
    w, h = p[:, P_W], p[:, P_H]
    mode = _col(p, P_MODE, 2)
    bd_max = (1 << bitdepth) - 1
    ox, oy = p[:, P_OX], p[:, P_OY]

    edge = edge_build(top_strip, left_strip, p, bitdepth)

    ar16 = _ar(TILE, dev)
    gxb = (ox[:, None, None] + ar16[None, None, :]).expand(K, TILE, TILE)
    gyb = (oy[:, None, None] + ar16[None, :, None]).expand(K, TILE, TILE)

    # top/left rows are contiguous windows of the edge buffer
    top_g = _window(edge, C + 1 + ox, TILE)[:, None, :]
    left_g = _window(edge, C - TILE - oy, TILE).flip(1)[:, :, None]
    tl = edge[:, C, None, None]

    pred = torch.zeros((K, TILE, TILE), dtype=torch.int32, device=dev)

    def put(cond, val):
        nonlocal pred
        pred = torch.where(cond, val, pred)

    dc = None
    if fams & {"dc", "cfl"}:
        dc = _dc_value(edge, p)
    if "dc" in fams:
        is_dc = (mode == DC_PRED) | (mode == LEFT_DC_PRED) | \
                (mode == TOP_DC_PRED) | (mode == DC_128_PRED)
        put(is_dc, dc[:, None, None])
    if "vh" in fams:
        put(mode == VERT_PRED, top_g)
        put(mode == HOR_PRED, left_g)
    if "paeth" in fams:
        base = left_g + top_g - tl
        ldiff = (left_g - base).abs()
        tdiff = (top_g - base).abs()
        tldiff = (tl - base).abs()
        paeth = torch.where((ldiff <= tdiff) & (ldiff <= tldiff), left_g,
                            torch.where(tdiff <= tldiff, top_g, tl))
        put(mode == PAETH_PRED, paeth)
    if "smooth" in fams:
        smw = _const("smw", dev)[None, :].expand(K, -1)
        wh_w = _window(smw, w + ox, TILE)[:, None, :]
        wv_w = _window(smw, h + oy, TILE)[:, :, None]
        sc = _take(edge, torch.stack([C + w, C - h], 1))
        right = sc[:, 0, None, None]
        bottom = sc[:, 1, None, None]
        vpart = wv_w * top_g + (256 - wv_w) * bottom
        hpart = wh_w * left_g + (256 - wh_w) * right
        put(mode == SMOOTH_PRED, (vpart + hpart + 256) >> 9)
        put(mode == SMOOTH_V_PRED, (vpart + 128) >> 8)
        put(mode == SMOOTH_H_PRED, (hpart + 128) >> 8)

    i256 = _ar(256, dev)[None, :]
    if "z1" in fams:
        # top array: upsampled / filtered / raw, indexed 0..255
        z1_flt = filter_edge_j(edge, C + 1, p[:, P_FLT_SZ_T],
                               p[:, P_FLT_LIM_FROM_T], p[:, P_FLT_LIM_TO_T],
                               p[:, P_FLT_FRM_T], p[:, P_FLT_TO_T],
                               p[:, P_FS_ABOVE], 256)
        z1_ups = upsample_edge_j(edge, C + 1, p[:, P_UPS_HSZ_T],
                                 p[:, P_UPS_FRM_T], p[:, P_UPS_TO_T],
                                 bitdepth, 256)
        z1_raw = torch.cat([edge[:, C + 1:],
                            edge[:, 256:257].expand(K, 128)], 1)
        z_top = torch.where(_col(p, P_US_ABOVE) > 0, z1_ups,
                            torch.where(_col(p, P_FS_ABOVE) > 0, z1_flt,
                                        z1_raw))
        mbx = _col(p, P_MAX_BASE_X, 2)
        xpos1 = _col(p, P_DX, 2) * (gyb + 1)
        frac1 = xpos1 & 0x3E
        base1 = (xpos1 >> 6) + (1 + _col(p, P_US_ABOVE, 2)) * gxb
        b1c = torch.minimum(base1, mbx)
        z1v = (_take(z_top, b1c) * (64 - frac1) +
               _take(z_top, (b1c + 1).clamp(max=255)) * frac1 + 32) >> 6
        z1_last = _take(z_top, mbx)
        put(mode == Z1_PRED, torch.where(base1 < mbx, z1v, z1_last))

    if "z3" in fams:
        # left array: larr[k] == "left_arr[left_c - k]"
        z3_flt = filter_edge_j(edge, C - (w + h), p[:, P_FLT_SZ_L],
                               p[:, P_FLT_LIM_FROM_L], p[:, P_FLT_LIM_TO_L],
                               p[:, P_FLT_FRM_L], p[:, P_FLT_TO_L],
                               p[:, P_FS_LEFT], 256)
        z3_ups = upsample_edge_j(edge, C - (w + h), p[:, P_UPS_HSZ_L],
                                 p[:, P_UPS_FRM_L], p[:, P_UPS_TO_L],
                                 bitdepth, 256)
        # raw: left_arr = tl, left_c = C-1 -> larr[k] = edge[C-1-k]
        z3_raw = torch.cat([edge[:, :C].flip(1),
                            edge[:, 0:1].expand(K, 128)], 1)
        wh = (w + h)[:, None]
        # filtered: left_c = w+h-1; upsampled: left_c = 2*(w+h)-2
        k_f = (wh - 1 - i256).clamp(0, 255)
        k_u = (2 * wh - 2 - i256).clamp(0, 255)
        z_left = torch.where(_col(p, P_US_LEFT) > 0, _take(z3_ups, k_u),
                             torch.where(_col(p, P_FS_LEFT) > 0,
                                         _take(z3_flt, k_f), z3_raw))
        mby = _col(p, P_MAX_BASE_Y, 2)
        ypos3 = _col(p, P_DY, 2) * (gxb + 1)
        frac3 = ypos3 & 0x3E
        base3 = (ypos3 >> 6) + (1 + _col(p, P_US_LEFT, 2)) * gyb
        b3c = torch.minimum(base3, mby)
        z3v = (_take(z_left, b3c) * (64 - frac3) +
               _take(z_left, (b3c + 1).clamp(max=255)) * frac3 + 32) >> 6
        z3_last = _take(z_left, mby)
        put(mode == Z3_PRED, torch.where(base3 < mby, z3v, z3_last))

    if "z2" in fams:
        # edge2: 129 entries, center EC=64 (ops/ref/ipred.py _z2)
        EC = 64
        e2i = _ar(129, dev)[None, :]
        us_a, us_l = _col(p, P_US_ABOVE), _col(p, P_US_LEFT)
        fs_a, fs_l = _col(p, P_FS_ABOVE), _col(p, P_FS_LEFT)
        z2t_ups = upsample_edge_j(edge, C, w + 1, 0, w + 1, bitdepth, 129)
        z2t_flt = filter_edge_j(edge, C + 1, w, 0, p[:, P_FLT_LIM_TO_T], -1,
                                w, p[:, P_FS_ABOVE], 129)
        kk = e2i - EC  # offset from center (top side: kk >= 1)
        top_part = torch.where(
            us_a > 0, _take(z2t_ups, kk.clamp(0, 128).expand(K, 129)),
            torch.where(fs_a > 0,
                        _take(z2t_flt, (kk - 1).clamp(0, 128).expand(K, 129)),
                        edge[:, C - EC:C - EC + 129]))
        z2l_ups = upsample_edge_j(edge, C - h, h + 1, 0, h + 1, bitdepth,
                                  129)
        z2l_flt = filter_edge_j(edge, C - h, h, h - p[:, P_FLT_LIM_TO_L], h,
                                0, h + 1, p[:, P_FS_LEFT], 129)
        neg = EC - e2i  # left side: neg >= 1; edge2[EC - n]
        h1 = h[:, None]
        lu = _take(z2l_ups, 2 * h1 - neg)
        lf = _take(z2l_flt, h1 - neg)
        lr_ = _take(edge, (C - neg.clamp(0, 128)).expand(K, 129))
        left_part = torch.where(us_l > 0, lu, torch.where(fs_l > 0, lf, lr_))
        edge2 = torch.where(e2i > EC, top_part,
                            torch.where(e2i < EC, left_part,
                                        edge[:, C:C + 1]))
        us_a2, us_l2 = _col(p, P_US_ABOVE, 2), _col(p, P_US_LEFT, 2)
        xpos2 = ((1 + us_a2) << 6) - _col(p, P_DX, 2) * (gyb + 1)
        base_x2 = (xpos2 >> 6) + (1 + us_a2) * gxb
        frac_x2 = xpos2 & 0x3E
        ypos2 = (gyb << (6 + us_l2)) - _col(p, P_DY, 2) * (gxb + 1)
        base_y2 = ypos2 >> 6
        frac_y2 = ypos2 & 0x3E
        left_c2 = EC - (1 + us_l2)
        vx = (_take(edge2, EC + base_x2) * (64 - frac_x2) +
              _take(edge2, EC + base_x2 + 1) * frac_x2)
        vy = (_take(edge2, left_c2 - base_y2) * (64 - frac_y2) +
              _take(edge2, left_c2 - (base_y2 + 1)) * frac_y2)
        put(mode == Z2_PRED, (torch.where(base_x2 >= 0, vx, vy) + 32) >> 6)

    if "cfl" in fams:
        ds = _cfl_ac_ds(luma_reg, ss_hor, ss_ver)     # (K, 32, 32)
        # replicate-pad (rows/columns past the coded size repeat the last
        # one) + mean removal
        ar32 = _ar(32, dev)[None, :]
        rsel = torch.minimum(ar32, _col(p, P_CFL_HCL) - 1).clamp(min=0)
        csel = torch.minimum(ar32, _col(p, P_CFL_WCL) - 1).clamp(min=0)
        rows = torch.gather(ds, 1, rsel.long()[:, :, None].expand(K, 32, 32))
        ac_full = torch.gather(rows, 2,
                               csel.long()[:, None, :].expand(K, 32, 32))
        mask = (ar32[:, :, None] < h[:, None, None]) & \
               (ar32[:, None, :] < w[:, None, None])
        total = _isum(torch.where(mask, ac_full, 0).reshape(K, -1), 1)
        log2sz = p[:, P_CFL_LOG2SZ]
        avg = (total + ((torch.ones_like(log2sz) << log2sz) >> 1)) >> log2sz
        ac = torch.nn.functional.pad(ac_full - avg[:, None, None],
                                     (0, TILE, 0, TILE))
        r0 = oy.clamp(0, 32 + TILE - TILE)
        c0 = ox.clamp(0, 32 + TILE - TILE)
        ac_win = torch.gather(
            ac, 1, (r0[:, None] + ar16[None]).long()[:, :, None].expand(
                K, TILE, 32 + TILE))
        ac_win = torch.gather(
            ac_win, 2, (c0[:, None] + ar16[None]).long()[:, None, :].expand(
                K, TILE, TILE))
        diff = _col(p, P_MISC, 2) * ac_win
        cfl = dc[:, None, None] + torch.sign(diff) * ((diff.abs() + 32) >> 6)
        put(mode == CFL_MODE, cfl.clamp(0, bd_max))

    if "pal" in fams:
        # palette pixels (or an earlier wave's CFL prediction) are already
        # in the plane: pass the window through
        put(mode == PAL_MODE, own)
    return pred


def _cfl_ac_ds(luma_reg, ss_hor, ss_ver):
    """Downsampled (K, 32, 32) luma for CFL ac (ops/ref/ipred.py
    cfl_ac_ref inner sum), scaled by << (1 + !ss_ver + !ss_hor)."""
    ysub = luma_reg[:, :(32 << ss_ver), :(32 << ss_hor)]
    s = ysub[:, ::(1 << ss_ver), ::(1 << ss_hor)].to(torch.int32)
    if ss_hor:
        s = s + ysub[:, ::(1 << ss_ver), 1::2]
    if ss_ver:
        s = s + ysub[:, 1::2, ::(1 << ss_hor)]
        if ss_hor:
            s = s + ysub[:, 1::2, 1::2]
    return s << (1 + (not ss_ver) + (not ss_hor))


# ------------------------------------------------------------------
# filter intra: one 4x4 cell (two sequential 4x2 units)
# ------------------------------------------------------------------
def gather_window(plane_flat, Hp, Wp, y0, x0, hh, ww, base=0):
    """(K, hh, ww) windows of a flattened (.., Hp, Wp) plane stack at
    (y0, x0) of the plane starting at flat offset `base` ((K,) or int),
    the start clamped as JAX clamps a dynamic_slice start."""
    dev = y0.device
    ys = y0.clamp(0, Hp - hh)[:, None, None] + _ar(hh, dev)[None, :, None]
    xs = x0.clamp(0, Wp - ww)[:, None, None] + _ar(ww, dev)[None, None, :]
    return plane_flat[(_kb(base, 2) + ys * Wp + xs).long()]


def pred_filter_cell(plane, predp, p, bitdepth):
    """(K, 4, 4) int32 prediction of filter-intra cells at (px, py) inside
    their parent blocks at (bpx, bpy). plane, predp: the padded (Hp, Wp)
    luma plane and filter-intra prediction plane. In-block neighbour
    pixels come from the prediction plane; block-external edges from the
    reconstructed plane via the standard edge buffer."""
    Hp, Wp = plane.shape
    pf, qf = plane.reshape(-1), predp.reshape(-1)
    dev = p.device
    K = p.shape[0]
    px, py = p[:, P_PX], p[:, P_PY]
    bpx, bpy = p[:, P_BPX], p[:, P_BPY]
    bd_max = (1 << bitdepth) - 1
    flt = _const("taps", dev)[p[:, P_MISC].clamp(0, 4).long()]   # (K, 8, 7)

    # edge buffer of the parent block
    top_strip = gather_window(pf, Hp, Wp, bpy - 1 + PADT, bpx - 1 + PADT,
                              1, 130)[:, 0]
    left_strip = gather_window(pf, Hp, Wp, bpy - 1 + PADT, bpx - 1 + PADT,
                               130, 1)[:, :, 0]
    edge = edge_build(top_strip, left_strip, p, bitdepth)

    ox, oy = _col(p, P_OX), _col(p, P_OY)

    # top row source (y = -1 relative to the cell): 5 pixels at x-1..x+3,
    # from the prediction plane if oy > 0 else from the block's top edge
    # (x == -1 of the block: the topleft edge[C])
    xi = _ar(5, dev, -1)[None, :]
    ptop = gather_window(qf, Hp, Wp, py - 1 + PADT, px - 1 + PADT, 1,
                         5)[:, 0]
    etop = torch.where(ox + xi >= 0,
                       _take(edge, C + 1 + (ox + xi).clamp(0, 127)),
                       edge[:, C:C + 1])
    top5 = torch.where(oy > 0, ptop, etop)
    # the corner (x-1, y-1) when oy > 0 and ox == 0 comes from the block's
    # left edge at row oy-1
    corner_left_edge = _take(edge, C - 1 - (oy - 1).clamp(0, 127))
    top5 = torch.cat([torch.where((oy > 0) & (ox == 0), corner_left_edge,
                                  top5[:, 0:1]), top5[:, 1:]], 1)

    # left column source (x = -1), rows oy..oy+3: the prediction plane if
    # ox > 0 else the block's left edge
    pleft = gather_window(qf, Hp, Wp, py + PADT, px - 1 + PADT, 4,
                          1)[:, :, 0]
    eleft = _window(edge, C - 4 - oy[:, 0], 4).flip(1)
    left4 = torch.where(ox > 0, pleft, eleft)

    def unit(top_row, uy):
        # top_row: 5 px (x-1..x+3) above this 4x2 unit
        pxv = torch.cat([top_row, left4[:, 2 * uy:2 * uy + 2]], 1)  # (K, 7)
        acc = _isum(flt * pxv[:, None, :], 2)                        # (K, 8)
        return ((acc + 8) >> 4).clamp(0, bd_max).reshape(K, 2, 4)

    out0 = unit(top5, 0)
    # unit 1 top row: (x-1) = left4[1]; x..x+3 = unit 0's second row
    out1 = unit(torch.cat([left4[:, 1:2], out0[:, 1]], 1), 1)
    return torch.cat([out0, out1], 1)
