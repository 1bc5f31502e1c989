"""CDEF as PyTorch ops on int32 planes (bit-exact).

Port of ``dav1d_mirror_tpu/ops/cdef_tpu.py``. Every 8x8 block is
independent (reads come from the pre-CDEF snapshot). The direction search
sums each block's pixels into the partial-sum bins of the eight cost
classes; the constrained filter reads its taps from 25 shifted views of
the padded plane, picked per pixel by the block's direction.

The reference sums the bins with a float32 one-hot matmul; here the sums
are integer gathers, which give the same (exact) integers without going
through a matrix unit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .spec_consts import CDEF_DIRECTIONS

MISSING = -32768

# ---- direction search constants ----
_DIV = np.array([840, 420, 280, 210, 168, 140, 120], np.int64)


def _build_partial_mats():
    """Returns, for the 8 cost classes in dav1d's cost order (diag0,
    alt0, hv0, alt1, diag1, alt2, hv1, alt3), the one-hot pixel-to-bin
    assignment (64, nbins)."""
    fns = {
        0: (15, lambda y, x: y + x),            # partial_sum_diag[0]
        1: (11, lambda y, x: y + (x >> 1)),     # partial_sum_alt[0]
        2: (8, lambda y, x: y),                 # hv[0]
        3: (11, lambda y, x: 3 + y - (x >> 1)),  # alt[1]
        4: (15, lambda y, x: 7 + y - x),        # diag[1]
        5: (11, lambda y, x: 3 - (y >> 1) + x),  # alt[2]
        6: (8, lambda y, x: x),                 # hv[1]
        7: (11, lambda y, x: (y >> 1) + x),     # alt[3]
    }
    out = []
    for n in range(8):
        nbins, fn = fns[n]
        A = np.zeros((64, nbins), np.int32)
        for y in range(8):
            for x in range(8):
                A[y * 8 + x, fn(y, x)] = 1
        out.append(A)
    return out


def _cost_weights():
    """Per-class weight vectors for the squared partial sums."""
    d = _DIV
    diag_w = np.zeros(15, np.int64)
    for n in range(7):
        diag_w[n] = d[n]
        diag_w[14 - n] = d[n]
    diag_w[7] = 105
    hv_w = np.full(8, 105, np.int64)
    alt_w = np.zeros(11, np.int64)
    alt_w[3:8] = 105
    for m in range(3):
        alt_w[m] = d[2 * m + 1]
        alt_w[10 - m] = d[2 * m + 1]
    return [diag_w, alt_w, hv_w, alt_w, diag_w, alt_w, hv_w, alt_w]


def _bin_members():
    """Pixel indices of every bin of every class, padded with 64 (an
    always-zero column): (8, 15, 8) int64 plus the (8, 15) weights (0 on
    the padding bins of the 11- and 8-bin classes)."""
    mats = _build_partial_mats()
    weights = _cost_weights()
    members = np.full((8, 15, 8), 64, np.int64)
    w = np.zeros((8, 15), np.int64)
    for n, A in enumerate(mats):
        for b in range(A.shape[1]):
            px = np.nonzero(A[:, b])[0]
            members[n, b, :len(px)] = px
        w[n, :A.shape[1]] = weights[n]
    return members, w


_MEMBERS, _BIN_W = _bin_members()

# tap shift pool: all (dy, dx) with |dy|<=2, |dx|<=2
_SHIFTS = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)]
_SHIFT_IDX = {s: i for i, s in enumerate(_SHIFTS)}


def _tap_maps():
    """For each dir 0..7: pri taps (4 entries: +-off for k=0,1) and sec taps
    (8 entries), as indices into the shift pool."""
    pri = np.zeros((8, 2, 2), np.int64)  # [dir][k][sign]
    sec = np.zeros((8, 2, 2, 2), np.int64)  # [dir][class(2|0)][k][sign]
    for dir_ in range(8):
        for k in range(2):
            dy, dx = CDEF_DIRECTIONS[dir_ + 2][k]
            pri[dir_, k, 0] = _SHIFT_IDX[(dy, dx)]
            pri[dir_, k, 1] = _SHIFT_IDX[(-dy, -dx)]
            for ci, doff in enumerate((4, 0)):
                dy2, dx2 = CDEF_DIRECTIONS[dir_ + doff][k]
                sec[dir_, ci, k, 0] = _SHIFT_IDX[(dy2, dx2)]
                sec[dir_, ci, k, 1] = _SHIFT_IDX[(-dy2, -dx2)]
    return pri, sec


_PRI_TAPS, _SEC_TAPS = _tap_maps()

UV_DIRS_TBL = np.array([[0, 1, 2, 3, 4, 5, 6, 7],
                        [7, 0, 2, 4, 5, 6, 6, 6]], np.int64)


@functools.lru_cache(maxsize=None)
def _consts(device):
    t = functools.partial(torch.as_tensor, device=device)
    return dict(members=t(_MEMBERS), bin_w=t(_BIN_W), pri=t(_PRI_TAPS),
                sec=t(_SEC_TAPS), uv=t(UV_DIRS_TBL))


def cdef_dir(plane, h8, w8, bitdepth):
    """plane: (H, W) >= (h8*8, w8*8). Returns (dir (h8, w8), var (h8, w8))
    int32."""
    c = _consts(plane.device)
    bd_m8 = bitdepth - 8
    px = (plane[:h8 * 8, :w8 * 8].to(torch.int32) >> bd_m8) - 128
    blocks = px.reshape(h8, 8, w8, 8).permute(0, 2, 1, 3).reshape(-1, 64)
    blocks = torch.cat([blocks.to(torch.int64),
                        blocks.new_zeros((blocks.shape[0], 1),
                                         dtype=torch.int64)], dim=1)
    # (nblk, 8 classes, 15 bins): each bin sums its <= 8 member pixels
    sums = blocks[:, c["members"]].sum(dim=-1)
    # costs wrap like the reference's `unsigned cost[8]` (uint32)
    cost = ((sums * sums * c["bin_w"]) & 0xFFFFFFFF).sum(dim=-1) \
        & 0xFFFFFFFF
    best_dir = torch.argmax(cost, dim=1)   # first max, as the scan
    best_cost = cost.gather(1, best_dir[:, None])[:, 0]
    alt = cost.gather(1, (best_dir ^ 4)[:, None])[:, 0]
    var = ((best_cost - alt) >> 10).to(torch.int32)
    return (best_dir.to(torch.int32).reshape(h8, w8),
            var.reshape(h8, w8))


def _constrain_v(diff, threshold, shift):
    adiff = torch.abs(diff)
    v = torch.minimum(adiff, (threshold - (adiff >> shift)).clamp(min=0))
    return torch.where(diff >= 0, v, -v)


def _ulog2(x):
    """floor(log2(x)) for x >= 1, elementwise (x <= 2^16)."""
    r = torch.zeros_like(x)
    v = x
    for sh in (8, 4, 2, 1):
        m = v >= (1 << sh)
        r = r + torch.where(m, sh, 0).to(r.dtype)
        v = torch.where(m, v >> sh, v)
    return r


def cdef_filter_plane(plane, src, dir_map, pri_map, sec_map, damping,
                      active, bitdepth, bw, bh, halo=None):
    """plane/src: (H, W) int32 (src = pre-CDEF snapshot); dir_map,
    pri_map, sec_map, active: per-block (hb, wb) maps at this plane's
    block size (bw x bh px); damping scalar. Frame borders use MISSING
    padding. Only the first (hb*bh, wb*bw) region is filtered. Returns a
    new plane.

    halo: optional (top2, bot2), real pre-CDEF pixel rows ((2, W) each)
    to use above/below the region instead of MISSING: the row bands of
    parallel/filter_shard, whose boundaries are frame-interior."""
    c = _consts(plane.device)
    hb, wb = dir_map.shape
    H = hb * bh
    W = wb * bw
    reg = src[:H, :W].to(torch.int32)
    pad = reg.new_full((H + 4, W + 4), MISSING)
    pad[2:2 + H, 2:2 + W] = reg
    if halo is not None:
        top2, bot2 = halo
        pad[0:2, 2:2 + W] = top2[:, :W]
        pad[H + 2:H + 4, 2:2 + W] = bot2[:, :W]
    shifts = torch.stack([pad[2 + dy:2 + dy + H, 2 + dx:2 + dx + W]
                          for (dy, dx) in _SHIFTS], dim=0)  # (25, H, W)

    def expand(a):
        return a.repeat_interleave(bh, dim=0).repeat_interleave(bw, dim=1)

    dir_px = expand(dir_map).long()
    pri_px = expand(pri_map)
    sec_px = expand(sec_map)
    act_px = expand(active)

    px = reg
    bd_m8 = bitdepth - 8
    pri_tap0 = 4 - ((pri_px >> bd_m8) & 1)
    pri_shift = (damping - _ulog2(pri_px.clamp(min=1))).clamp(min=0)
    sec_shift = damping - _ulog2(sec_px.clamp(min=1))

    sum_ = torch.zeros_like(px)
    mn = px
    mx = px
    have_pri = pri_px > 0
    have_sec = sec_px > 0
    use_minmax = have_pri & have_sec

    def tap(table):
        """Per-pixel tap: shift-pool entry table[dir] of each pixel."""
        return torch.gather(shifts, 0, table[dir_px][None])[0]

    for k in range(2):
        tapk = pri_tap0 if k == 0 else ((pri_tap0 & 3) | 2)
        for sign in range(2):
            p = tap(c["pri"][:, k, sign])
            valid = (p != MISSING) & have_pri
            cv = _constrain_v(p - px, pri_px, pri_shift)
            sum_ = sum_ + torch.where(valid, tapk * cv, 0)
            mn = torch.where(valid & use_minmax, torch.minimum(mn, p), mn)
            mx = torch.where(valid & use_minmax, torch.maximum(mx, p), mx)
        for ci in range(2):
            for sign in range(2):
                s = tap(c["sec"][:, ci, k, sign])
                valid = (s != MISSING) & have_sec
                cv = _constrain_v(s - px, sec_px, sec_shift)
                sum_ = sum_ + torch.where(valid, (2 - k) * cv, 0)
                mn = torch.where(valid & use_minmax, torch.minimum(mn, s),
                                 mn)
                mx = torch.where(valid & use_minmax, torch.maximum(mx, s),
                                 mx)

    v = px + ((sum_ - (sum_ < 0).to(torch.int32) + 8) >> 4)
    v = torch.where(use_minmax, torch.minimum(torch.maximum(v, mn), mx), v)
    out = plane.to(torch.int32, copy=True)
    out[:H, :W] = torch.where(act_px & (have_pri | have_sec), v,
                              out[:H, :W])
    return out


def adjust_strength_v(strength, var):
    vs = var >> 6
    i = torch.where(vs > 0, _ulog2(vs.clamp(min=1)).clamp(max=12), 0)
    adj = (strength * (4 + i) + 8) >> 4
    return torch.where(var > 0, adj, 0)


def cdef_frame(planes, cdef_idx_map, noskip4, y_strengths, uv_strengths,
               damping, bitdepth, ss_hor, ss_ver, monochrome):
    """planes: tuple of (H, W) int32; cdef_idx_map: (n64y, n64x) int32;
    noskip4: (bh4, bw4) bool; y/uv_strengths: (8,) int32 header strengths.
    Returns filtered planes (same shapes)."""
    c = _consts(planes[0].device)
    bd_m8 = bitdepth - 8
    bh4, bw4 = noskip4.shape
    h8, w8 = (bh4 + 1) // 2, (bw4 + 1) // 2

    # per-8x8 maps
    idx8 = cdef_idx_map.repeat_interleave(8, dim=0).repeat_interleave(
        8, dim=1)[:h8, :w8]
    ns = noskip4.to(torch.int8)
    if bh4 % 2 or bw4 % 2:
        ns = torch.nn.functional.pad(ns, (0, bw4 % 2, 0, bh4 % 2))
    ns8 = (ns.reshape(h8, 2, w8, 2) != 0).any(dim=3).any(dim=1)
    valid = (idx8 >= 0) & ns8
    sel = idx8.clamp(min=0).long()
    y_lvl = y_strengths[sel]
    uv_lvl = uv_strengths[sel]
    valid = valid & ((y_lvl > 0) | (uv_lvl > 0))

    y_pri = (y_lvl >> 2) << bd_m8
    y_sec0 = y_lvl & 3
    y_sec = (y_sec0 + (y_sec0 == 3).to(y_sec0.dtype)) << bd_m8
    uv_pri = (uv_lvl >> 2) << bd_m8
    uv_sec0 = uv_lvl & 3
    uv_sec = (uv_sec0 + (uv_sec0 == 3).to(uv_sec0.dtype)) << bd_m8

    dirm, varm = cdef_dir(planes[0], h8, w8, bitdepth)
    y_adj = adjust_strength_v(y_pri, varm)
    pri_map = torch.where(y_pri > 0, y_adj, 0)
    dir_y = torch.where(y_pri > 0, dirm, 0)
    act_y = valid & (y_lvl > 0)

    p0 = planes[0].to(torch.int32)
    outs = [cdef_filter_plane(p0, p0, dir_y, pri_map,
                              torch.where(act_y, y_sec, 0), damping, act_y,
                              bitdepth, 8, 8)]
    if not monochrome:
        uvd = c["uv"][1 if (ss_hor and not ss_ver) else 0]
        dir_uv = torch.where(uv_pri > 0, uvd[dirm.long()].to(torch.int32),
                             0)
        act_uv = valid & (uv_lvl > 0)
        for pl in (1, 2):
            pp = planes[pl].to(torch.int32)
            outs.append(cdef_filter_plane(
                pp, pp, dir_uv, torch.where(act_uv, uv_pri, 0),
                torch.where(act_uv, uv_sec, 0), damping - 1, act_uv,
                bitdepth, 8 >> ss_hor, 8 >> ss_ver))
    return tuple(outs)
