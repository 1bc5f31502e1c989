"""Deblocking as PyTorch ops on int32 planes (bit-exact).

Port of ``dav1d_mirror_tpu/ops/loopfilter_tpu.py``. AV1's filter-width
rules guarantee that all vertical edges are mutually independent (an edge
of width wd only exists where the adjacent transforms are >= wd wide, so
read/write spans never overlap), and likewise all horizontal edges. Each
pass is therefore one dense op over every 4px boundary: compute all
candidate filter outputs, then select by the per-edge width index and
level.
"""
from __future__ import annotations

import torch


def _cols(n_edges, k, size, device, base=0):
    """Column index base + 4*i + k of edge i. Low-side indices below 0
    wrap to the end of the axis, high-side ones clamp to its last entry,
    as the reference's indexing does; both only ever feed masked-off
    candidates or identity stores."""
    idx = torch.arange(n_edges, device=device) * 4 + (k + base)
    return torch.remainder(idx.clamp(max=size - 1), size)


def _filter_values(ps, qs, E, I, H, F, wd_max, bitdepth):
    """Vectorized AV1 edge filter. ps[k] = p_k, qs[k] = q_k tensors (same
    shape); E/I/H: per-edge tensors; returns {width: candidate outputs and
    masks} for every width up to wd_max."""
    p0, p1 = ps[0], ps[1]
    q0, q1 = qs[0], qs[1]
    ab = torch.abs

    fm = ((ab(p1 - p0) <= I) & (ab(q1 - q0) <= I) &
          (ab(p0 - q0) * 2 + (ab(p1 - q1) >> 1) <= E))
    if wd_max > 4:
        p2, q2 = ps[2], qs[2]
        fm6 = fm & (ab(p2 - p1) <= I) & (ab(q2 - q1) <= I)
    if wd_max > 6:
        p3, q3 = ps[3], qs[3]
        fm8 = fm6 & (ab(p3 - p2) <= I) & (ab(q3 - q2) <= I)

    out = {}
    bd_m8 = bitdepth - 8
    bd_max = (1 << bitdepth) - 1

    # wd4 path (also the fallback inside wider widths when !flat8in)
    hev = (ab(p1 - p0) > H) | (ab(q1 - q0) > H)
    lo = -128 * (1 << bd_m8)
    hi = 128 * (1 << bd_m8) - 1

    def cd(v):
        return v.clamp(lo, hi)
    f_hev = cd(3 * (q0 - p0) + cd(p1 - q1))
    f_nohev = cd(3 * (q0 - p0))
    f = torch.where(hev, f_hev, f_nohev)
    f1 = (f + 4).clamp(max=hi) >> 3
    f2 = (f + 3).clamp(max=hi) >> 3
    n4_p0 = (p0 + f2).clamp(0, bd_max)
    n4_q0 = (q0 - f1).clamp(0, bd_max)
    fo = (f1 + 1) >> 1
    n4_p1 = torch.where(hev, p1, (p1 + fo).clamp(0, bd_max))
    n4_q1 = torch.where(hev, q1, (q1 - fo).clamp(0, bd_max))
    out[4] = dict(fm=fm, p=[n4_p0, n4_p1], q=[n4_q0, n4_q1])

    if wd_max >= 6:
        flat6 = ((ab(p2 - p0) <= F) & (ab(p1 - p0) <= F) &
                 (ab(q1 - q0) <= F) & (ab(q2 - q0) <= F))
        n6_p1 = (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3
        n6_p0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
        n6_q0 = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3
        n6_q1 = (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3
        out[6] = dict(fm=fm6, flat=flat6,
                      p=[n6_p0, n6_p1], q=[n6_q0, n6_q1])

    if wd_max >= 8:
        flat8 = flat6 & (ab(p3 - p0) <= F) & (ab(q3 - q0) <= F)
        n8_p2 = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3
        n8_p1 = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3
        n8_p0 = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3
        n8_q0 = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3
        n8_q1 = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3
        n8_q2 = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3
        out[8] = dict(fm=fm8, flat=flat8,
                      p=[n8_p0, n8_p1, n8_p2], q=[n8_q0, n8_q1, n8_q2])

    if wd_max >= 16:
        p4, p5, p6 = ps[4], ps[5], ps[6]
        q4, q5, q6 = qs[4], qs[5], qs[6]
        flat8out = ((ab(p6 - p0) <= F) & (ab(p5 - p0) <= F) &
                    (ab(p4 - p0) <= F) & (ab(q4 - q0) <= F) &
                    (ab(q5 - q0) <= F) & (ab(q6 - q0) <= F))
        n16 = {}
        n16["p5"] = (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0
                     + 8) >> 4
        n16["p4"] = (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0
                     + q1 + 8) >> 4
        n16["p3"] = (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0
                     + q1 + q2 + 8) >> 4
        n16["p2"] = (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0
                     + q1 + q2 + q3 + 8) >> 4
        n16["p1"] = (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0
                     + q1 + q2 + q3 + q4 + 8) >> 4
        n16["p0"] = (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1
                     + q2 + q3 + q4 + q5 + 8) >> 4
        n16["q0"] = (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2
                     + q3 + q4 + q5 + q6 + 8) >> 4
        n16["q1"] = (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3
                     + q4 + q5 + q6 * 2 + 8) >> 4
        n16["q2"] = (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4
                     + q5 + q6 * 3 + 8) >> 4
        n16["q3"] = (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5
                     + q6 * 4 + 8) >> 4
        n16["q4"] = (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2
                     + q6 * 5 + 8) >> 4
        n16["q5"] = (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7
                     + 8) >> 4
        out[16] = dict(fm=fm8, flatout=flat8out & flat8, n=n16)
    return out


def _apply_pass(rows, edge_idx, lvl_cur, lvl_prev, e_lut, i_lut, luma,
                bitdepth, base=0):
    """One deblock pass over the columns of `rows` (n, W): every edge i
    sits between columns base+4i-1 and base+4i; edge_idx (n/4, n_edges)
    is the per-edge width class (-1 = none) and each edge spans 4 rows.
    The vertical pass runs on the plane, the horizontal one on its
    transpose (base > 0: a row band behind `base` halo rows, the
    reference's _apply_pass_h at sby4 = base / 4). Modifies `rows` in
    place (it is a view of the plane being filtered) and returns it."""
    dev = rows.device
    W = rows.shape[1]
    n_edges = edge_idx.shape[1]
    wd_max = 16 if luma else 6
    ntap = 7 if luma else 3

    L = torch.where(lvl_cur != 0, lvl_cur, lvl_prev).long()
    active = (edge_idx >= 0) & (L != 0)
    E = e_lut[L] << (bitdepth - 8)
    I = i_lut[L] << (bitdepth - 8)
    Hh = (L.to(torch.int32) >> 4) << (bitdepth - 8)
    F = 1 << (bitdepth - 8)

    # expand per-edge values to per-row granularity (each edge spans 4 rows)
    def per_row(a):
        return a.repeat_interleave(4, dim=0)

    ps = [rows[:, _cols(n_edges, -1 - k, W, dev, base)]
          for k in range(ntap)]
    qs = [rows[:, _cols(n_edges, k, W, dev, base)] for k in range(ntap)]

    E_r, I_r, H_r = per_row(E), per_row(I), per_row(Hh)
    act_r = per_row(active)
    idx_r = per_row(edge_idx)

    cand = _filter_values(ps, qs, E_r, I_r, H_r, F, wd_max, bitdepth)
    where = torch.where

    if luma:
        m4 = act_r & (idx_r == 0) & cand[4]["fm"]
        m8 = act_r & (idx_r == 1) & cand[8]["fm"]
        m8_flat = m8 & cand[8]["flat"]
        m8_fall = m8 & ~cand[8]["flat"]
        m16 = act_r & (idx_r == 2) & cand[16]["fm"]
        m16_full = m16 & cand[16]["flatout"]
        m16_8 = m16 & ~cand[16]["flatout"] & cand[8]["flat"]
        m16_fall = m16 & ~cand[16]["flatout"] & ~cand[8]["flat"]
        mw4 = m4 | m8_fall | m16_fall  # narrow filter positions
        new_p = list(ps[:6])
        new_q = list(qs[:6])
        for k in range(2):
            new_p[k] = where(mw4, cand[4]["p"][k], new_p[k])
            new_q[k] = where(mw4, cand[4]["q"][k], new_q[k])
        m8w = m8_flat | m16_8
        for k in range(3):
            new_p[k] = where(m8w, cand[8]["p"][k], new_p[k])
            new_q[k] = where(m8w, cand[8]["q"][k], new_q[k])
        n16 = cand[16]["n"]
        for k in range(6):
            new_p[k] = where(m16_full, n16[f"p{k}"], new_p[k])
            new_q[k] = where(m16_full, n16[f"q{k}"], new_q[k])
        mod = [mw4 | m8w | m16_full, mw4 | m8w | m16_full,
               m8w | m16_full, m16_full, m16_full, m16_full]
    else:
        m4 = act_r & (idx_r == 0) & cand[4]["fm"]
        m6 = act_r & (idx_r == 1) & cand[6]["fm"]
        m6_flat = m6 & cand[6]["flat"]
        m6_fall = m6 & ~cand[6]["flat"]
        mw4 = m4 | m6_fall
        new_p = list(ps[:2])
        new_q = list(qs[:2])
        for k in range(2):
            new_p[k] = where(mw4, cand[4]["p"][k], new_p[k])
            new_q[k] = where(mw4, cand[4]["q"][k], new_q[k])
        for k in range(2):
            new_p[k] = where(m6_flat, cand[6]["p"][k], new_p[k])
            new_q[k] = where(m6_flat, cand[6]["q"][k], new_q[k])
        mod = [mw4 | m6_flat, mw4 | m6_flat]

    # masked store: write streams for different taps can alias the same
    # column across neighbouring edges, so re-read the current value and
    # only overwrite where this edge actually modified the sample
    for k in range(len(mod)):
        for idx, new in ((_cols(n_edges, -1 - k, W, dev, base), new_p[k]),
                         (_cols(n_edges, k, W, dev, base), new_q[k])):
            rows[:, idx] = where(mod[k], new, rows[:, idx])
    return rows


def deblock_plane(plane, edge_v, edge_h, lvl_v, lvl_v_prev, lvl_h,
                  lvl_h_prev, e_lut, i_lut, luma, bitdepth):
    """plane: (Hp, Wp) padded; edge_v/h: (h4, w4) int32 (-1 none);
    lvl_*: per-edge levels (current and fallback neighbour); e_lut/i_lut:
    (64,) int32. Returns a new int32 plane.

    ONE global vertical pass then ONE global horizontal pass: AV1's
    filter-width rules confine every edge's read AND write span inside
    the adjacent transforms, so no edge of a pass reads pixels another
    edge of that pass writes."""
    plane = plane.to(torch.int32, copy=True)
    h4, w4 = edge_v.shape
    # vertical pass over the visible rows (x = 0 has no left neighbour:
    # force inactive); padded rows below pass through untouched
    ev = edge_v.clone()
    ev[:, 0] = -1
    _apply_pass(plane[:h4 * 4], ev, lvl_v, lvl_v_prev, e_lut, i_lut, luma,
                bitdepth)
    # horizontal pass on the transposed plane (visible columns only; H
    # edges exist only within the visible width). y = 0: no edge.
    eh = edge_h.T.clone()
    eh[:, 0] = -1
    _apply_pass(plane.T[:w4 * 4], eh, lvl_h.T, lvl_h_prev.T, e_lut, i_lut,
                luma, bitdepth)
    return plane


def neighbour_levels(lvl_v, lvl_h):
    """The fallback neighbour levels of a frame's edges: the previous
    vertical edge's level (x - 1; 0 at x = 0) and the previous horizontal
    edge's (y - 1)."""
    lvp = torch.zeros_like(lvl_v)
    lvp[:, 1:] = lvl_v[:, :-1]
    lhp = torch.zeros_like(lvl_h)
    lhp[1:, :] = lvl_h[:-1, :]
    return lvp, lhp


def deblock_frame(planes, edge_v, edge_h, lvl_v, lvl_h, e_lut, i_lut,
                  bitdepth):
    """Deblock a frame's first len(planes) planes (luma, then both
    chroma planes, or luma alone): deblock_plane of each with its maps
    (edge_v[i], edge_h[i], lvl_v[i], lvl_h[i]), each edge's fallback
    level its neighbour's (neighbour_levels). Returns new int32
    planes."""
    out = []
    for i, plane in enumerate(planes):
        lvp, lhp = neighbour_levels(lvl_v[i], lvl_h[i])
        out.append(deblock_plane(plane, edge_v[i], edge_h[i], lvl_v[i], lvp,
                                 lvl_h[i], lhp, e_lut, i_lut, i == 0,
                                 bitdepth))
    return tuple(out)
