"""numpy models of the deblock kernels (``csrc/deblock.cu``): the frame
kernel's tile (``fused_tile``, ``deblock_frame_plane``; see the section
below) and the pass kernel's two phases.

The pass kernel computes one pass of ``ops/loopfilter._apply_pass`` out of
place: phase 1 computes every (view row, edge)'s candidate outputs and
the mask of the taps it stores (``edge_outputs``), phase 2 gives every
pixel the last store, in the plain version's order (tap k, p side then q
side), whose mask is set (``resolve``), finding the writers of a column
in closed form, or in the last 8 columns by inverting the plain
version's column map (``writers``; ``p_writer``, ``q_writer``: the wrap
below zero and the clamp to the last column included). With
``tile`` = (TR, TC) ``resolve`` also checks what a CTA of the kernel
relies on: every writer of a pixel of a tile is one of the edges the tile
computes in phase 1 (``tile_edges``), or a wrapped p-side write. The
tests hold the model to the plain version on random maps, neighbouring
edges that store into the same pixel, and a band's transposed view with
``base`` halo rows.
"""
from __future__ import annotations

import numpy as np


def tap_col(v, W):
    """ops/loopfilter._cols: remainder(min(v, W - 1), W) (v >= -7)."""
    v = np.minimum(v, W - 1)
    return np.where(v < 0, v + W, v)


def edge_outputs(view, edge_idx, lvl_cur, lvl_prev, e_lut, i_lut, luma,
                 bitdepth, base=0, first_edge=0):
    """Phase 1: (outs (4 n_er, n_e, 2 NS): new p_0..p_NS-1 then new
    q_0..q_NS-1, masks (4 n_er, n_e): bit k set where tap k is stored) of
    every view row and edge (NS = 6 luma, 2 chroma)."""
    n_er, n_e = edge_idx.shape
    R, W = 4 * n_er, view.shape[1]
    nr = 7 if luma else 3
    rep = lambda a: np.repeat(np.asarray(a, np.int64), 4, axis=0)
    cls, lc, lp = rep(edge_idx), rep(lvl_cur), rep(lvl_prev)
    L = np.where(lc != 0, lc, lp)
    col = base + 4 * np.arange(n_e)
    act = (cls >= 0) & (L != 0) & (np.arange(n_e) >= first_edge)
    v = np.asarray(view[:R], np.int64)
    p = [v[:, tap_col(col - 1 - k, W)] for k in range(nr)]
    q = [v[:, tap_col(col + k, W)] for k in range(nr)]
    return filter_taps(p, q, act, cls, L, e_lut, i_lut, luma, bitdepth)


def filter_taps(p, q, act, cls, L, e_lut, i_lut, luma, bitdepth):
    """(outs (..., 2 NS), masks (...)) of edges given their taps p[k],
    q[k] (arrays of one shape, k < 7 luma, 3 chroma), activity, width
    class and level (csrc/deblock.cu edge_filter)."""
    ns = 6 if luma else 2
    sh = bitdepth - 8
    Lc = np.clip(L, 0, 63)
    E = np.asarray(e_lut, np.int64)[Lc] << sh
    I = np.asarray(i_lut, np.int64)[Lc] << sh
    H = (L >> 4) << sh
    F = 1 << sh
    bd_max = (1 << bitdepth) - 1
    ab = np.abs
    fm = (ab(p[1] - p[0]) <= I) & (ab(q[1] - q[0]) <= I) & \
        (ab(p[0] - q[0]) * 2 + (ab(p[1] - q[1]) >> 1) <= E)
    fm6 = fm & (ab(p[2] - p[1]) <= I) & (ab(q[2] - q[1]) <= I)
    flat6 = (ab(p[2] - p[0]) <= F) & (ab(p[1] - p[0]) <= F) & \
        (ab(q[1] - q[0]) <= F) & (ab(q[2] - q[0]) <= F)
    hev = (ab(p[1] - p[0]) > H) | (ab(q[1] - q[0]) > H)
    lo, hi = -128 * (1 << sh), 128 * (1 << sh) - 1
    f = np.clip(3 * (q[0] - p[0]) + np.where(hev, np.clip(p[1] - q[1], lo,
                                                           hi), 0), lo, hi)
    f1 = np.minimum(f + 4, hi) >> 3
    f2 = np.minimum(f + 3, hi) >> 3
    fo = (f1 + 1) >> 1
    n4 = {"p0": np.clip(p[0] + f2, 0, bd_max),
          "p1": np.where(hev, p[1], np.clip(p[1] + fo, 0, bd_max)),
          "q0": np.clip(q[0] - f1, 0, bd_max),
          "q1": np.where(hev, q[1], np.clip(q[1] - fo, 0, bd_max))}
    outs = np.zeros(np.shape(p[0]) + (2 * ns,), np.int64)
    masks = np.zeros(np.shape(p[0]), np.int64)

    def put(sel, vals, bits):
        for name, val in vals.items():
            k = int(name[1]) + (ns if name[0] == "q" else 0)
            outs[..., k] = np.where(sel, val, outs[..., k])
        masks[sel] = bits

    if not luma:
        m4 = act & (cls == 0) & fm
        m6 = act & (cls == 1) & fm6
        put(m4 | (m6 & ~flat6), n4, 3)
        p0, p1, p2, q0, q1, q2 = p[0], p[1], p[2], q[0], q[1], q[2]
        put(m6 & flat6, {
            "p1": (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3,
            "p0": (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
            "q0": (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
            "q1": (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3}, 3)
        return outs, masks
    fm8 = fm6 & (ab(p[3] - p[2]) <= I) & (ab(q[3] - q[2]) <= I)
    flat8 = flat6 & (ab(p[3] - p[0]) <= F) & (ab(q[3] - q[0]) <= F)
    flatout = flat8 & np.logical_and.reduce(
        [ab(x[j] - x[0]) <= F for x in (p, q) for j in (4, 5, 6)])
    m4 = act & (cls == 0) & fm
    m8 = act & (cls == 1) & fm8
    m16 = act & (cls == 2) & fm8
    put(m4 | (m8 & ~flat8) | (m16 & ~flatout & ~flat8), n4, 3)
    p0, p1, p2, p3, p4, p5, p6 = p
    q0, q1, q2, q3, q4, q5, q6 = q
    put((m8 & flat8) | (m16 & ~flatout & flat8), {
        "p2": (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
        "p1": (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
        "p0": (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
        "q0": (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
        "q1": (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3,
        "q2": (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3}, 7)
    # the 16 px filter: tap j of each side as weights over p6..p0 q0..q6
    seq = [p6, p5, p4, p3, p2, p1, p0, q0, q1, q2, q3, q4, q5, q6]
    wts = {"p5": (7, 2, 2, 1, 1, 1, 1, 1), "p4": (5, 2, 2, 2, 1, 1, 1, 1, 1),
           "p3": (4, 1, 2, 2, 2, 1, 1, 1, 1, 1),
           "p2": (3, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1),
           "p1": (2, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1),
           "p0": (1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1)}
    n16 = {}
    for name, w in wts.items():
        n16[name] = sum(c * x for c, x in zip(w, seq)) + 8 >> 4
        n16["q" + name[1]] = sum(c * x for c, x in
                                 zip(w, seq[::-1])) + 8 >> 4
    put(m16 & flatout, n16, 63)
    return outs, masks


def p_writer(c, k, base, n_e, W):
    """The edge whose p-side store of tap k lands on view column c
    (arrays), or -1: base + 4i - 1 - k == c, or == c - W (wrapped)."""
    out = np.full(np.shape(c), -1, np.int64)
    for t in (c - base + 1 + k, c - W - base + 1 + k):
        ok = (t >= 0) & (t % 4 == 0) & (t // 4 < n_e) & (out < 0)
        out = np.where(ok, t // 4, out)
    return out


def q_writer(c, k, base, n_e, W):
    """The edge whose q-side store of tap k lands on view column c, or -1:
    base + 4i + k == c, or the last edge clamped to the last column."""
    t = c - base - k
    out = np.where((t >= 0) & (t % 4 == 0) & (t // 4 < n_e), t // 4, -1)
    clamp = (c == W - 1) & (n_e > 0) & (base + 4 * (n_e - 1) + k > W - 1)
    return np.where((out < 0) & clamp, n_e - 1, out)


def tile_edges(c0, tc, base, n_e):
    """(i_lo, i_hi): the edges a CTA whose tile starts at view column c0
    (tc wide) computes in phase 1: those whose stores [base + 4i - 6,
    base + 4i + 5] meet the tile."""
    return max((c0 - base - 2) // 4, 0), min((c0 + tc + 5 - base) // 4,
                                              n_e - 1)


def writers(c, base, n_e, W, luma):
    """The stores that land on view column c, in the plain version's order
    ([(tap k, side 0 p / 1 q, edge)]), as the kernel finds them: in closed
    form below the last 8 columns (c - base = 4j + m: edges j and j + 1,
    and j - 1 or j + 2 for luma's taps 4 and 5), by p_writer and q_writer
    in the last 8 (where the wrap and the clamp land)."""
    ns = 6 if luma else 2
    out = []
    if c < W - 8:
        cp = c - base
        m, j = cp & 3, cp >> 2
        cand = ([(m, 1, j), (3 - m, 0, j + 1), (m + 4, 1, j - 1)]
                if m < 2 else
                [(3 - m, 0, j + 1), (m, 1, j), (7 - m, 0, j + 2)])
        return [(k, side, i) for k, side, i in cand
                if k < ns and 0 <= i < n_e]
    for k in range(ns):
        for side, wr in ((0, p_writer), (1, q_writer)):
            i = int(wr(np.array(c), k, base, n_e, W))
            if i >= 0:
                out.append((k, side, i))
    return out


def resolve(view, outs, masks, luma, base=0, tile=None):
    """Phase 2: the pass's output for the filtered rows of `view` (4 n_er,
    W), from phase 1's outputs and masks, each pixel's writers found as
    the kernel finds them (`writers`). tile = (TR, TC): assert that a
    tile's pixels need only its own phase-1 edges (or a wrapped write,
    which the kernel computes on the spot)."""
    R, n_e = masks.shape
    W = view.shape[1]
    ns = 6 if luma else 2
    out = np.asarray(view[:R], np.int64).copy()
    for c in range(W):
        for k, side, i in writers(c, base, n_e, W, luma):
            if tile is not None:
                lo, hi = tile_edges(c - c % tile[1], tile[1], base, n_e)
                wrapped = side == 0 and base + 4 * i - 1 - k < 0
                assert lo <= i <= hi or wrapped, (c, k, side, i)
            m = (masks[:, i] >> k) & 1
            out[:, c] = np.where(m == 1, outs[:, i, side * ns + k],
                                 out[:, c])
    return out


def apply_pass(view, edge_idx, lvl_cur, lvl_prev, e_lut, i_lut, luma,
               bitdepth, base=0, first_edge=0, tile=None):
    """The kernel's pass as the model computes it: a new (4 n_er, W)
    array."""
    outs, masks = edge_outputs(view, edge_idx, lvl_cur, lvl_prev, e_lut,
                               i_lut, luma, bitdepth, base, first_edge)
    return resolve(view, outs, masks, luma, base, tile)


# ---- the frame kernel (csrc/deblock.cu deblock_frame_kernel) ----
# A CTA owns an output tile of FRAME_TILE = (rows, columns) of one plane
# and runs both passes on it in shared memory: the input tile with HALO
# rows and columns a side (logical coordinates, read through the plain
# version's column map), the vertical pass on every staged row into a
# buffer of the tile's columns, the horizontal pass on that buffer. A
# store is kept as (key << 16 | value), key = 2 k + side in the plain
# version's store order, and a pixel takes the largest: the last store
# (-1, none: its input).
FRAME_TILE = (64, 64)


def halo(luma):
    """Staged rows and columns a side: a pixel is written by edges up to
    NS px away (6 luma, 2 chroma), which read NR px beyond themselves (7,
    3); rounded up to 16 bytes of int32."""
    return 12 if luma else 4


def tap_mod(v, W):
    """ops/loopfilter._cols for any v: remainder(min(v, W - 1), W)."""
    return np.remainder(np.minimum(v, W - 1), W)


def edge_range(c0, tc, n_e, luma):
    """(lo, hi): the edges (from 1: the frame's edge 0 has no neighbour)
    whose stores [4i - NS, 4i + NS - 1] meet columns [c0, c0 + tc)."""
    ns = 6 if luma else 2
    return max(-((ns - 1 - c0) // 4), 1), min((c0 + tc - 1 + ns) // 4,
                                              n_e - 1)


def _levels(lvl, r4, i):
    """L of edges i of map row r4: the level, else the previous edge's
    (lvl[r4, i - 1], 0 at i = 0): the frame's neighbour level."""
    lc = lvl[r4, i]
    lp = np.where(i > 0, lvl[r4, np.maximum(i - 1, 0)], 0)
    return np.where(lc != 0, lc, lp)


def _scatter(buf, rows, c, outs, masks, t0, size, W, luma):
    """Each masked store of the edges at logical columns c (with their
    rows into buf) whose target, through the column map of a view W
    wide, lies in [t0, t0 + size): buf[row, target - t0] keeps the
    largest (key << 16 | value)."""
    ns = 6 if luma else 2
    for k in range(ns):
        for side, logical in ((0, c - 1 - k), (1, c + k)):
            tgt = tap_mod(logical, W) - t0
            sel = (((masks >> k) & 1) == 1) & (tgt >= 0) & (tgt < size)
            val = ((2 * k + side) << 16) | outs[..., side * ns + k]
            np.maximum.at(buf, (rows[sel], tgt[sel]), val[sel])


def _resolve(packed, fallback):
    return np.where(packed >= 0, packed & 0xFFFF, fallback)


def _plane_taps(plane, r, c, W, luma):
    """The taps (p, q) of the edges at rows r, logical columns c (arrays
    of one shape) of a plane W wide, through the column map."""
    nr = 7 if luma else 3
    return ([plane[r, tap_mod(c - 1 - k, W)] for k in range(nr)],
            [plane[r, tap_mod(c + k, W)] for k in range(nr)])


def mid_at(plane, ev, lv, luts, luma, bd, rows, x):
    """The vertical pass's output at plane rows `rows`, column x, straight
    from the plane: a pixel's writers are the edges of edge_range(x, 1)
    and edge 1 (a wrapped p-side store)."""
    Hp, Wp = plane.shape
    h4, w4 = ev.shape
    rows = np.asarray(rows, np.int64)
    lo, hi = edge_range(x, 1, w4, luma)
    i = np.unique(np.r_[np.arange(lo, hi + 1), [1] if w4 > 1 else []]
                  ).astype(np.int64)
    buf = np.full((len(rows), 1), -1, np.int64)
    f = np.nonzero(rows < 4 * h4)[0]
    if len(i) and len(f):
        R, I = np.meshgrid(f, i, indexing="ij")
        p, q = _plane_taps(plane, rows[R], 4 * I, Wp, luma)
        cls = ev[rows[R] >> 2, I]
        L = _levels(lv, rows[R] >> 2, I)
        outs, masks = filter_taps(p, q, (cls >= 0) & (L != 0), cls, L,
                                  *luts, luma, bd)
        _scatter(buf, R, 4 * I, outs, masks, x, 1, Wp, luma)
    return _resolve(buf[:, 0], plane[rows, x])


def fused_tile(plane, ev, eh, lv, lh, luts, luma, bd, y0, x0,
               tile=FRAME_TILE):
    """The frame kernel's output tile at (y0, x0) of one plane (clipped
    to the plane), asserting that every tap it reads lies in its staged
    rows and columns."""
    plane = np.asarray(plane, np.int64)
    ev, eh, lv, lh = (np.asarray(m, np.int64) for m in (ev, eh, lv, lh))
    Hp, Wp = plane.shape
    h4, w4 = ev.shape
    th, tw = tile
    hl = halo(luma)
    nr = 7 if luma else 3
    pr = tap_mod(np.arange(y0 - hl, y0 + th + hl), Hp)    # staged rows
    pc = tap_mod(np.arange(x0 - hl, x0 + tw + hl), Wp)
    S = plane[pr][:, pc]
    SR = len(pr)

    # vertical pass: every staged row, the edges whose stores reach the
    # tile's columns, their taps from S; edge 1's wrapped stores into the
    # last two columns from the plane's row
    P = np.full((SR, tw), -1, np.int64)
    lo, hi = edge_range(x0, tw, w4, luma)
    i = np.arange(lo, hi + 1)
    rr = np.nonzero(pr < 4 * h4)[0]
    if len(i) and len(rr):
        c = 4 * i - (x0 - hl)
        assert c.min() - nr >= 0 and c.max() + nr <= S.shape[1]
        R, I = np.meshgrid(rr, i, indexing="ij")
        p = [S[R, c[None] - 1 - k] for k in range(nr)]
        q = [S[R, c[None] + k] for k in range(nr)]
        cls = ev[pr[R] >> 2, I]
        L = _levels(lv, pr[R] >> 2, I)
        outs, masks = filter_taps(p, q, (cls >= 0) & (L != 0), cls, L,
                                  *luts, luma, bd)
        _scatter(P, R, 4 * I, outs, masks, x0, tw, Wp, luma)
    if luma and w4 > 1 and lo > 1 and x0 + tw >= Wp - 1 and len(rr):
        p, q = _plane_taps(plane, pr[rr], np.full_like(rr, 4), Wp, luma)
        cls = ev[pr[rr] >> 2, 1]
        L = _levels(lv, pr[rr] >> 2, np.ones_like(rr))
        outs, masks = filter_taps(p, q, (cls >= 0) & (L != 0), cls, L,
                                  *luts, luma, bd)
        _scatter(P, rr, np.full_like(rr, 4), outs, masks, x0, tw, Wp, luma)
    M = _resolve(P, S[:, hl:hl + tw])

    # horizontal pass: the tile's columns left of 4 w4, the edges whose
    # stores reach its rows, their taps from M; edge 1's wrapped stores
    # into the last two rows from the vertical pass's output at its taps,
    # computed on the spot (mid_at)
    Q = np.full((th, tw), -1, np.int64)
    cols = np.arange(tw)[x0 + np.arange(tw) < 4 * w4]
    lo, hi = edge_range(y0, th, h4, luma)
    j = np.arange(lo, hi + 1)
    if len(j) and len(cols):
        r = 4 * j - (y0 - hl)
        assert r.min() - nr >= 0 and r.max() + nr <= SR
        J, C = np.meshgrid(j, cols, indexing="ij")
        p = [M[r[:, None] - 1 - k, C] for k in range(nr)]
        q = [M[r[:, None] + k, C] for k in range(nr)]
        cls = eh[J, (x0 + C) >> 2]
        L = _levels(lh.T, (x0 + C) >> 2, J)
        outs, masks = filter_taps(p, q, (cls >= 0) & (L != 0), cls, L,
                                  *luts, luma, bd)
        _scatter(Q.T, C, 4 * J, outs, masks, y0, th, Hp, luma)
    if luma and h4 > 1 and lo > 1 and y0 + th >= Hp - 1:
        for cc in cols:
            x = x0 + cc
            L = int(_levels(lh.T, x >> 2, np.array(1)))
            if eh[1, x >> 2] != 2 or L == 0:
                continue      # only a 16 px edge stores into p4 and p5
            col = mid_at(plane, ev, lv, luts, luma, bd,
                         tap_mod(np.arange(-3, 11), Hp), x)
            # logical rows -3..10: p_k at 3 - k, q_k at 4 + k
            p = [col[[6 - k]] for k in range(nr)]
            q = [col[[7 + k]] for k in range(nr)]
            outs, masks = filter_taps(p, q, np.array([True]),
                                      np.array([2]), np.array([L]), *luts,
                                      luma, bd)
            _scatter(Q.T, np.array([cc]), np.array([4]), outs, masks, y0,
                     th, Hp, luma)
    out = _resolve(Q, M[hl:hl + th])
    return out[:max(min(th, Hp - y0), 0), :max(min(tw, Wp - x0), 0)]


def deblock_frame_plane(plane, ev, eh, lv, lh, luts, luma, bd,
                        tile=FRAME_TILE):
    """One plane of the frame kernel, tile by tile (a new int64
    plane)."""
    Hp, Wp = np.shape(plane)
    out = np.zeros((Hp, Wp), np.int64)
    for y0 in range(0, Hp, tile[0]):
        for x0 in range(0, Wp, tile[1]):
            t = fused_tile(plane, ev, eh, lv, lh, luts, luma, bd, y0, x0,
                           tile)
            out[y0:y0 + t.shape[0], x0:x0 + t.shape[1]] = t
    return out
