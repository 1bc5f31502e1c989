# Copied from dav1d_mirror_tpu/models/plan_vec.py.
"""Vectorized frame planning: numpy over the native walk's dense records.

build_frame_program's per-block Python walk (models/tpu_inter) costs
O(blocks) interpreter time — ~2.5 s/frame at 1080p, ~50x the device
compute it feeds (round-3 verdict measurement). dav1d's equivalent
planning is C inside src/decode.c:717 / src/recon_tmpl.c:1598 and is a
rounding error per frame. This module re-expresses the planning as
O(size-classes) numpy array programs over the dense block/coef records
the native tile walk already produces (host/native_tile.py
coder.native_arrays), touching Python per-BLOCK only for the rare
special shapes (warp, OBMC laps, sub-8x8 chroma, scaled refs, compound),
which are planned by the existing per-block helpers over just those
indices.

Key order-independence facts that make vectorization exact:
  * blocks never overlap, so the decode-order f2d_map paint
    (tpu_inter.py:404) can be a single scatter — any cell a later
    block READS belongs to an already-decoded neighbour, whose final
    value equals its value at read time;
  * tl_4x4_filter (the last non-compound inter block's filter before
    the current block) is a forward-fill over decode order — one
    np.maximum.accumulate;
  * MC unit rows within a put bucket land at disjoint destinations, so
    their order inside the batch is free (the program signature only
    encodes shapes/offsets, which the ProgramSchema already fixes).

Bit-exact with the per-block walk (tests/test_tpu_inter.py cross-checks
both planners on every e2e stream class).
"""
from __future__ import annotations

import numpy as np

from ..host.tilecoder import T_BLOCK_DIM
from ..host.native_tile import (
    B_BS, B_BX, B_BY, B_SKIP, B_INTRA, B_INTER_MODE, B_REF0, B_REF1,
    B_MV0Y, B_MV0X, B_COMP_TYPE, B_MOTION_MODE, B_INTERINTRA_TYPE,
    B_FILTER2D, B_COEF_LO, B_COEF_HI, B_WARP_VALID)
from ..ops.mc import PAD_OOB


def blocks_meta(coders):
    """(blk_all, ci_all, n_per) concatenated dense block records across
    coders in decode order (tile raster order == coder order)."""
    blks = [c.native_arrays[0] for c in coders]
    ci = np.repeat(np.arange(len(coders), dtype=np.int32),
                   [b.shape[0] for b in blks])
    return (np.concatenate(blks, axis=0) if len(blks) > 1 else blks[0],
            ci, [b.shape[0] for b in blks])


def all_intra(coders) -> bool:
    """Vectorized `all(b.intra for ...)` over the dense records."""
    return all(bool(c.native_arrays[0][:, B_INTRA].all())
               if getattr(c, "native_arrays", None) is not None
               else all(b.intra for b in c.blocks) for c in coders)


def _expand_units(sub, bw4, bh4, ssh, ssv, pos_x, pos_y, dst_x, dst_y,
                  out):
    """Vectorized _units_for_block_raw for one (bw4, bh4) class of
    translational blocks. sub: (B, 5) int32 columns (ref, mvy, mvx,
    f2d, _); pos/dst in 4px units (already aligned for chroma). Appends
    (rows, hh, hv) per unit-geometry to out[(uw, uh)]."""
    h_mul, v_mul = 4 >> ssh, 4 >> ssv
    pw, ph = bw4 * h_mul, bh4 * v_mul
    uw, uh = min(pw, 8), min(ph, 8)
    ref, mvy, mvx, f2d = sub[:, 0], sub[:, 1], sub[:, 2], sub[:, 3]
    mx = (mvx & (15 >> (0 if ssh else 1))) << (0 if ssh else 1)
    my = (mvy & (15 >> (0 if ssv else 1))) << (0 if ssv else 1)
    sx = pos_x * h_mul + (mvx >> (3 + ssh))
    sy = pos_y * v_mul + (mvy >> (3 + ssv))
    hh = mx != 0
    hv = my != 0
    B = sub.shape[0]
    oy = np.arange(0, ph, uh, dtype=np.int32)
    ox = np.arange(0, pw, uw, dtype=np.int32)
    nY, nX = oy.shape[0], ox.shape[0]
    nU = nY * nX
    rows = np.empty((B, nU, 8), np.int32)
    oyg = np.repeat(oy, nX)[None, :]
    oxg = np.tile(ox, nY)[None, :]
    rows[:, :, 0] = ref[:, None]
    rows[:, :, 1] = (sy - np.where(hv, 3, 0))[:, None] + oyg
    rows[:, :, 2] = (sx - np.where(hh, 3, 0))[:, None] + oxg
    rows[:, :, 3] = mx[:, None]
    rows[:, :, 4] = my[:, None]
    rows[:, :, 5] = f2d[:, None]
    rows[:, :, 6] = (dst_y * v_mul)[:, None] + oyg
    rows[:, :, 7] = (dst_x * h_mul)[:, None] + oxg
    hhu = np.repeat(hh, nU)
    hvu = np.repeat(hv, nU)
    rows = rows.reshape(B * nU, 8)
    dst = out.setdefault((uw, uh), [])
    for fh in (False, True):
        for fv in (False, True):
            m = (hhu == fh) & (hvu == fv)
            if m.any():
                dst.append((rows[m], fh, fv))


def plan_translational(blk, ssh, ssv, n_planes, plain, chroma_m):
    """Vector-plan the plain translational puts. plain: bool mask over
    blk rows (luma selection); chroma_m: subset with has_chroma and not
    sub-8x8. Returns per-plane dicts {(uw, uh, hh, hv): (B, 8) rows}
    for the pack stage to merge with the special-block lists."""
    buckets = [dict() for _ in range(n_planes)]
    bs = blk[:, B_BS]
    for cls in np.unique(bs[plain]):
        m = plain & (bs == cls)
        bw4, bh4 = int(T_BLOCK_DIM[cls][0]), int(T_BLOCK_DIM[cls][1])
        sub = np.stack([blk[m, B_REF0], blk[m, B_MV0Y], blk[m, B_MV0X],
                        blk[m, B_FILTER2D], blk[m, B_FILTER2D]], axis=1)
        _expand_units(sub, bw4, bh4, 0, 0, blk[m, B_BX], blk[m, B_BY],
                      blk[m, B_BX], blk[m, B_BY], buckets[0])
    if n_planes > 1:
        for cls in np.unique(bs[chroma_m]):
            m = chroma_m & (bs == cls)
            bw4, bh4 = int(T_BLOCK_DIM[cls][0]), int(T_BLOCK_DIM[cls][1])
            cw4 = bw4 << (bw4 == ssh)
            ch4 = bh4 << (bh4 == ssv)
            px = blk[m, B_BX] & ~ssh
            py = blk[m, B_BY] & ~ssv
            sub = np.stack([blk[m, B_REF0], blk[m, B_MV0Y],
                            blk[m, B_MV0X], blk[m, B_FILTER2D],
                            blk[m, B_FILTER2D]], axis=1)
            out = {}
            _expand_units(sub, cw4, ch4, ssh, ssv, px, py, px, py, out)
            for k, lst in out.items():
                buckets[1].setdefault(k, []).extend(lst)
                buckets[2].setdefault(k, []).extend(lst)
    # flatten to one concatenated (B, 8) array per (uw, uh, hh, hv) key
    vec_put = [dict() for _ in range(n_planes)]
    for pl in range(n_planes):
        for (uw, uh), lst in buckets[pl].items():
            by_combo = {}
            for rows, fh, fv in lst:
                by_combo.setdefault((fh, fv), []).append(rows)
            for (fh, fv), chunks in by_combo.items():
                vec_put[pl][(uw, uh, fh, fv)] = (
                    np.concatenate(chunks) if len(chunks) > 1
                    else chunks[0])
    return vec_put


def classify(blk, ref_ok, gm_warp, ref_scaled):
    """Vectorized _block_device_class + special-shape masks. Returns a
    dict of masks over blk rows. gm_warp: (7,) bool — per-ref GLOBALMV
    warp allowed (non-scaled, shear-valid, type>1); ref_scaled: (7,)
    bool — ref geometry mismatches the current frame."""
    intra = blk[:, B_INTRA] != 0
    comp = blk[:, B_COMP_TYPE] != 0
    ref0 = np.clip(blk[:, B_REF0], 0, 6)
    ref1 = np.clip(blk[:, B_REF1], 0, 6)
    covered = ~intra & ref_ok[ref0] & (~comp | ref_ok[ref1])
    single = covered & ~comp
    bw4 = T_BLOCK_DIM[blk[:, B_BS], 0].astype(np.int32)
    bh4 = T_BLOCK_DIM[blk[:, B_BS], 1].astype(np.int32)
    big = np.minimum(bw4, bh4) > 1
    # warp selection mirrors tpu_inter.py:435-441: local warp when
    # motion_mode==2 AND the shear was valid; else GLOBALMV gm warp
    warp_local = (blk[:, B_MOTION_MODE] == 2) & (blk[:, B_WARP_VALID]
                                                 != 0)
    warp_gmv = (blk[:, B_INTER_MODE] == 2) & gm_warp[ref0]
    use_warp = single & big & (warp_local | warp_gmv)
    obmc = single & (blk[:, B_MOTION_MODE] == 1)
    ii = covered & (blk[:, B_INTERINTRA_TYPE] != 0)
    scaled0 = single & ref_scaled[ref0]
    return dict(intra=intra, covered=covered, single=single,
                comp=covered & comp, use_warp=use_warp, obmc=obmc,
                ii=ii, bw4=bw4, bh4=bh4, scaled0=scaled0)


def f2d_products(blk_all):
    """(f2d_map fn inputs, tl_before) — the decode-order filter state,
    vectorized. Returns (paint arrays for the final map, tl_before
    (N,) int32: tl_4x4_filter value each block would read)."""
    inter = blk_all[:, B_INTRA] == 0
    qual = inter & (blk_all[:, B_COMP_TYPE] == 0)
    idx = np.arange(blk_all.shape[0])
    # value visible to block i = filter2d of the last qualifying block
    # strictly before i (0 if none)
    last_q = np.where(qual, idx, -1)
    np.maximum.accumulate(last_q, out=last_q)
    prev_q = np.concatenate([[-1], last_q[:-1]])
    tl_before = np.where(prev_q >= 0,
                         blk_all[np.clip(prev_q, 0, None), B_FILTER2D],
                         0).astype(np.int32)
    return tl_before


def paint_f2d_map(blk_all, bw, bh):
    """Final-state f2d_map (order-free: blocks are disjoint)."""
    f2d_map = np.zeros((bh, bw), np.uint8)
    inter = blk_all[:, B_INTRA] == 0
    if not inter.any():
        return f2d_map
    sel = blk_all[inter]
    bw4 = T_BLOCK_DIM[sel[:, B_BS], 0].astype(np.int32)
    bh4 = T_BLOCK_DIM[sel[:, B_BS], 1].astype(np.int32)
    # bucket by (bw4, bh4) so the scatter is a broadcast per class
    key = bw4 * 64 + bh4
    for k in np.unique(key):
        m = key == k
        w, h = int(k) >> 6, int(k) & 63
        # frame-edge blocks overhang the 4x4 grid: clamp like the
        # slice-paint does — clamped cells stay inside the same block,
        # so the written value is unchanged
        ys = np.minimum(sel[m, B_BY][:, None, None] +
                        np.arange(h)[None, :, None], bh - 1)
        xs = np.minimum(sel[m, B_BX][:, None, None] +
                        np.arange(w)[None, None, :], bw - 1)
        f2d_map[ys, xs] = sel[m, B_FILTER2D][:, None, None].astype(
            np.uint8)
    return f2d_map


# ---------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------
class ResidBucket:
    """Array-backed residual bucket (replaces the per-entry tuple list).
    cf: (B, sh, sw) int32; ys/xs in px; sel: (B, 2) itx family indices;
    ci/cj: coder / coef-record indices (host-map bookkeeping)."""
    __slots__ = ("cf", "ys", "xs", "sel", "ci", "cj")

    def __init__(self, cf, ys, xs, sel, ci, cj):
        self.cf = cf
        self.ys = ys
        self.xs = xs
        self.sel = sel
        self.ci = ci
        self.cj = cj

    def __len__(self):
        return self.cf.shape[0]


_SEL_TABLE = None


def _sel_table():
    global _SEL_TABLE
    if _SEL_TABLE is None:
        from ..ops.itx import itx_multi_sel
        from ..ops.itx_meta import TX_INFO, WHT_WHT
        t = np.zeros((len(TX_INFO), 17, 2), np.int32)
        for tx in range(len(TX_INFO)):
            for tp in range(17):
                if tp == WHT_WHT:
                    continue
                try:
                    t[tx, tp] = itx_multi_sel(tx, tp)
                except Exception:
                    pass    # (tx, txtp) pairs no stream can produce
        _SEL_TABLE = t
    return _SEL_TABLE


def plan_residuals_vec(coders, dd_flags):
    """Vectorized residual bucketing over the dense coef records.
    dd_flags: per-coder uint8 (0 host, 1 device, 2 device-put+host-
    blend, 3 device intra engine). Returns (rplans, hplans, iplans)
    keyed (plane, tx, is_wht) -> ResidBucket (device buckets carry
    ys/xs; host buckets carry ci/cj; iplans feed the wavefront intra
    engine's residual planes — resrawm ops).

    Falls back to None when a coder's coef ranges aren't the contiguous
    decode-order tiling the vectorization assumes (never the case for
    the native walk, but cheap to verify)."""
    from ..ops.itx_meta import TX_INFO, WHT_WHT
    per = []
    for c_i, coder in enumerate(coders):
        blk, coef = coder.native_arrays[0], coder.native_arrays[1]
        n_coefs = coef.shape[0]
        lo = blk[:, B_COEF_LO].astype(np.int64)
        hi = blk[:, B_COEF_HI].astype(np.int64)
        if n_coefs:
            if not (lo[0] == 0 and (hi[-1] == n_coefs) and
                    (lo[1:] == hi[:-1]).all()):
                return None
            blkid = np.repeat(np.arange(blk.shape[0]), hi - lo)
        else:
            blkid = np.zeros(0, np.int64)
        keep = (coef[:, 5] >= 0) & (blk[blkid, B_SKIP] == 0)
        ddv = dd_flags[c_i][blkid]
        per.append((coder, coef, keep, ddv,
                    np.arange(n_coefs, dtype=np.int64)))

    sel_tab = _sel_table()
    rplans, hplans, iplans = {}, {}, {}
    for dst, cls in ((rplans, 1), (hplans, 0), (iplans, 3)):
        for c_i, (coder, coef, keep, ddv, cj_all) in enumerate(per):
            m = keep & ((ddv == cls) if cls != 0
                        else ((ddv == 0) | (ddv == 2)))
            if not m.any():
                continue
            sub = coef[m]
            cj = cj_all[m]
            cf_flat = coder.cf_buf
            key_arr = (sub[:, 0].astype(np.int64) * 64 +
                       sub[:, 3].astype(np.int64) * 2 +
                       (sub[:, 4] == WHT_WHT))
            for k in np.unique(key_arr):
                km = key_arr == k
                pl = int(k) >> 6
                tx = (int(k) >> 1) & 31
                is_wht = bool(int(k) & 1)
                w_t, h_t, _ = TX_INFO[tx]
                sh, sw = min(h_t, 32), min(w_t, 32)
                offs = sub[km, 6].astype(np.int64)
                cf = cf_flat[offs[:, None] +
                             np.arange(sw * sh)[None, :]]
                cf = cf.reshape(-1, sw, sh).transpose(0, 2, 1)
                cf = np.ascontiguousarray(cf, np.int32)
                ys = (sub[km, 2] * 4).astype(np.int32)
                xs = (sub[km, 1] * 4).astype(np.int32)
                sel = sel_tab[tx, np.clip(sub[km, 4], 0, 16)]
                b = dst.get((pl, tx, is_wht))
                nb = ResidBucket(cf, ys, xs, sel,
                                 np.full(len(offs), c_i, np.int32),
                                 cj[km].astype(np.int64))
                if b is None:
                    dst[(pl, tx, is_wht)] = nb
                else:
                    dst[(pl, tx, is_wht)] = ResidBucket(
                        np.concatenate([b.cf, nb.cf]),
                        np.concatenate([b.ys, nb.ys]),
                        np.concatenate([b.xs, nb.xs]),
                        np.concatenate([b.sel, nb.sel]),
                        np.concatenate([b.ci, nb.ci]),
                        np.concatenate([b.cj, nb.cj]))
    return rplans, hplans, iplans


def build_cdef_noskip(fhdr, coders):
    """Vectorized noskip map for build_cdef_plan (paint is order-free:
    blocks are disjoint)."""
    bw, bh = coders[0].bw, coders[0].bh
    noskip = np.zeros((bh, bw), bool)
    for coder in coders:
        if getattr(coder, "native_arrays", None) is None:
            for b in coder.blocks:
                if not b.skip:
                    bd_ = T_BLOCK_DIM[b.bs]
                    noskip[b.by:b.by + int(bd_[1]),
                           b.bx:b.bx + int(bd_[0])] = True
            continue
        blk = coder.native_arrays[0]
        sel = blk[blk[:, B_SKIP] == 0]
        if not sel.shape[0]:
            continue
        bw4 = T_BLOCK_DIM[sel[:, B_BS], 0].astype(np.int32)
        bh4 = T_BLOCK_DIM[sel[:, B_BS], 1].astype(np.int32)
        key = bw4 * 64 + bh4
        for k in np.unique(key):
            m = key == k
            w, h = int(k) >> 6, int(k) & 63
            ys = np.minimum(sel[m, B_BY][:, None, None] +
                            np.arange(h)[None, :, None], bh - 1)
            xs = np.minimum(sel[m, B_BX][:, None, None] +
                            np.arange(w)[None, None, :], bw - 1)
            noskip[ys, xs] = True
    return noskip
