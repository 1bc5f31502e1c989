# Ported from dav1d_mirror_tpu/parallel/tile_decode.py (_band_assembly :42,
# _tile_grid :124, _stitch_tiles :137, sharded_intra_decode :163,
# sharded_inter_decode :227, banded_inloop_filters :580).
"""Sharded decode of a multi-tile frame over a mesh, one tile per rank.

The reference schedules per-tile-sbrow tasks over a worker pool (dav1d
src/thread_task.c:268-310); here the tiles of an R x C grid are the ranks
of the mesh's first axis, in raster order:

  * reconstruction is tile-local: tiles are independent for entropy AND
    prediction (edges never cross tile starts). A keyframe runs the
    device intra engine's wave scan (models/intra.intra_scan) on each
    rank's tile; an inter frame runs its tile's translational MC unit
    batches, compound average / distance-weighted joins and residuals.
    No collective until the tiles are all-gathered and stitched;
  * the in-loop filters DO cross tile boundaries, so they run as the
    row-band sharded passes with halo exchange (parallel/filter_shard):
    deblock H edges exchange an 8-row halo and a write-back delta, CDEF
    a 2-row halo.

Every rank runs the host entropy decode and ends with the whole frame.
Bit-exact with the single-device decode. The scope is the reference's:
uniform tile grids, deblock and CDEF (no loop restoration or
super-resolution), and in inter frames translational single-reference
and compound average / distance-weighted blocks only; anything else
raises ValueError on every rank alike.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.tables import TABLES
from ..host import headers as h
from ..host.lf import build_lf_arrays
from ..host.tilecoder import (COMP_INTER_AVG, COMP_INTER_WEIGHTED_AVG)
from ..models.filters import build_cdef_plan
from ..models.frame_buffers import _gmv_warp_params
from ..models.inter import _p2, _pad_rows, _units_for_block_raw
from ..models.intra import IntraPlan, build_intra_plan, intra_scan, \
    wave_families
from ..ops import ipred as P
from ..ops import itx_cuda, mc, mcu_cuda, tools_cuda
from ..ops.ipred import PAD, PADT
from ..ops.itx import itx_multi_sel
from ..ops.itx_meta import TX_INFO, WHT_WHT
from ..ops.mc import PAD_OOB
from ..ops.spec_consts import calc_eih
from .filter_shard import _prep_lvls, band_deblock_plane, cdef_banded
from .mesh import all_gather_slabs, axis_info, mesh_device

T_BLOCK_DIM = TABLES["block_dimensions"]


def _band_assembly(seq, fhdr, coder, band_y0px, band_x0px, n_planes,
                   device):
    """One tile's intra plan and its init (palette) and residual planes
    (the inverse transforms on `device`, the placement on the host).
    band_y0px/band_x0px: the tile's top-left in luma pixels; every plan
    coordinate is rebased so the tile's slab is self-contained. Returns ((mrows, moffs), (frows, foffs)), init, res:
    the wave-ordered plan (IntraPlan.wave_rows) and two (n_planes, Hb,
    Wb) int32 arrays, every plane in the luma-padded slab shape."""
    bitdepth = seq.bitdepth
    ss_hor = 1 if seq.layout != h.PIXEL_LAYOUT_I444 else 0
    ss_ver = 1 if seq.layout == h.PIXEL_LAYOUT_I420 else 0
    bw = coder.bw
    band_h4 = coder.row_end - coder.row_start
    band_w4 = coder.col_end - coder.col_start
    Hb = band_h4 * 4 + PADT + PAD
    Wb = band_w4 * 4 + PADT + PAD
    cy0 = band_y0px >> ss_ver
    cx0 = band_x0px >> ss_hor

    ch_w = (bw + ss_hor) >> ss_hor
    ch_full = (coder.bh + ss_ver) >> ss_ver
    done = [np.zeros((coder.bh, bw), np.int32),
            np.zeros((ch_full, ch_w), np.int32),
            np.zeros((ch_full, ch_w), np.int32)]
    plan = IntraPlan()
    build_intra_plan(seq, fhdr, coder, done, plan)

    def rebase(items):
        for pv, _ in items:
            y0 = band_y0px if pv[P.P_PLANE] == 0 else cy0
            x0 = band_x0px if pv[P.P_PLANE] == 0 else cx0
            pv[P.P_PY] -= y0
            pv[P.P_BPY] -= y0
            pv[P.P_YSRC_Y] -= band_y0px
            pv[P.P_PX] -= x0
            pv[P.P_BPX] -= x0
            pv[P.P_YSRC_X] -= band_x0px

    rebase(plan.items)
    rebase(plan.filter_items)
    waves = plan.wave_rows()

    # palette pre-placement + residual planes
    init = np.zeros((n_planes, Hb, Wb), np.int32)
    res = np.zeros((n_planes, Hb, Wb), np.int32)
    for b in coder.blocks:
        if not b.intra or not (b.pal_sz[0] or b.pal_sz[1]):
            continue
        bw4, bh4 = int(T_BLOCK_DIM[b.bs][0]), int(T_BLOCK_DIM[b.bs][1])
        if b.pal_sz[0]:
            py = 4 * b.by - band_y0px + PADT
            px = 4 * b.bx - band_x0px + PADT
            init[0, py:py + bh4 * 4, px:px + bw4 * 4] = \
                np.asarray(b.pal[0], np.int64)[b.pal_idx_y]
        if b.pal_sz[1] and n_planes > 1 and \
                (bw4 > ss_hor or b.bx & 1) and (bh4 > ss_ver or b.by & 1):
            cbw4 = (bw4 + ss_hor) >> ss_hor
            cbh4 = (bh4 + ss_ver) >> ss_ver
            py = 4 * (b.by >> ss_ver) - cy0 + PADT
            px = 4 * (b.bx >> ss_hor) - cx0 + PADT
            for pl in (1, 2):
                init[pl, py:py + cbh4 * 4, px:px + cbw4 * 4] = \
                    np.asarray(b.pal[pl], np.int64)[b.pal_idx_uv]

    buckets = {}
    for cb in coder.coefs:
        if cb.eob < 0:
            continue
        buckets.setdefault((cb.plane, cb.tx, cb.txtp), []).append(cb)
    for (pl, tx, txtp), lst in sorted(buckets.items()):
        cfs = torch.as_tensor(np.stack([e.cf for e in lst]).astype(np.int32),
                              device=device)
        r = itx_cuda.itx_bucket("hres", cfs.reshape(len(lst), -1), None,
                                txtp, tx, bitdepth).cpu().numpy()
        y0 = band_y0px if pl == 0 else cy0
        x0 = band_x0px if pl == 0 else cx0
        for i, e in enumerate(lst):
            py = e.y * 4 - y0 + PADT
            px = e.x * 4 - x0 + PADT
            res[pl, py:py + r.shape[1], px:px + r.shape[2]] = r[i]
    return waves, init, res


def _tile_grid(fhdr, coders, n):
    """(rows, cols, band_h4, band_w4): the uniform R x C tile grid the
    mesh shards over (one tile per rank, raster order)."""
    t = fhdr.tiling
    if t.cols * t.rows != n:
        raise ValueError(f"need {n} tiles total, have {t.rows}x{t.cols}")
    band_h4s = {c.row_end - c.row_start for c in coders}
    band_w4s = {c.col_end - c.col_start for c in coders}
    if len(band_h4s) != 1 or len(band_w4s) != 1:
        raise ValueError("tiles must be uniform")
    return t.rows, t.cols, band_h4s.pop(), band_w4s.pop()


def _stitch_tiles(out, n_planes, rows, cols, band_h4, band_w4, ss_hor,
                  ss_ver, bufs, crop_padt=True):
    """Assemble per-tile slabs out[i] (n, Hs, Ws) back into whole int32
    planes of bufs.planes' shapes. Chroma content occupies the top-left
    of each slab."""
    planes = []
    for i in range(n_planes):
        ssv = ss_ver if i else 0
        ssh = ss_hor if i else 0
        bh_px = band_h4 * 4 >> ssv
        bw_px = band_w4 * 4 >> ssh
        o = out[i]
        if crop_padt:
            o = o[:, PADT:PADT + band_h4 * 4, PADT:PADT + band_w4 * 4]
        full = torch.cat(
            [torch.cat([o[r * cols + c][:bh_px, :bw_px]
                        for c in range(cols)], dim=1)
             for r in range(rows)], dim=0)
        ph, pw = bufs.planes[i].shape
        buf = full.new_zeros((ph, pw))
        ch = min(ph, full.shape[0])
        cw = min(pw, full.shape[1])
        buf[:ch, :cw] = full[:ch, :cw]
        planes.append(buf)
    return planes


def _finish(mesh, seq, fhdr, coders, bufs, planes):
    """The banded filters, then the frame's device planes (native dtype)
    and their download into bufs.planes."""
    planes = banded_inloop_filters(mesh, seq, fhdr, coders, bufs, planes)
    dt = torch.uint8 if seq.bitdepth == 8 else torch.int16
    bufs.dev_planes = [p.to(dt) for p in planes]
    for i, p in enumerate(bufs.dev_planes):
        bufs.planes[i] = p.cpu().numpy().astype(bufs.planes[i].dtype)
    return bufs


def sharded_intra_decode(seq, fhdr, coders, mesh, bufs):
    """Decode an intra multi-tile frame with the R x C tile grid sharded
    over the mesh (one tile per rank, raster order: tiles are fully
    independent for entropy and prediction), then the band-sharded
    filter chain. Fills bufs.planes and bufs.dev_planes on every rank."""
    _, n, me, _ = axis_info(mesh)
    dev = mesh_device(mesh)
    rows, cols, band_h4, band_w4 = _tile_grid(fhdr, coders, n)
    ss_hor, ss_ver = bufs.ss_hor, bufs.ss_ver
    n_planes = len(bufs.planes)
    coder = coders[me]
    ((mrows, moffs), (frows, foffs)), init, res = _band_assembly(
        seq, fhdr, coder, coder.row_start * 4, coder.col_start * 4,
        n_planes, dev)
    own = intra_scan(torch.as_tensor(init, device=dev),
                     torch.as_tensor(res, device=dev),
                     torch.as_tensor(mrows, device=dev), moffs,
                     torch.as_tensor(frows, device=dev), foffs,
                     seq.bitdepth, ss_hor, ss_ver,
                     wave_families(mrows, moffs))
    out = all_gather_slabs(own, mesh)              # (n, n_planes, Hb, Wb)
    planes = _stitch_tiles([out[:, i] for i in range(n_planes)], n_planes,
                           rows, cols, band_h4, band_w4, ss_hor, ss_ver,
                           bufs)
    return _finish(mesh, seq, fhdr, coders, bufs, planes)


def _check_scope(fhdr, b, bw4, bh4):
    """Raise on a block outside the sharded inter decode (the reference's
    check, tile_decode.py:305 of the JAX package)."""
    comp_ok = b.comp_type in (COMP_INTER_AVG, COMP_INTER_WEIGHTED_AVG) and \
        not b.motion_mode and not b.interintra_type
    if comp_ok and b.inter_mode == 6:   # GLOBALMV_GLOBALMV
        comp_ok = all(_gmv_warp_params(fhdr, b.ref[i], False) is None
                      for i in (0, 1))
    if b.intra or b.motion_mode or (b.comp_type and not comp_ok) or (
            not b.comp_type and
            b.inter_mode == 2 and          # GLOBALMV with a warping gm
            fhdr.gmv[b.ref[0]].type > 1 and
            min(bw4, bh4) > 1):  # a 4px-narrow GLOBALMV is translational
        raise ValueError("sharded_inter_decode: translational "
                         "single-ref/avg-compound blocks only")


def _plan_tile(seq, fhdr, coder, state, n_planes, ss_hor, ss_ver,
               jnt_weights):
    """Plan one tile's puts, compound blocks and residuals in decode
    order (JAX tile_decode.py:268-362). `state` carries the frame-wide
    decode-order filter map and the last single-reference block's filter
    across tiles."""
    rf = coder.rf
    f2d_map = state["f2d_map"]
    put = [dict() for _ in range(n_planes)]
    comp = {}
    res = {}
    band_y0 = coder.row_start * 4
    band_x0 = coder.col_start * 4
    cy0 = band_y0 >> ss_ver
    cx0 = band_x0 >> ss_hor
    for b in coder.blocks:
        bw4, bh4 = int(T_BLOCK_DIM[b.bs][0]), int(T_BLOCK_DIM[b.bs][1])
        bx, by = b.bx, b.by
        has_chroma = (n_planes > 1 and (bw4 > ss_hor or bx & 1) and
                      (bh4 > ss_ver or by & 1))
        if b.comp_type:
            # compound avg/wavg: whole-block sides per plane (compound
            # needs bs >= 8x8, so no sub-8x8 chroma)
            w = 8
            if b.comp_type == COMP_INTER_WEIGHTED_AVG:
                w = jnt_weights[b.ref[0]][b.ref[1]]
            for pl in range(n_planes):
                ssh = ss_hor if pl else 0
                ssv = ss_ver if pl else 0
                if pl and not has_chroma:
                    continue
                bwp = (bw4 * 4) >> ssh
                bhp = (bh4 * 4) >> ssv
                sides = []
                for i in (0, 1):
                    tmp = {}
                    _units_for_block_raw(tmp, pl, ss_hor, ss_ver,
                                         (bw4, bh4), bx, by, b.mv[i],
                                         b.ref[i], b.filter2d, whole=True)
                    (k2, l2), = tmp.items()
                    sides.append((l2[0][:6], k2[2], k2[3]))
                comp.setdefault((pl, bwp, bhp), []).append(
                    (sides, w, (by * 4 - band_y0) >> ssv,
                     (bx * 4 - band_x0) >> ssh))
            f2d_map[by:by + bh4, bx:bx + bw4] = b.filter2d
            continue
        _units_for_block_raw(put[0], 0, 0, 0, (bw4, bh4), bx, by, b.mv[0],
                             b.ref[0], b.filter2d,
                             dst=(by * 4 - band_y0, bx * 4 - band_x0))
        if has_chroma:
            is_sub8x8 = bw4 == ss_hor or bh4 == ss_ver
            if is_sub8x8:
                if bw4 == 1:
                    is_sub8x8 &= rf.ref[by, bx - 1, 0] > 0
                if bh4 == ss_ver:
                    is_sub8x8 &= rf.ref[by - 1, bx, 0] > 0
                if bw4 == 1 and bh4 == ss_ver:
                    is_sub8x8 &= rf.ref[by - 1, bx - 1, 0] > 0
            if is_sub8x8:
                # neighbour-MV chroma quadrants (recon_tmpl.c:1703)
                uvx = (bx >> ss_hor) * 4 - cx0
                uvy = (by >> ss_ver) * 4 - cy0
                h_off = v_off = 0

                def sub_mc(cy, cx, dyo, dxo, f2d_val):
                    rref = int(rf.ref[cy, cx, 0]) - 1
                    rmv = (int(rf.mv[cy, cx, 0, 0]),
                           int(rf.mv[cy, cx, 0, 1]))
                    for pl in (1, 2):
                        _units_for_block_raw(
                            put[pl], pl, ss_hor, ss_ver, (bw4, bh4), cx,
                            cy, rmv, rref, f2d_val,
                            dst=(uvy + dyo, uvx + dxo))

                if bw4 == 1 and bh4 == ss_ver:
                    sub_mc(by - 1, bx - 1, 0, 0, state["tl_f2d"])
                    v_off, h_off = 2, 2
                if bw4 == 1:
                    sub_mc(by, bx - 1, v_off, 0, int(f2d_map[by, bx - 1]))
                    h_off = 2
                if bh4 == ss_ver:
                    sub_mc(by - 1, bx, 0, h_off, int(f2d_map[by - 1, bx]))
                    v_off = 2
                for pl in (1, 2):
                    _units_for_block_raw(
                        put[pl], pl, ss_hor, ss_ver, (bw4, bh4), bx, by,
                        b.mv[0], b.ref[0], b.filter2d,
                        dst=(uvy + v_off, uvx + h_off))
            else:
                for pl in (1, 2):
                    _units_for_block_raw(
                        put[pl], pl, ss_hor, ss_ver,
                        (bw4 << (bw4 == ss_hor), bh4 << (bh4 == ss_ver)),
                        bx & ~ss_hor, by & ~ss_ver, b.mv[0], b.ref[0],
                        b.filter2d,
                        dst=(((by & ~ss_ver) * 4 >> ss_ver) - cy0,
                             ((bx & ~ss_hor) * 4 >> ss_hor) - cx0))
        state["tl_f2d"] = b.filter2d
        f2d_map[by:by + bh4, bx:bx + bw4] = b.filter2d
    for cb in coder.coefs:
        if cb.eob < 0:
            continue
        y0 = band_y0 if cb.plane == 0 else cy0
        x0 = band_x0 if cb.plane == 0 else cx0
        res.setdefault((cb.plane, cb.tx), []).append(
            (cb.cf, cb.y * 4 - y0, cb.x * 4 - x0,
             itx_multi_sel(cb.tx, cb.txtp)))
    return put, comp, res


def _skip_tile(coder, state):
    """Advance the decode-order filter state over a tile planned by
    another rank."""
    f2d_map = state["f2d_map"]
    for b in coder.blocks:
        bw4, bh4 = int(T_BLOCK_DIM[b.bs][0]), int(T_BLOCK_DIM[b.bs][1])
        if not b.comp_type:
            state["tl_f2d"] = b.filter2d
        f2d_map[b.by:b.by + bh4, b.bx:b.bx + bw4] = b.filter2d


def _ref_stacks(fhdr, bufs, refs, n_planes, dev):
    """Per plane, the 7 reference slots' planes stacked (absent: zeros),
    whole on every rank. Shapes are the VISIBLE dims, as the
    single-device path's: MC windows past the frame edge clamp to the
    last visible row/col, where a padded slab would hand them pad
    pixels."""
    stacks = []
    for pl in range(n_planes):
        sh_p = bufs.ss_hor if pl else 0
        sv_p = bufs.ss_ver if pl else 0
        wv = (bufs.width + sh_p) >> sh_p
        hv = (bufs.height + sv_p) >> sv_p
        slabs = []
        for i in range(7):
            rb = refs[fhdr.refidx[i]]
            if rb is None:
                slabs.append(torch.zeros((hv, wv), dtype=torch.int32,
                                         device=dev))
                continue
            if (rb.width, rb.height) != (bufs.width, bufs.height):
                raise ValueError("sharded_inter_decode: scaled refs "
                                 "unsupported")
            src = rb.dev_planes[pl] if rb.dev_planes is not None else \
                torch.as_tensor(rb.planes[pl].astype(np.int32))
            slabs.append(src[:hv, :wv].to(device=dev, dtype=torch.int32))
        stacks.append(torch.stack(slabs))
    return stacks


def sharded_inter_decode(seq, fhdr, coders, mesh, bufs, refs,
                         jnt_weights=None):
    """Decode an INTER multi-tile frame with the R x C tile grid sharded
    over the mesh:

      * reference planes are whole on every rank (MVs may point anywhere
        in the ref; dav1d's analogue is the shared address space its
        frame threads read ref rows from, thread_task.c:403-431);
      * each rank runs its tile's 8-tap MC unit batches (the unit MC
        kernel, ops/mcu_cuda), compound avg/weighted-avg joins (the
        join kernel, ops/tools_cuda.comp_run: one launch a frame) and the
        type-as-data residual scatter, with no collective until the
        tiles are all-gathered;
      * the in-loop filters cross tile boundaries and run band-sharded
        with halo exchange.

    Scope: translational blocks, single-ref (incl. sub-8x8 chroma
    quadrants) and compound AVG / weighted-AVG; warp, OBMC, inter-intra,
    masked compound and intra blocks raise ValueError on every rank.
    refs: the 8 slots' frame buffers. Fills bufs.planes and
    bufs.dev_planes, bit-exact with the single-device decode."""
    _, n, me, _ = axis_info(mesh)
    dev = mesh_device(mesh)
    rows_n, cols_n, band_h4, band_w4 = _tile_grid(fhdr, coders, n)
    bitdepth = seq.bitdepth
    ss_hor, ss_ver = bufs.ss_hor, bufs.ss_ver
    n_planes = len(bufs.planes)
    # every rank checks every tile, so all raise alike
    for coder in coders:
        for b in coder.blocks:
            _check_scope(fhdr, b, int(T_BLOCK_DIM[b.bs][0]),
                         int(T_BLOCK_DIM[b.bs][1]))
        if any(cb.eob >= 0 and cb.txtp == WHT_WHT for cb in coder.coefs):
            raise ValueError("sharded_inter_decode: lossless blocks")

    # ONE frame-wide decode-order filter map (tiles in raster order are
    # bitstream decode order): per-tile maps would read 0 instead of the
    # previous tile's filter2d for sub-8x8 chroma at a tile's top row
    state = dict(f2d_map=np.zeros((coders[0].bh, coders[0].bw), np.uint8),
                 tl_f2d=0)
    for ti in range(me):
        _skip_tile(coders[ti], state)
    put, comp, res = _plan_tile(seq, fhdr, coders[me], state, n_planes,
                                ss_hor, ss_ver, jnt_weights)

    refstk = _ref_stacks(fhdr, bufs, refs, n_planes, dev)
    planes = [torch.zeros(((band_h4 * 4) >> (ss_ver if pl else 0),
                           (band_w4 * 4) >> (ss_hor if pl else 0)),
                          dtype=torch.int32, device=dev)
              for pl in range(n_planes)]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=dev)

    for pl in range(n_planes):
        for k in sorted(put[pl]):
            uw, uh, hh, hv = k
            a = _pad_rows(np.asarray(put[pl][k], np.int32), 6)
            mcu_cuda.mc_units_plane(planes[pl], refstk[pl], t(a[:, :6]),
                                    t(a[:, 6]), t(a[:, 7]), uw, uh,
                                    bool(hh), bool(hv), bitdepth)

    # compound buckets: each bucket's two sides in one slot arena (slot
    # Np-1 of a side is sacrificial: its pad rows set_slots into it), then
    # the real slots of every bucket as one comp_run list of average and
    # distance-weighted joins, into the planes in one launch
    sizes = [_p2(len(comp[key]) + 1) * key[1] * key[2]
             for key in sorted(comp)]
    arena = torch.zeros(2 * sum(sizes), dtype=torch.int32, device=dev)
    entries, origins = [], []
    off = 0
    for key, size in zip(sorted(comp), sizes):
        pl, bwp, bhp = key
        lst = comp[key]
        Np = size // (bhp * bwp)
        srows = np.zeros((2, Np, 6), np.int32)
        shh = np.zeros((2, Np), bool)
        shv = np.zeros((2, Np), bool)
        for i, (sides, _, _, _) in enumerate(lst):
            for si, (row6, hh, hv) in enumerate(sides):
                srows[si, i] = row6
                shh[si, i] = hh
                shv[si, i] = hv
        tmps = [arena[off + si * size:off + (si + 1) * size].view(
            Np, bhp, bwp) for si in (0, 1)]
        for si in (0, 1):
            for hh in (False, True):
                for hv in (False, True):
                    s = np.nonzero((shh[si] == hh) & (shv[si] == hv))[0]
                    if not len(s):
                        continue
                    Ps = _p2(len(s))
                    rr = np.zeros((Ps, 6), np.int32)
                    sl = np.full(Ps, Np - 1, np.int32)
                    rr[:len(s)] = srows[si, s]
                    sl[:len(s)] = s
                    # pad lanes repeat the last real side into the
                    # sacrificial slot
                    rr[len(s):] = rr[len(s) - 1]
                    mcu_cuda.mc_units_slots(tmps[si], refstk[pl], t(rr),
                                            t(sl), bool(hh), bool(hv),
                                            bitdepth, True)
        entries.append(dict(
            plane=pl, bhp=bhp, bwp=bwp, s0=off, s1=off + size,
            dy=len(origins), dx=len(origins) + len(lst),
            rows=[(mc.CJ_WAVG, w, 0) for _, w, _, _ in lst]))
        origins += [dy for _, _, dy, _ in lst] + [dx for _, _, _, dx in lst]
        off += 2 * size
    if entries:
        table, work = mc.comp_build_table(entries)
        tools_cuda.comp_run(t(table), work, t(origins), planes, arena,
                            bitdepth)

    for (pl, tx) in sorted(res):
        lst = res[(pl, tx)]
        w_t, h_t, _ = TX_INFO[tx]
        sh, sw = min(h_t, 32), min(w_t, 32)
        padn = _p2(len(lst))
        cf = np.zeros((padn, sh, sw), np.int32)
        ys = np.full(padn, PAD_OOB, np.int32)
        xs = np.zeros(padn, np.int32)
        sel = np.zeros((padn, 2), np.int32)
        for i, (c, y, x, s) in enumerate(lst):
            cf[i], ys[i], xs[i], sel[i] = c, y, x, s
        itx_cuda.itx_bucket("add", t(cf.reshape(padn, -1)), None,
                            (t(sel[:, 0].copy()), t(sel[:, 1].copy())), tx,
                            bitdepth, planes[pl], t(ys), t(xs))

    out = [all_gather_slabs(p, mesh) for p in planes]
    whole = _stitch_tiles(out, n_planes, rows_n, cols_n, band_h4, band_w4,
                          ss_hor, ss_ver, bufs, crop_padt=False)
    return _finish(mesh, seq, fhdr, coders, bufs, whole)


def banded_inloop_filters(mesh, seq, fhdr, coders, bufs, planes):
    """Band-sharded deblock + CDEF with halo exchange over the mesh
    (shared by the sharded intra and inter decodes). planes: whole int32
    tensors on every rank; returns the filtered ones."""
    bitdepth = seq.bitdepth
    n_planes = len(planes)
    planes = list(planes)
    if fhdr.loopfilter_level_y[0] or fhdr.loopfilter_level_y[1]:
        lf = build_lf_arrays(seq, fhdr, coders, bufs.width, bufs.height)
        e_lut, i_lut = calc_eih(fhdr.loopfilter_sharpness)
        lv, lvp, lh_, lhp = _prep_lvls(lf.lvl_y, 0, 1)
        planes[0] = band_deblock_plane(
            mesh, planes[0], lf.edge_v_y, lf.edge_h_y, lv, lvp, lh_, lhp,
            e_lut, i_lut, True, bitdepth)
        if n_planes > 1 and (fhdr.loopfilter_level_u or
                             fhdr.loopfilter_level_v):
            for pl in (0, 1):
                lv, lvp, lh_, lhp = _prep_lvls(lf.lvl_uv, pl, pl)
                planes[1 + pl] = band_deblock_plane(
                    mesh, planes[1 + pl], lf.edge_v_uv, lf.edge_h_uv,
                    lv, lvp, lh_, lhp, e_lut, i_lut, False, bitdepth)

    if seq.cdef and (any(fhdr.cdef_y_strength[:1 << fhdr.cdef_n_bits]) or
                     any(fhdr.cdef_uv_strength[:1 << fhdr.cdef_n_bits])):
        # per-plane direction/strength maps from the single-device plan,
        # then the banded filter with 2-row halos
        cdef_idx_map, noskip = build_cdef_plan(fhdr, coders)
        planes = cdef_banded(mesh, seq, fhdr, bufs, planes, cdef_idx_map,
                             noskip)
    return planes
