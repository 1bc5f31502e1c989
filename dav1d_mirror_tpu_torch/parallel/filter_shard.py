# Ported from dav1d_mirror_tpu/parallel/filter_shard.py (band_deblock_plane
# :49, _band_deblock :86, band_cdef_plane :128, shard_lr_batch :160,
# _band_cdef :195) and dav1d_mirror_tpu/models/tpu_filters.py (_prep_lvls
# :29, cdef_banded :332).
"""In-loop filters sharded across ranks as row bands with halo exchange.

The reference pipelines post-filters per superblock row across a worker
pool (dav1d src/thread_task.c:810-870, deblock_progress bitmaps). Here the
frame becomes row bands, one per rank, and the only cross-band traffic is
a fixed row halo between neighbouring ranks (``mesh.ppermute``):

  * the vertical-edge pass is row-local (whole rows live in the band);
  * the horizontal-edge pass needs up to 7 rows above a band's top edge
    (p-side taps) and writes up to 7 rows back into the neighbour band.
    AV1's filter-width rules confine each edge's read/write span inside
    the adjacent transforms, so every H edge in the frame writes a
    disjoint region (ops/loopfilter.deblock_plane). Each band therefore
    filters [8-row halo | own rows] and returns the halo *delta*, which
    the band above adds into its last rows: exact, because the write
    regions are disjoint integers.

CDEF is simpler: 8x8 blocks read a +-2-px neighbourhood of the
post-deblock frame and write only their own pixels, so a 2-row halo in
each direction with no write-back suffices. Loop restoration's stripe
units are independent given their padded input: the batch shards with no
halo at all.

Every function takes the whole input on every rank plus the mesh, and
returns the whole output on every rank; bit-exact with the single-device
ops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import cdef_cuda, deblock_cuda
from ..ops.cdef import MISSING, UV_DIRS_TBL, adjust_strength_v
from ..ops.looprestoration import wiener_batch
from .mesh import (all_gather_slabs, axis_info, mesh_device, ppermute,
                   shard_bounds)

HALO = 8  # rows: covers the widest H-edge p-side reach (7 for wd16 luma)


def _np(a, dtype=np.int32):
    """A host array of `a` (numpy or a tensor on any device)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype)


def _pad_rows(a, rows, fill=0):
    if a.shape[0] == rows:
        return a
    pad = np.full((rows - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _pad_rows_t(a, rows, fill=0):
    """_pad_rows for a tensor."""
    if a.shape[0] == rows:
        return a
    pad = a.new_full((rows - a.shape[0],) + tuple(a.shape[1:]), fill)
    return torch.cat([a, pad], dim=0)


def _prep_lvls(lvl, ci_v, ci_h):
    """Per-edge levels of a plane from build_lf_arrays' (h4, w4, 4) level
    map: (v, v of the left neighbour, h, h of the top neighbour)."""
    lv = lvl[:, :, ci_v].astype(np.int32)
    lv_prev = np.zeros_like(lv)
    lv_prev[:, 1:] = lv[:, :-1]
    lh = lvl[:, :, ci_h].astype(np.int32)
    lh_prev = np.zeros_like(lh)
    lh_prev[1:, :] = lh[:-1, :]
    return lv, lv_prev, lh, lh_prev


def band_deblock_plane(mesh, plane, edge_v, edge_h, lvl_v, lvl_v_prev,
                       lvl_h, lvl_h_prev, e_lut, i_lut, luma: bool,
                       bitdepth: int):
    """Row-band-sharded ops/loopfilter.deblock_plane: the same arguments,
    whole on every rank (numpy arrays or tensors), plus the mesh. Returns
    the whole filtered plane (int32, on this rank's device)."""
    _, n, me, _ = axis_info(mesh)
    dev = mesh_device(mesh)
    h4, w4 = edge_v.shape
    plane = torch.as_tensor(plane, device=dev).to(torch.int32)
    Hp = plane.shape[0]

    # 4px rows per band; a band is at least HALO tall so one neighbour
    # exchange covers the H-edge reach (tiny planes leave trailing bands
    # as pure padding; their edges are inactive)
    band4 = max(-(-h4 // n), HALO // 4)
    tot4 = band4 * n
    a4, b4 = shard_bounds(tot4, n, me)

    def band(m, fill=0):
        # a copy: the edge maps are edited below
        return torch.tensor(_pad_rows(_np(m), tot4, fill)[a4:b4],
                            device=dev)

    ev, eh = band(edge_v, -1), band(edge_h, -1)
    lv, lvp = band(lvl_v), band(lvl_v_prev)
    lh, lhp = band(lvl_h), band(lvl_h_prev)
    e_l = torch.as_tensor(_np(e_lut), device=dev)
    i_l = torch.as_tensor(_np(i_lut), device=dev)
    pl = _pad_rows_t(plane, max(tot4 * 4, Hp))
    body, tail = pl[:tot4 * 4], pl[tot4 * 4:]
    rows = body[a4 * 4:b4 * 4].clone()

    # vertical pass: row-local (x = 0 has no left neighbour)
    ev[:, 0] = -1
    deblock_cuda.apply_pass(rows, ev, lv, lvp, e_l, i_l, luma, bitdepth)

    # halo: the previous band's last rows, post-V (band 0 gets zeros and
    # masks its top edge: there is no frame above)
    halo = ppermute(rows[-HALO:], mesh, [(i, i + 1) for i in range(n - 1)])
    if me == 0:
        eh[0] = -1
    ext = torch.cat([halo, rows], dim=0)
    deblock_cuda.apply_pass(ext.T[:w4 * 4], eh.T, lh.T, lhp.T, e_l, i_l,
                            luma, bitdepth, base=HALO)

    # return the halo delta to the band above; H-edge writes are
    # frame-wide disjoint, so adding deltas is exact
    back = ppermute(ext[:HALO] - halo, mesh,
                    [(i + 1, i) for i in range(n - 1)])
    own = ext[HALO:]
    own[-HALO:] += back
    out = all_gather_slabs(own, mesh).reshape(-1, own.shape[1])
    return torch.cat([out, tail], dim=0)[:Hp]


def band_cdef_plane(mesh, plane, dir_map, pri_map, sec_map, damping,
                    active, bitdepth: int, bw: int, bh: int):
    """Row-band-sharded ops/cdef.cdef_filter_plane (plane = src): the
    per-pixel filter over block-row-aligned bands with a 2-row pre-CDEF
    halo exchange; frame top and bottom keep the MISSING border. Inputs
    whole on every rank; returns the whole plane (int32, on this rank's
    device)."""
    _, n, me, _ = axis_info(mesh)
    dev = mesh_device(mesh)
    hb, wb = dir_map.shape
    plane = torch.as_tensor(plane, device=dev).to(torch.int32)
    Hp = plane.shape[0]

    bandb = -(-hb // n)                     # block rows per band
    totb = bandb * n
    a, b = shard_bounds(totb, n, me)

    def band(m, dtype=np.int32):
        return torch.as_tensor(_pad_rows(_np(m, dtype), totb)[a:b],
                               device=dev)

    dirs, pris, secs = band(dir_map), band(pri_map), band(sec_map)
    acts = band(active, bool)
    # bands cover exactly the filter region (hb*bh rows); rows below,
    # frame-buffer alignment padding, are MISSING for tap purposes in the
    # single-device filter, so pad with MISSING, not real pixels
    body = _pad_rows_t(plane[:hb * bh], totb * bh, fill=MISSING)
    tail = plane[hb * bh:]
    pl_b = body[a * bh:b * bh].contiguous()

    top = ppermute(pl_b[-2:], mesh, [(i, i + 1) for i in range(n - 1)])
    bot = ppermute(pl_b[:2], mesh, [(i + 1, i) for i in range(n - 1)])
    if me == 0:
        top.fill_(MISSING)
    if me == n - 1:
        bot.fill_(MISSING)
    own = cdef_cuda.cdef_filter_plane(pl_b, pl_b, dirs, pris, secs, damping,
                                      acts, bitdepth, bw, bh,
                                      halo=(top, bot))
    out = all_gather_slabs(own, mesh).reshape(-1, own.shape[1])
    return torch.cat([out, tail], dim=0)[:Hp]


def shard_lr_batch(mesh, padded, fh, fv, w: int, h: int, bitdepth: int):
    """Loop-restoration Wiener stripe units sharded over the mesh. Each
    stripe unit is independent given its padded input (the 3-px borders
    carry the pre-filter rows the reference saves in copy_lpf), so the
    batch axis shards with no halo: the reference's per-sbrow LR task
    chain (lr_apply_tmpl.c) as data parallelism. Inputs whole on every
    rank (the batch is padded to the axis size by repeating its last
    unit); returns the whole (B, h, w) int32 batch."""
    _, n, me, _ = axis_info(mesh)
    dev = mesh_device(mesh)
    padded = torch.as_tensor(padded, device=dev)
    fh = torch.as_tensor(fh, device=dev)
    fv = torch.as_tensor(fv, device=dev)
    B = padded.shape[0]
    padn = (-B) % n

    def pad(t):
        return torch.cat([t, t[-1:].expand(padn, *t.shape[1:])]) \
            if padn else t

    a, b = shard_bounds(B + padn, n, me)
    own = wiener_batch(pad(padded)[a:b], pad(fh)[a:b], pad(fv)[a:b], w, h,
                       bitdepth)
    out = all_gather_slabs(own, mesh)
    return out.reshape(-1, *own.shape[1:])[:B]


def cdef_banded(mesh, seq, fhdr, bufs, planes, cdef_idx_map, noskip):
    """CDEF with the per-pixel filter row-band-sharded over the mesh
    (band_cdef_plane): the per-8x8 direction and strength maps are
    derived exactly as in ops/cdef.cdef_frame, then each plane filters
    its bands with a 2-row halo. planes: whole int32 tensors on every
    rank."""
    dev = mesh_device(mesh)
    bitdepth = seq.bitdepth
    bd_m8 = bitdepth - 8
    damping = fhdr.cdef_damping + bd_m8
    ss_hor, ss_ver = bufs.ss_hor, bufs.ss_ver
    monochrome = seq.layout == 0
    bh4, bw4 = noskip.shape
    h8, w8 = (bh4 + 1) // 2, (bw4 + 1) // 2

    idx8 = np.repeat(np.repeat(np.asarray(cdef_idx_map), 8, 0), 8, 1)
    idx8 = idx8[:h8, :w8]
    ns = np.asarray(noskip)
    if bh4 % 2 or bw4 % 2:
        ns = np.pad(ns, ((0, bh4 % 2), (0, bw4 % 2)))
    ns8 = ns.reshape(h8, 2, w8, 2).any(axis=(1, 3))
    valid = (idx8 >= 0) & ns8
    sel = np.maximum(idx8, 0)
    y_lvl = np.asarray(fhdr.cdef_y_strength, np.int32)[sel]
    uv_lvl = np.asarray(fhdr.cdef_uv_strength, np.int32)[sel]
    valid = valid & ((y_lvl > 0) | (uv_lvl > 0))
    y_pri = (y_lvl >> 2) << bd_m8
    y_sec0 = y_lvl & 3
    y_sec = (y_sec0 + (y_sec0 == 3)) << bd_m8
    uv_pri = (uv_lvl >> 2) << bd_m8
    uv_sec0 = uv_lvl & 3
    uv_sec = (uv_sec0 + (uv_sec0 == 3)) << bd_m8

    dirm, varm = cdef_cuda.cdef_dir(planes[0].to(torch.int32), h8, w8,
                                    bitdepth)
    dirm = dirm.cpu().numpy()
    y_adj = adjust_strength_v(torch.as_tensor(y_pri, device=dev),
                              varm).cpu().numpy()
    pri_map = np.where(y_pri > 0, y_adj, 0)
    dir_y = np.where(y_pri > 0, dirm, 0)
    act_y = valid & (y_lvl > 0)
    out = [band_cdef_plane(mesh, planes[0], dir_y, pri_map,
                           np.where(act_y, y_sec, 0), damping, act_y,
                           bitdepth, 8, 8)]
    if not monochrome and len(planes) > 1:
        uvd = UV_DIRS_TBL[1 if (ss_hor and not ss_ver) else 0]
        dir_uv = np.where(uv_pri > 0, uvd[dirm], 0)
        act_uv = valid & (uv_lvl > 0)
        for pl in (1, 2):
            out.append(band_cdef_plane(
                mesh, planes[pl], dir_uv, np.where(act_uv, uv_pri, 0),
                np.where(act_uv, uv_sec, 0), damping - 1, act_uv,
                bitdepth, 8 >> ss_hor, 8 >> ss_ver))
    else:
        out.extend(planes[1:])
    return out
