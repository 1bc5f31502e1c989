"""Film grain synthesis on the device as PyTorch ops, bit-exact.

Port of ``dav1d_mirror_tpu/ops/filmgrain_tpu.py`` (dav1d
src/fg_apply_tmpl.c + src/filmgrain_tmpl.c:169-421). The sequential parts,
the auto-regressive grain LUT and the per-block LFSR offsets, are tiny and
stay on the host (host/filmgrain.py; ``block_randvals`` here). Applying
the grain is then one data-parallel pass over each plane:

  per pixel: gather 4 grain patches (cur / left / top / topleft block
  offsets), blend the 2-px overlap bands with the spec's 27/17 (23/22)
  weights, look up the piecewise-linear scaling LUT at the (luma-mixed)
  source value, add round2(scaling * grain, shift), clip.

Everything is int32. The LUT and scaling-table gathers clamp their
indices into the table, as the reference's ``mode="clip"`` takes do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..host.filmgrain import (FG_BLOCK_SIZE, GRAIN_WIDTH, _rand, _row_seeds,
                              generate_grain_uv, generate_grain_y,
                              generate_scaling)


def block_randvals(fgd, n_rows: int, n_bx: int) -> np.ndarray:
    """Per-(block-row, block-col) 8-bit offset seeds R[r][b].

    Row r's chain starts from the row seed (filmgrain_tmpl.c row_num
    hash) and advances once per 32-px block column; the overlap reads
    for row r use row r-1's chain at the same columns, i.e. R[r-1][b].
    """
    R = np.zeros((n_rows, n_bx), np.int32)
    for r in range(n_rows):
        seed = _row_seeds(fgd, r, 1)[0]
        for b in range(n_bx):
            seed, v = _rand(seed, 8)
            R[r, b] = v
    return R


def _off_maps(R, sx, sy):
    """randval grid -> (offy, offx) grids (filmgrain_tmpl.c offsets)."""
    offx = 3 + (2 >> sx) * (3 + (R >> 4))
    offy = 3 + (2 >> sy) * (3 + (R & 0xF))
    return offy, offx


def _take(table, idx):
    """table.reshape(-1)[idx] with idx clamped into the table."""
    flat = table.reshape(-1)
    return flat[idx.clamp(0, flat.numel() - 1).long()]


def _fg_blend_grain(lut, offyx, sx: int, sy: int, overlap: bool,
                    bh_step: int, step: int, gmax: int):
    """Per-pixel blended grain field for one plane.

    lut: grain LUT (h, 82) int32. offyx: (4, 2, nby, nbx) int32 —
    [cur/left/top/topleft][offy/offx] per block. Returns (H, W) int32
    grain (H = nby*bh_step, W = nbx*step)."""
    dev = lut.device
    nby, nbx = offyx.shape[2], offyx.shape[3]
    H, W = nby * bh_step, nbx * step
    ar_h = torch.arange(H, device=dev, dtype=torch.int32)
    ar_w = torch.arange(W, device=dev, dtype=torch.int32)
    yy, by = ar_h % bh_step, ar_h // bh_step        # in-block y, block row
    xx, bx = ar_w % step, ar_w // step
    by_l, bx_l = by.long()[:, None], bx.long()[None, :]

    def patch(which, dy, dx):
        oy = offyx[which, 0][by_l, bx_l] + yy[:, None] + dy
        ox = offyx[which, 1][by_l, bx_l] + xx[None, :] + dx
        return _take(lut, oy * GRAIN_WIDTH + ox)

    g = patch(0, 0, 0)
    if not overlap:
        return g

    g_l = patch(1, 0, step)
    g_t = patch(2, bh_step, 0)
    g_tl = patch(3, bh_step, step)
    gmin = -gmax - 1

    def r2c(a, w0, b, w1):
        return ((a * w0 + b * w1 + 16) >> 5).clamp(gmin, gmax)

    def weights(first, rest, i):
        """(w0, w1) per in-block index i: the first column/row of a block
        blends with `first`, the second with `rest` (27/17 then 17/27;
        23/22 then nothing when subsampled)."""
        f0, f1 = first
        r0, r1 = rest
        return (torch.where(i == 0, f0, r0).to(torch.int32),
                torch.where(i == 0, f1, r1).to(torch.int32))

    # horizontal 27/17 (or 23/22 when subsampled) overlap columns
    if sx:
        xw0, xw1 = weights((23, 22), (0, 0), xx)
        xm = (xx < 1) & (bx > 0)
    else:
        xw0, xw1 = weights((27, 17), (17, 27), xx)
        xm = (xx < 2) & (bx > 0)
    xw0, xw1, xm = xw0[None, :], xw1[None, :], xm[None, :]
    g1 = torch.where(xm, r2c(g_l, xw0, g, xw1), g)
    t1 = torch.where(xm, r2c(g_tl, xw0, g_t, xw1), g_t)

    # vertical overlap rows
    if sy:
        yw0, yw1 = weights((23, 22), (0, 0), yy)
        ym = (yy < 1) & (by > 0)
    else:
        yw0, yw1 = weights((27, 17), (17, 27), yy)
        ym = (yy < 2) & (by > 0)
    yw0, yw1, ym = yw0[:, None], yw1[:, None], ym[:, None]
    return torch.where(ym, r2c(t1, yw0, g1, yw1), g1)


def _fgy_apply(src, grain, scaling, scaling_shift: int, bitdepth: int,
               clip: bool):
    bd_m8 = bitdepth - 8
    if clip:
        min_v, max_v = 16 << bd_m8, 235 << bd_m8
    else:
        min_v, max_v = 0, (1 << bitdepth) - 1
    sc = _take(scaling, src)
    noise = (sc * grain + ((1 << scaling_shift) >> 1)) >> scaling_shift
    return (src + noise).clamp(min_v, max_v)


def _fguv_apply(src, luma, grain, scaling, scaling_shift: int,
                bitdepth: int, clip: bool, is_id: bool, sx: int, csfl: bool,
                uv_luma_mult: int, uv_mult: int, uv_offset: int):
    bd_m8 = bitdepth - 8
    bd_max = (1 << bitdepth) - 1
    if clip:
        min_v = 16 << bd_m8
        max_v = (235 if is_id else 240) << bd_m8
    else:
        min_v, max_v = 0, bd_max
    lu = luma[::2] if luma.shape[0] != src.shape[0] else luma
    if sx:
        avg = (lu[:, 0::2] + lu[:, 1::2] + 1) >> 1
    else:
        avg = lu
    avg = avg[:src.shape[0], :src.shape[1]]
    if csfl:
        val = avg
    else:
        combined = avg * uv_luma_mult + src * uv_mult
        val = ((combined >> 6) + uv_offset * (1 << bd_m8)).clamp(0, bd_max)
    sc = _take(scaling, val)
    noise = (sc * grain + ((1 << scaling_shift) >> 1)) >> scaling_shift
    return (src + noise).clamp(min_v, max_v)


def _pad_to(a, hh: int, ww: int):
    """a (int32) zero-padded (or cut) to (hh, ww) at the top-left."""
    out = a.new_zeros((hh, ww), dtype=torch.int32)
    h, w = min(hh, a.shape[0]), min(ww, a.shape[1])
    out[:h, :w] = a[:h, :w]
    return out


def apply_film_grain(planes, seq, fhdr, width: int, height: int):
    """Grain the frame's padded planes (tensors on one device, any
    integer dtype; luma at least width + 1 columns when the chroma is
    horizontally subsampled and width is odd). Returns new tensors of the
    same shapes and dtypes; the inputs are not written. Port of
    ``apply_film_grain_tpu`` (filmgrain_tpu.py:150)."""
    fgd = fhdr.film_grain_data
    bitdepth = seq.bitdepth
    ss_x = 1 if seq.layout != 3 else 0
    ss_y = 1 if seq.layout == 1 else 0
    monochrome = seq.layout == 0
    is_id = seq.mtrx == 0
    overlap = bool(fgd.overlap_flag)
    gmax = (128 << (bitdepth - 8)) - 1
    dev = planes[0].device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    out = [p.clone() for p in planes]
    n_rows = (height + FG_BLOCK_SIZE - 1) // FG_BLOCK_SIZE
    n_bx = (width + FG_BLOCK_SIZE - 1) // FG_BLOCK_SIZE
    R = block_randvals(fgd, n_rows, n_bx)
    lut_y = generate_grain_y(fgd, bitdepth)

    def off_tensor(sx, sy):
        oy, ox = _off_maps(R, sx, sy)
        z = np.zeros_like(oy)
        left = np.concatenate([z[:, :1], oy[:, :-1]], 1), \
            np.concatenate([z[:, :1], ox[:, :-1]], 1)
        top = np.concatenate([z[:1], oy[:-1]], 0), \
            np.concatenate([z[:1], ox[:-1]], 0)
        tl = np.concatenate([z[:1], left[0][:-1]], 0), \
            np.concatenate([z[:1], left[1][:-1]], 0)
        return up(np.stack([np.stack([oy, ox]), np.stack(left),
                            np.stack(top), np.stack(tl)]))

    # luma
    if fgd.num_y_points:
        sc_y = generate_scaling(bitdepth, fgd.y_points, fgd.num_y_points)
        H, W = n_rows * FG_BLOCK_SIZE, n_bx * FG_BLOCK_SIZE
        grain = _fg_blend_grain(up(lut_y), off_tensor(0, 0), 0, 0, overlap,
                                FG_BLOCK_SIZE, FG_BLOCK_SIZE, gmax)
        src = _pad_to(planes[0][:height, :width].to(torch.int32), H, W)
        res = _fgy_apply(src, grain, up(sc_y), int(fgd.scaling_shift),
                         bitdepth, bool(fgd.clip_to_restricted_range))
        out[0][:height, :width] = res[:height, :width].to(out[0].dtype)

    if monochrome or not (fgd.num_uv_points[0] or fgd.num_uv_points[1]
                          or fgd.chroma_scaling_from_luma):
        return out

    # chroma: luma source with odd-width column replication (reference
    # fg_apply_tmpl.c; filmgrain_tpu.py:204-209)
    luma_in = planes[0].to(torch.int32, copy=True)
    if width & ss_x:
        luma_in[:, width] = luma_in[:, width - 1]

    step = FG_BLOCK_SIZE >> ss_x
    bh_step = FG_BLOCK_SIZE >> ss_y
    cpw = (width + ss_x) >> ss_x
    cph = (height + ss_y) >> ss_y
    Hc, Wc = n_rows * bh_step, n_bx * step
    offs = off_tensor(ss_x, ss_y)
    luma_pad = _pad_to(luma_in[:cph << ss_y, :cpw << ss_x],
                       Hc << ss_y, Wc << ss_x)

    sc_luma = None
    for pl in range(2):
        if fgd.chroma_scaling_from_luma:
            if sc_luma is None:
                sc_luma = generate_scaling(bitdepth, fgd.y_points,
                                           fgd.num_y_points)
            sc = sc_luma
        elif fgd.num_uv_points[pl]:
            sc = generate_scaling(bitdepth, fgd.uv_points[pl],
                                  fgd.num_uv_points[pl])
        else:
            continue
        lut_uv = generate_grain_uv(fgd, lut_y, pl, ss_x, ss_y, bitdepth)
        grain = _fg_blend_grain(up(lut_uv), offs, ss_x, ss_y, overlap,
                                bh_step, step, gmax)
        src = _pad_to(planes[1 + pl][:cph, :cpw].to(torch.int32), Hc, Wc)
        res = _fguv_apply(src, luma_pad, grain, up(sc),
                          int(fgd.scaling_shift), bitdepth,
                          bool(fgd.clip_to_restricted_range), bool(is_id),
                          ss_x, bool(fgd.chroma_scaling_from_luma),
                          int(fgd.uv_luma_mult[pl]), int(fgd.uv_mult[pl]),
                          int(fgd.uv_offset[pl]))
        out[1 + pl][:cph, :cpw] = res[:cph, :cpw].to(out[1 + pl].dtype)
    return out
