"""Batched motion compensation as PyTorch ops on int32 tensors.

Port of ``dav1d_mirror_tpu/ops/mc_tpu.py``. The host planner decomposes
every translational MC block into
fixed-size units (8x8, with 4-wide/4-tall remainder buckets) that share
one subpel phase each; these functions run one bucket:

- ``mc_unit_batch``: single-stage put/prep over clamped (uh+7, uw+7)
  windows (edge emulation == clamped gather, dav1d mc:986-999);
- ``mc_hplanes`` + ``mc_unit_batch_hv``: the two-stage form of the
  has_h & has_v buckets. They are the plain versions of the two CUDA
  kernels in ``csrc/`` (wrappers in ``ops/mc_cuda.py``);
- ``gather_units`` / ``scatter_units``: read / write unit batches of a
  plane.

The rest of the inter toolset runs on whole-block batches: the compound
joins (``avg_batch``, ``w_avg_batch``, ``mask_batch``, ``w_mask_batch``),
the affine warp (``warp8x8_batch``) and the OBMC blend
(``obmc_blend_batch``). Blocks whose reference has another size
than the frame run ``mc_scaled_batch``; super-resolution upscales a plane
with ``resize_plane``.

``mc_units_plane`` / ``mc_units_slots`` / ``mc_scaled_plane`` /
``mc_scaled_slots`` run one bucket with its destination write, and
``mc_units_run`` / ``mc_scaled_run`` a frame's work list of them
(``mc_build_table``): the plain versions of the unit MC kernels
``csrc/mc_units.cu`` and ``csrc/mc_scaled.cu`` (wrappers in
``ops/mcu_cuda.py``). ``warp_run`` (a frame's warp work list, one
``warp_plane`` or ``warp_slots`` an entry: the warp with its destination
write), ``comp_run`` (a frame's compound joins, one ``comp_record`` an
entry: every join of a compound record, stored into the plane) and
``obmc_run`` (a phase's OBMC work list, one ``obmc_plane`` an entry) are
the plain versions of the tool kernels
``csrc/warp.cu``, ``csrc/comp.cu`` and ``csrc/obmc.cu`` (wrappers in
``ops/tools_cuda.py``).

Bit-exact with dav1d src/mc_tmpl.c put_8tap:112 / prep_8tap:224, avg:589,
w_avg:604, mask:620, w_mask:683, warp_affine_8x8:758 / 8x8t:793,
blend_v:655 / blend_h:668, put/prep_8tap_scaled:172/287, resize:877.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.tables import TABLES

# (6, 15, 8) subpel filter table; rows 0..2 = 8-tap regular/smooth/sharp,
# 3..4 = 4-tap variants (w <= 4), 5 = bilin
SUBPEL = np.asarray(TABLES["mc_subpel_filters"], np.int32)

# Filter2d -> (type_h, type_v)
_F2D = np.asarray([[0, 0], [0, 1], [0, 2],
                   [2, 0], [2, 1], [2, 2],
                   [1, 0], [1, 1], [1, 2]], np.int32)

# Sentinel row origin marking shape-padding batch entries: far enough out
# of bounds that every scatter index of the unit is dropped, small enough
# that index arithmetic cannot overflow int32.
PAD_OOB = 1 << 20

HPAD_L = 15          # covers window-origin x0 >= -(uw+7) after clamping
HPAD_R = 14          # x0 max = W+6, taps reach W+13


def ibits(bitdepth):
    return 4 if bitdepth == 8 else 14 - bitdepth


@functools.lru_cache(maxsize=None)
def subpel_table(device) -> torch.Tensor:
    """The subpel filter table as a contiguous int32 tensor on `device`."""
    return torch.as_tensor(SUBPEL, device=device).contiguous()


@functools.lru_cache(maxsize=None)
def _f2d_table(device) -> torch.Tensor:
    return torch.as_tensor(_F2D, device=device)


def _filters_for(ftype, subpel, small: bool):
    """Per-unit (B, 8) filter rows. ftype: (B,) 0..2; subpel: (B,) 1..15."""
    row = 3 + (ftype & 1) if small else ftype
    return subpel_table(ftype.device)[row.long(), (subpel - 1).long()]


def _taps(acc_src, f, n, axis):
    """8 shifted multiply-adds along `axis` (1 = rows, 2 = columns) of a
    (B, h, w) int32 window with per-unit taps f (B, 8)."""
    def tap(k):
        v = acc_src[:, k:k + n] if axis == 1 else acc_src[:, :, k:k + n]
        return v * f[:, k, None, None]
    acc = tap(0)
    for k in range(1, 8):
        acc = acc + tap(k)
    return acc


def mc_unit_batch(args, uw: int, uh: int, has_h: bool, has_v: bool,
                  bitdepth: int, prep: bool):
    """args = (ref_stack (R, H, W) int32, ref_idx (B,), oy (B,), ox (B,)
    window origins (may be negative; clamped gather), mx (B,), my (B,)
    subpel 1..15, f2d (B,) Filter2d enum).

    Returns (B, uh, uw) int32: pixels (put) or int16-domain tmp (prep)."""
    ref_stack, ref_idx, oy, ox, mx, my, f2d = args
    dev = ref_stack.device
    H, W = ref_stack.shape[1], ref_stack.shape[2]
    ib = ibits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    bd_max = (1 << bitdepth) - 1

    win_h = uh + 7 if has_v else uh
    win_w = uw + 7 if has_h else uw
    ar_h = torch.arange(win_h, device=dev, dtype=torch.int32)
    ar_w = torch.arange(win_w, device=dev, dtype=torch.int32)
    ys = (oy[:, None] + ar_h[None, :]).clamp(0, H - 1).long()
    xs = (ox[:, None] + ar_w[None, :]).clamp(0, W - 1).long()
    win = ref_stack[ref_idx.long()[:, None, None], ys[:, :, None],
                    xs[:, None, :]].to(torch.int32)

    f2d_tab = _f2d_table(dev)
    th = f2d_tab[f2d.long(), 0]
    tv = f2d_tab[f2d.long(), 1]

    if has_h:
        fh = _filters_for(th, mx, uw <= 4)  # (B, 8)
        hsum = _taps(win, fh, uw, 2)
        if has_v:
            mid = (hsum + ((1 << (6 - ib)) >> 1)) >> (6 - ib)
        else:
            if prep:
                return ((hsum + ((1 << (6 - ib)) >> 1)) >> (6 - ib)) - bias
            irnd = 32 + ((1 << (6 - ib)) >> 1)
            return ((hsum + irnd) >> 6).clamp(0, bd_max)
    else:
        mid = win

    if has_v:
        fv = _filters_for(tv, my, uh <= 4)
        vsum = _taps(mid, fv, uh, 1)
        if has_h:
            if prep:
                return ((vsum + 32) >> 6) - bias
            return ((vsum + ((1 << (6 + ib)) >> 1)) >> (6 + ib)).clamp(
                0, bd_max)
        if prep:
            return ((vsum + ((1 << (6 - ib)) >> 1)) >> (6 - ib)) - bias
        return ((vsum + 32) >> 6).clamp(0, bd_max)

    # copy path
    if prep:
        return (win[:, :uh, :uw] << ib) - bias
    return win[:, :uh, :uw]


# ---------------------------------------------------------------------
# Two-stage MC for the has_h & has_v buckets (the dominant case): the
# horizontal pass runs once per distinct (ref, filter_row, mx) combo over
# the whole plane, and each unit then gathers only its (uh+7, uw) mid
# window. The mid values are the same ints as in mc_unit_batch (same
# taps on the same clamped pixels, same rounding), so the result is
# bit-exact with mc_unit_batch(..., has_h=True, has_v=True).
# ---------------------------------------------------------------------
def mc_hplanes(ref_stack, combos, bitdepth):
    """Plain version of the ``mc_hplanes`` CUDA kernel. ref_stack:
    (R, H, W) int32; combos: (C, 3) int32 rows (ref, filter_row, mx).
    Returns (C, H, W+22) int16 mid planes indexed by window origin
    xh = x0 + 15 (x0 in [-15, W+6]); rows unchanged. The int16 cast
    truncates like the reference's ``astype(int16)``."""
    R, H, W = ref_stack.shape
    dev = ref_stack.device
    ib = ibits(bitdepth)
    # edge-replicated columns: 15 on the left, 14 on the right
    xs = (torch.arange(W + HPAD_L + HPAD_R, device=dev) - HPAD_L).clamp(
        0, W - 1)
    sel = ref_stack.index_select(0, combos[:, 0].long())[:, :, xs]
    f = subpel_table(dev)[combos[:, 1].long(), (combos[:, 2] - 1).long()]
    acc = _taps(sel, f, W + 22, 2)
    mid = (acc + ((1 << (6 - ib)) >> 1)) >> (6 - ib)
    return mid.to(torch.int16)


def mc_unit_batch_hv(args, uw: int, uh: int, bitdepth: int, prep: bool):
    """Plain version of the ``mc_vpass`` CUDA kernel: vertical pass over
    gathered mid windows. args = (hstack (C, H, W+22) int16 from
    mc_hplanes, slot (B,), oy (B,), ox (B,) pre-clamped to [-15, W-1],
    my (B,), tv (B,) vertical filter type)."""
    hstack, slot, oy, ox, my, tv = args
    dev = hstack.device
    H = hstack.shape[1]
    ib = ibits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    ar_h = torch.arange(uh + 7, device=dev, dtype=torch.int32)
    ar_w = torch.arange(uw, device=dev, dtype=torch.int32)
    ys = (oy[:, None] + ar_h[None, :]).clamp(0, H - 1).long()
    xh = ((ox + HPAD_L)[:, None] + ar_w[None, :]).long()
    mid = hstack[slot.long()[:, None, None], ys[:, :, None],
                 xh[:, None, :]].to(torch.int32)
    fv = _filters_for(tv, my, uh <= 4)
    vsum = _taps(mid, fv, uh, 1)
    if prep:
        return ((vsum + 32) >> 6) - bias
    return ((vsum + ((1 << (6 + ib)) >> 1)) >> (6 + ib)).clamp(
        0, (1 << bitdepth) - 1)


def mc_hv_combos(arr, uw):
    """Host-side combo/slot mapping for a has_h&has_v descriptor bucket.
    arr: (B, 6) np int32 (ref, oy, ox, mx, my, f2d). Returns
    (combos (C,3) padded to a multiple of 8, slot (B,), tv (B,))."""
    th = _F2D[arr[:, 5], 0]
    tv = _F2D[arr[:, 5], 1]
    filt_row = np.where(uw <= 4, 3 + (th & 1), th)
    key = np.stack([arr[:, 0], filt_row, arr[:, 3]], axis=1)
    combos, slot = np.unique(key, axis=0, return_inverse=True)
    # quantized padding (8, 16, 24, 40, 64, 96, 144, ... — 1.5x steps
    # kept multiples of 8), as the reference packer pads
    padded = 8
    while padded < combos.shape[0]:
        padded = (padded + (padded >> 1) + 7) & ~7
    if padded != combos.shape[0]:
        combos = np.concatenate(
            [combos, np.repeat(combos[-1:], padded - combos.shape[0], 0)])
    return (combos.astype(np.int32), slot.astype(np.int32),
            tv.astype(np.int32))


def unit_index(ys, xs, uh, uw, shape):
    """(yy, xx, ok) element coordinates of (B, uh, uw) units at top-left
    (ys, xs), and the mask of those inside a plane of `shape`. Pad rows
    carry PAD_OOB origins; the reference's scatters drop them implicitly,
    here the mask drops them."""
    dev = ys.device
    H, W = shape
    yy = ys[:, None, None] + torch.arange(uh, device=dev,
                                          dtype=ys.dtype)[None, :, None]
    xx = xs[:, None, None] + torch.arange(uw, device=dev,
                                          dtype=xs.dtype)[None, None, :]
    yy, xx = torch.broadcast_tensors(yy, xx)
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    return yy, xx, ok


def gather_units(plane, ys, xs, uh, uw):
    """Read (B, uh, uw) units from plane at top-left (ys, xs). Indices
    are clamped into the plane, as the reference's gather clamps them
    (the callers' origins lie inside it; pad rows repeat a real unit)."""
    dev = ys.device
    H, W = plane.shape
    yy = (ys[:, None, None] + torch.arange(
        uh, device=dev, dtype=ys.dtype)[None, :, None]).clamp(0, H - 1)
    xx = (xs[:, None, None] + torch.arange(
        uw, device=dev, dtype=xs.dtype)[None, None, :]).clamp(0, W - 1)
    return plane[yy.long(), xx.long()]


def scatter_units(plane, units, ys, xs, uh, uw):
    """Write (B, uh, uw) units into plane at top-left (ys, xs). Units are
    disjoint. Writes IN PLACE (a frame's planes take hundreds of bucket
    scatters; a functional copy per bucket would move the whole plane
    each time) and returns the plane."""
    yy, xx, ok = unit_index(ys, xs, uh, uw, plane.shape)
    plane[yy[ok].long(), xx[ok].long()] = units[ok].to(plane.dtype)
    return plane


# ---------------------------------------------------------------------
# Unit MC with its destination write: the plain versions of the two
# CUDA kernels csrc/mc_units.cu and csrc/mc_scaled.cu (wrappers in
# ops/mcu_cuda.py). Descriptors may be int16 or int32 views of the
# frame's descriptor buffers; each is widened here.
# ---------------------------------------------------------------------
def _cols(arr):
    return arr.to(torch.int32).unbind(1)


def mc_units_plane(plane, ref_stack, arr, ys, xs, uw: int, uh: int,
                   has_h: bool, has_v: bool, bitdepth: int,
                   prep: bool = False):
    """mc_unit_batch on the (B, 6) rows `arr` (ref, oy, ox, mx, my, f2d)
    written into `plane` at (ys, xs) by scatter_units: pixels outside the
    plane are dropped, so are PAD_OOB and OOB16 pad rows. In place;
    returns the plane."""
    out = mc_unit_batch((ref_stack, *_cols(arr)), uw, uh, has_h, has_v,
                        bitdepth, prep)
    return scatter_units(plane, out, ys.to(torch.int32),
                         xs.to(torch.int32), uh, uw)


def mc_units_slots(buf, ref_stack, arr, slots, has_h: bool, has_v: bool,
                   bitdepth: int, prep: bool):
    """mc_unit_batch of whole (bhp, bwp) slots of the (N, bhp, bwp) slot
    buffer `buf`, written by set_slots (duplicate slots carry identical
    values). In place; returns buf."""
    _, uh, uw = buf.shape
    out = mc_unit_batch((ref_stack, *_cols(arr)), uw, uh, has_h, has_v,
                        bitdepth, prep)
    return set_slots(buf, slots, out)


# ---------------------------------------------------------------------
# compound joins (dav1d mc_tmpl.c avg:589, w_avg:604, mask:620,
# w_mask:683) on (B, h, w) int32 prep-domain pairs
# ---------------------------------------------------------------------
def avg_batch(tmp1, tmp2, bitdepth):
    ib = ibits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    rnd = (1 << ib) + bias * 2
    return ((tmp1 + tmp2 + rnd) >> (ib + 1)).clamp(0, (1 << bitdepth) - 1)


def w_avg_batch(tmp1, tmp2, weight, bitdepth):
    """weight: (B, 1, 1) int32."""
    ib = ibits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    rnd = (8 << ib) + bias * 16
    return ((tmp1 * weight + tmp2 * (16 - weight) + rnd) >> (ib + 4)).clamp(
        0, (1 << bitdepth) - 1)


def mask_batch(tmp1, tmp2, m, bitdepth):
    """m: (B, h, w) int32 in [0, 64]."""
    ib = ibits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    rnd = (32 << ib) + bias * 64
    return ((tmp1 * m + tmp2 * (64 - m) + rnd) >> (ib + 6)).clamp(
        0, (1 << bitdepth) - 1)


def w_mask_batch(tmp1, tmp2, sign, ss_hor: int, ss_ver: int, bitdepth: int):
    """tmp1/tmp2: (B, h, w) prep-domain (tmp1 = mask_sign side); sign:
    (B,). Returns (pixels (B, h, w), chroma mask (B, h>>ssv, w>>ssh))."""
    ib = ibits(bitdepth)
    sh = ib + 6
    bias = 0 if bitdepth == 8 else 8192
    rnd = (32 << ib) + bias * 64
    mask_sh = bitdepth + ib - 4
    mask_rnd = 1 << (mask_sh - 5)
    t1 = tmp1.to(torch.int32)
    t2 = tmp2.to(torch.int32)
    m = (38 + (((t1 - t2).abs() + mask_rnd) >> mask_sh)).clamp(max=64)
    dst = ((t1 * m + t2 * (64 - m) + rnd) >> sh).clamp(
        0, (1 << bitdepth) - 1)
    if ss_hor:
        mpair = m[:, :, 0::2] + m[:, :, 1::2]
        sgn = sign[:, None, None]
        if ss_ver:
            mm = (mpair[:, 0::2] + mpair[:, 1::2] + 2 - sgn) >> 2
        else:
            mm = (mpair + 1 - sgn) >> 1
    else:
        mm = m
    return dst, mm.to(torch.int32)


# ---------------------------------------------------------------------
# slot buffers of the compound / OBMC side batches. Every write below is
# in place on a buffer the caller made for this op. Duplicate indices
# (pad rows) always carry identical values, or aim at the group's
# sacrificial pad slot, whose destination is PAD_OOB: so the order in
# which a CUDA index_put_ applies duplicates cannot change the result.
# ---------------------------------------------------------------------
def set_slots(buf, slots, vals):
    """buf[slots] = vals."""
    buf[slots.long()] = vals.to(buf.dtype)
    return buf


def scatter_slot_units(buf, base, vals, uh: int, uw: int, row_w: int):
    """Write (B, uh, uw) vals at flat offsets `base` into the flattened
    (N, bhp, bwp) slot buffer (sub-rect writes within compound slots)."""
    dev = base.device
    fi = (base[:, None, None].long() +
          torch.arange(uh, device=dev)[None, :, None] * row_w +
          torch.arange(uw, device=dev)[None, None, :])
    buf.view(-1)[fi.reshape(-1)] = vals.reshape(-1).to(buf.dtype)
    return buf


def _signed_pair(tmp0, tmp1, sl, sgn):
    """The slots' operand pair, mask side first (sgn == 0: side 0)."""
    t0, t1 = tmp0[sl.long()], tmp1[sl.long()]
    s = (sgn == 0)[:, None, None]
    return torch.where(s, t0, t1), torch.where(s, t1, t0)


# ---------------------------------------------------------------------
# a compound record's joins stored into the plane, one entry of the
# frame's comp work list (comp_run, the plain version of csrc/comp.cu;
# wrapper ops/tools_cuda.comp_run). The record's table has a row a real
# slot, in slot order: the join, its weight (CJ_WAVG: 8 for a plain
# average) or mask sign, and its mask's offset (CJ_SEGL: where its
# chroma mask goes in a seg-mask arena; CJ_SEGC: where its mask lies
# there; CJ_WEDGE: where its mask lies in the frame's int32 descriptor
# buffer).
# ---------------------------------------------------------------------
CJ_WAVG, CJ_SEGL, CJ_SEGC, CJ_WEDGE = range(4)
CJ_COLS = 3


def _flat_index(offs, n):
    """(len(offs), n) indices of n consecutive values at each offset of a
    flat tensor."""
    return offs.long()[:, None] + torch.arange(n, device=offs.device)


def comp_record(plane, tmp0, tmp1, tab, dy, dx, masks, desc, ss_hor: int,
                ss_ver: int, bitdepth: int):
    """Every join of one compound record (w_avg_batch, w_mask_batch or
    mask_batch on the sign-ordered pair of each slot) stored into the
    plane by scatter_units. tmp0, tmp1: the (N, bhp, bwp) int32 side
    slot buffers; tab: (n, CJ_COLS) int32, the table of slots 0..n-1 (the
    record's real slots; the pad slots after them are not computed); dy,
    dx: (>= n,) plane origins of the slots (pixels outside the plane are
    dropped); masks: a flat int32 seg-mask arena (None when the record
    has no seg join); desc: the frame's flat int32 descriptor
    buffer. A seg luma slot's chroma mask (w_mask_batch's) is written
    into `masks` at its offset. Updates plane (and masks) in place and
    returns the plane."""
    _, bhp, bwp = tmp0.shape
    t = tab.cpu().numpy()
    dy, dx = dy[:len(t)], dx[:len(t)]
    for kind in (CJ_WAVG, CJ_SEGL, CJ_SEGC, CJ_WEDGE):
        rows = np.flatnonzero(t[:, 0] == kind)
        if not len(rows):
            continue
        idx = torch.from_numpy(rows).to(tmp0.device)
        par = tab[idx, 1].to(torch.int32)
        if kind == CJ_WAVG:
            res = w_avg_batch(tmp0[idx], tmp1[idx], par[:, None, None],
                              bitdepth)
        else:
            a, b = _signed_pair(tmp0, tmp1, idx, par)
            moff = tab[idx, 2]
            if kind == CJ_SEGL:
                res, cm = w_mask_batch(a, b, par, ss_hor, ss_ver, bitdepth)
                masks[_flat_index(moff, cm[0].numel())] = cm.reshape(
                    len(rows), -1)
            else:
                src = masks if kind == CJ_SEGC else desc
                m = src[_flat_index(moff, bhp * bwp)].view(-1, bhp, bwp)
                res = mask_batch(a, b, m, bitdepth)
        scatter_units(plane, res, dy[idx], dx[idx], bhp, bwp)
    return plane


# ---------------------------------------------------------------------
# affine warp: batched 8x8 sub-blocks (dav1d mc_tmpl.c
# warp_affine_8x8:758 / warp_affine_8x8t:793). Each unit gathers a
# clamped (15, 15) source window; the per-pixel filter rows come from the
# warp filter table at the affine phase (tmx / tmy).
# ---------------------------------------------------------------------
WARP_FILTER = np.asarray(TABLES["mc_warp_filter"], np.int32)  # (193, 8)


@functools.lru_cache(maxsize=None)
def _warp_table(device) -> torch.Tensor:
    return torch.as_tensor(WARP_FILTER, device=device).contiguous()


def _warp_filters(wf, phase):
    """Filter rows of the warp phases: table row 64 + ((phase+512) >> 10),
    taken as the reference's gather takes it: a negative row down to
    -193 counts from the table's end, then the row is clamped into the
    table (AV1's shear limits keep the row in 0..128)."""
    n = wf.shape[0]
    idx = 64 + ((phase + 512) >> 10)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return wf[idx.long()]


def warp8x8_batch(ref_stack, args, bitdepth: int, prep: bool):
    """args: (B, 10) int32 rows [ref, oy, ox, mx, my, alpha, beta, gamma,
    delta, pad] where (oy, ox) is the window origin (dy-3, dx-3) and
    mx/my the per-unit phase bases. Returns (B, 8, 8) int32: pixels or
    prep tmp."""
    dev = ref_stack.device
    ref_idx = args[:, 0].long()
    oy, ox = args[:, 1], args[:, 2]
    mx, my = args[:, 3], args[:, 4]
    al, be, ga, de = (args[:, k, None, None] for k in (5, 6, 7, 8))
    H, W = ref_stack.shape[1], ref_stack.shape[2]
    ib = ibits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    wf = _warp_table(dev)

    ar15 = torch.arange(15, device=dev, dtype=torch.int32)
    ys = (oy[:, None] + ar15[None, :]).clamp(0, H - 1).long()
    xs = (ox[:, None] + ar15[None, :]).clamp(0, W - 1).long()
    win = ref_stack[ref_idx[:, None, None], ys[:, :, None],
                    xs[:, None, :]].to(torch.int32)

    xv = torch.arange(8, device=dev, dtype=torch.int32)[None, None, :]
    # horizontal: tmx(y, x) = mx + x*alpha + y*beta, 15 rows
    tmx = mx[:, None, None] + xv * al + ar15[None, :, None] * be
    fh = _warp_filters(wf, tmx)                     # (B, 15, 8, 8)
    hsum = fh[..., 0] * win[:, :, 0:8]
    for k in range(1, 8):
        hsum = hsum + fh[..., k] * win[:, :, k:k + 8]
    mid = (hsum + ((1 << (7 - ib)) >> 1)) >> (7 - ib)   # (B, 15, 8)

    yv8 = torch.arange(8, device=dev, dtype=torch.int32)[None, :, None]
    tmy = my[:, None, None] + xv * ga + yv8 * de
    fv = _warp_filters(wf, tmy)                     # (B, 8, 8, 8)
    vsum = fv[..., 0] * mid[:, 0:8]
    for k in range(1, 8):
        vsum = vsum + fv[..., k] * mid[:, k:k + 8]
    if prep:
        return ((vsum + 64) >> 7) - bias
    return ((vsum + ((1 << (7 + ib)) >> 1)) >> (7 + ib)).clamp(
        0, (1 << bitdepth) - 1)


def warp_plane(plane, ref_stack, rows, ys, xs, bitdepth: int):
    """warp8x8_batch (put) of the (B, 10) int32 rows written into `plane`
    at (ys, xs) by scatter_units: pixels outside the plane are dropped,
    so are PAD_OOB pad rows. In place; returns the plane."""
    out = warp8x8_batch(ref_stack, rows, bitdepth, False)
    return scatter_units(plane, out, ys, xs, 8, 8)


def warp_slots(buf, ref_stack, rows, base, bitdepth: int, prep: bool):
    """warp8x8_batch of the (B, 10) int32 rows written at the flat
    offsets `base` of the (N, bhp, bwp) slot buffer `buf` by
    scatter_slot_units (pad rows repeat the last unit, with its values).
    In place; returns buf."""
    out = warp8x8_batch(ref_stack, rows, bitdepth, prep)
    return scatter_slot_units(buf, base, out, 8, 8, buf.shape[2])


# ---------------------------------------------------------------------
# OBMC blends (dav1d mc_tmpl.c blend_v:655 / blend_h:668)
# ---------------------------------------------------------------------
OBMC_MASKS = np.asarray(TABLES["obmc_masks"], np.int32)  # (64,)


@functools.lru_cache(maxsize=None)
def obmc_mask_table(device) -> torch.Tensor:
    """The OBMC blend masks as a contiguous int32 tensor on `device`, made
    once: obmc_blend_batch slices it, and ops/tools_cuda hands it to the
    kernel."""
    return torch.as_tensor(OBMC_MASKS, device=device).contiguous()


def obmc_blend_batch(plane, laps, ys, xs, lap_h: int, lap_w: int,
                     region: int, vert: bool):
    """Blend (B, lap_h, lap_w) lap predictions into the plane at (ys, xs).
    vert=True: left-neighbour laps, mask over the first 3*region/4
    columns (region == lap_w); else top-neighbour laps, mask over the
    first 3*region/4 rows (region == the blend area height, which may
    exceed lap_h). The whole batch is read before any of it is written;
    the laps of one batch are disjoint. Updates the plane IN PLACE and
    returns it."""
    n = (region * 3) >> 2
    m = torch.zeros(lap_w if vert else lap_h, dtype=torch.int32,
                    device=plane.device)
    m[:n] = obmc_mask_table(plane.device)[region:region + n]
    m = m.view(1, 1, lap_w) if vert else m.view(1, lap_h, 1)
    reg = gather_units(plane, ys, xs, lap_h, lap_w).to(torch.int32)
    out = (reg * (64 - m) + laps * m + 32) >> 6
    return scatter_units(plane, out, ys, xs, lap_h, lap_w)


def obmc_plane(plane, laps, ys, xs, region: int, vert: bool):
    """obmc_blend_batch of the (nL, lap_h, lap_w) int32 lap slot buffer
    `laps` at (ys, xs) (PAD_OOB pad laps write nothing). In place;
    returns the plane."""
    _, lap_h, lap_w = laps.shape
    return obmc_blend_batch(plane, laps, ys, xs, lap_h, lap_w, region,
                            vert)


# ---------------------------------------------------------------------
# the warp and OBMC work lists of a frame: the plain versions of
# csrc/warp.cu and csrc/obmc.cu (wrappers ops/tools_cuda.warp_run and
# obmc_run). A table (made by models/frame_exec.McRun) has WENTRY or
# OENTRY ints an entry; an entry's last field is the prefix sum of the
# units (warp) or blended pixels (OBMC) of the entries before it, which
# the kernels search for a unit's or pixel's entry.
# ---------------------------------------------------------------------
# a warp entry: a warp record's or "w" sub-op's real units, read from the
# descriptor buffers at their offsets (ys and xs, or base, int16 where a
# WF_*16 flag says; the rows always int32: their phases exceed int16),
# stored into plane W_PLANE (at ys, xs) or, with WF_SLOT, into the arena
# span [W_DST, W_DST + W_DSTN) at flat offsets W_YS (base) + y * W_ROWW
# + x; the reference stack is the plane's
WENTRY = 10
(W_FLAGS, W_PLANE, W_ROWS, W_YS, W_XS, W_DST, W_DSTN, W_ROWW, W_NREAL,
 W_START) = range(WENTRY)
WF_SLOT, WF_PREP, WF_YS16, WF_XS16 = 1, 2, 4, 8
# an OBMC entry: an obmc record's real laps, (O_NREAL, O_LH, O_LW) at
# arena offset O_LAPS, origins at O_YS / O_XS of the int32 buffer, each
# blended over its (O_ROWS, O_COLS) area (obmc_area)
OENTRY = 12
(O_PLANE, O_LAPS, O_LH, O_LW, O_REGION, O_VERT, O_YS, O_XS, O_NREAL, O_ROWS,
 O_COLS, O_START) = range(OENTRY)


def _fill(entries, width, fields):
    """The (len(entries), width) int64 table of the entries' fields
    ({column: key}; absent keys 0)."""
    tab = np.zeros((len(entries), width), np.int64)
    for i, e in enumerate(entries):
        for f, k in fields.items():
            tab[i, f] = e.get(k, 0)
    return tab


def _with_prefix(tab, count, start):
    """tab with column `start` the prefix sum of `count` (a column of
    counts a row), flattened to int32; and the total."""
    tab[:, start] = np.cumsum(count) - count
    total = int(count.sum())
    if total >= 1 << 31:
        raise ValueError(f"{total} work items do not fit int32")
    return tab.astype(np.int32).reshape(-1), total


def warp_build_table(entries):
    """The warp work list of a frame. entries: dicts of flags, plane,
    rows, ys, xs, dst, dstn, row_w, B, n_real (offsets in the descriptor
    buffers and the arena; absent fields 0). Returns (table, (entries,
    units)): WENTRY int32 an entry, W_START the units before it."""
    tab = _fill(entries, WENTRY, {
        W_FLAGS: "flags", W_PLANE: "plane", W_ROWS: "rows", W_YS: "ys",
        W_XS: "xs", W_DST: "dst", W_DSTN: "dstn", W_ROWW: "row_w",
        W_NREAL: "n_real"})
    B = np.asarray([e["B"] for e in entries], np.int64)
    n = tab[:, W_NREAL]
    if ((n < 0) | (n > B)).any():
        raise ValueError("warp: n_real outside [0, B]")
    table, units = _with_prefix(tab, n, W_START)
    return table, (len(entries), units)


def obmc_area(lap_h: int, lap_w: int, region: int, vert: bool):
    """(rows, columns) of a lap's blended area: the masked columns of a
    left lap, the masked rows (at most its own) of a top lap."""
    k = (region * 3) >> 2
    return (lap_h, min(k, lap_w)) if vert else (min(k, lap_h), lap_w)


def obmc_build_table(entries):
    """The OBMC work list of one phase of a frame. entries: dicts of
    plane, laps (arena offset), lh, lw, region, vert, ys, xs (int32
    buffer offsets), n_real. Returns (table, (entries, blended
    pixels)): OENTRY int32 an entry, O_START the pixels before it."""
    tab = _fill(entries, OENTRY, {
        O_PLANE: "plane", O_LAPS: "laps", O_LH: "lh", O_LW: "lw",
        O_REGION: "region", O_VERT: "vert", O_YS: "ys", O_XS: "xs",
        O_NREAL: "n_real"})
    for i, e in enumerate(entries):
        k = (e["region"] * 3) >> 2
        if e["region"] < 0 or e["region"] + k > len(OBMC_MASKS):
            raise ValueError(f"obmc: region {e['region']}")
        tab[i, O_ROWS:O_COLS + 1] = obmc_area(e["lh"], e["lw"], e["region"],
                                              e["vert"])
    table, px = _with_prefix(
        tab, tab[:, O_NREAL] * tab[:, O_ROWS] * tab[:, O_COLS], O_START)
    return table, (len(entries), px)


def table_rows(tab, n_entries: int, width: int):
    """The entries of a warp or OBMC table (a 1-D int32 tensor or array)
    as lists of `width` ints."""
    flat = np.asarray(tab.cpu() if isinstance(tab, torch.Tensor) else tab)
    return flat[:n_entries * width].reshape(n_entries, width).tolist()


def warp_run(tab, work, desc, desc16, planes, refs, arena, bitdepth: int):
    """A frame's warp work list, the plain version of the
    ``csrc/warp.cu`` kernel: one ``warp_plane`` or ``warp_slots`` an
    entry, on its real rows. tab, work: warp_build_table's; desc/desc16:
    the int32 and int16 buffers the offsets count from; planes: the
    destination planes, refs their reference stacks (entry plane i ->
    planes[i], refs[i]); arena: the frame's flat int32 slot arena (None
    without slot entries). Updates planes and arena in place."""
    for e in table_rows(tab, work[0], WENTRY):
        fl, n, pl = e[W_FLAGS], e[W_NREAL], e[W_PLANE]

        def sl(f, flag, k):
            src = desc16 if fl & flag else desc
            return src[e[f]:e[f] + k].to(torch.int32)
        rows = desc[e[W_ROWS]:e[W_ROWS] + 10 * n].view(n, 10)
        ys = sl(W_YS, WF_YS16, n)
        if fl & WF_SLOT:
            buf = arena[e[W_DST]:e[W_DST] + e[W_DSTN]].view(
                1, -1, e[W_ROWW])
            warp_slots(buf, refs[pl], rows, ys, bitdepth, bool(fl & WF_PREP))
        else:
            warp_plane(planes[pl], refs[pl], rows, ys,
                       sl(W_XS, WF_XS16, n), bitdepth)


def obmc_run(tab, work, desc, planes, arena):
    """One phase's OBMC work list, the plain version of the
    ``csrc/obmc.cu`` kernel: one ``obmc_plane`` an entry, on its real
    laps, in order. tab, work: obmc_build_table's; desc: the int32
    buffer of the origins; planes: the planes (entry plane i ->
    planes[i]); arena: the frame's flat int32 slot arena. Updates the
    planes in place."""
    for e in table_rows(tab, work[0], OENTRY):
        n, lh, lw = e[O_NREAL], e[O_LH], e[O_LW]
        laps = arena[e[O_LAPS]:e[O_LAPS] + n * lh * lw].view(n, lh, lw)
        obmc_plane(planes[e[O_PLANE]], laps, desc[e[O_YS]:e[O_YS] + n],
                   desc[e[O_XS]:e[O_XS] + n], e[O_REGION],
                   bool(e[O_VERT]))


# ---------------------------------------------------------------------
# the compound joins of a frame as one work list (models/frame_exec.McRun's
# comprun record): the plain version of csrc/comp.cu (wrapper
# ops/tools_cuda.comp_run). The table holds CENTRY ints an entry (a comp
# record), then CROW ints a row (a real slot, entry by entry); an entry's
# last field is the prefix sum of the work items (COMP_ITEM pixels of a
# slot's row each) of the entries before it, which the kernel searches for
# an item's entry.
# ---------------------------------------------------------------------
# a comp entry: a comp record's C_NREAL real (C_BH, C_BW) slots, its two
# sides' slot buffers at arena offsets C_S0 / C_S1, their origins at C_DY
# / C_DX of the int32 buffer, plane C_PLANE, the cell of its seg chroma
# mask (1 << C_CV rows, 1 << C_CH columns) and its first row C_FIRST
CENTRY = 12
(C_PLANE, C_BH, C_BW, C_CH, C_CV, C_S0, C_S1, C_DY, C_DX, C_NREAL, C_FIRST,
 C_START) = range(CENTRY)
COMP_ITEM = 4     # the pixels of a work item (csrc/comp.cu CP_ITEM)
# a slot row: McRun.comp_table's (kind, par, moff), where the moff of a
# CJ_SEGC row is the frame row of the CJ_SEGL slot whose chroma mask it
# reads; such a row also holds that luma slot's sides (arena offsets R_L0
# / R_L1), shape (R_LH, R_LW) and sign R_LSGN, from which the kernel
# derives the mask again
CROW = 8
(R_KIND, R_PAR, R_MOFF, R_L0, R_L1, R_LH, R_LW, R_LSGN) = range(CROW)


def comp_build_table(entries):
    """The compound joins of a frame as one work list. entries: dicts of
    plane, bhp, bwp, ch, cv, s0, s1 (arena offsets of the two (N, bhp,
    bwp) side slot buffers), dy, dx (int32 buffer offsets) and rows, the
    (n, CJ_COLS) table of the record's n real slots (a CJ_SEGC row's
    moff: the frame row of a CJ_SEGL row of the same mask cell, whose
    chroma mask covers the slot). A work item is COMP_ITEM pixels of a
    slot's row, so every slot width is a multiple of COMP_ITEM (a
    compound block is 8x8 luma or larger). Returns (table, (entries,
    rows, work items))."""
    tab = _fill(entries, CENTRY, {
        C_PLANE: "plane", C_BH: "bhp", C_BW: "bwp", C_CH: "ch", C_CV: "cv",
        C_S0: "s0", C_S1: "s1", C_DY: "dy", C_DX: "dx"})
    rows = [np.asarray(e["rows"], np.int64).reshape(-1, CJ_COLS)
            for e in entries]
    n = np.asarray([len(r) for r in rows], np.int64)
    if ((tab[:, C_BH] >> tab[:, C_CV] <= 0) |
            (tab[:, C_BW] >> tab[:, C_CH] <= 0) |
            (tab[:, C_BW] % COMP_ITEM != 0)).any():
        raise ValueError(f"comp: a slot smaller than its mask cell, or of "
                         f"a width not a multiple of {COMP_ITEM}")
    tab[:, C_NREAL] = n
    tab[:, C_FIRST] = np.cumsum(n) - n
    rt = np.zeros((int(n.sum()), CROW), np.int64)
    if len(rt):
        rt[:, :CJ_COLS] = np.concatenate(rows)
    ent = np.repeat(np.arange(len(entries)), n)
    for g in np.flatnonzero(rt[:, R_KIND] == CJ_SEGC):
        lg = rt[g, R_MOFF]
        if not 0 <= lg < len(rt) or rt[lg, R_KIND] != CJ_SEGL:
            raise ValueError(f"comp: seg chroma row {g} names row {lg}, "
                             f"not a seg luma row")
        le, ce = tab[ent[lg]], tab[ent[g]]
        if (le[C_CH], le[C_CV]) != (ce[C_CH], ce[C_CV]) or \
                ce[C_BH] * ce[C_BW] > (le[C_BH] >> le[C_CV]) * (
                    le[C_BW] >> le[C_CH]):
            raise ValueError(f"comp: seg chroma row {g} outside the mask "
                             f"of row {lg}")
        off = (lg - le[C_FIRST]) * le[C_BH] * le[C_BW]
        rt[g, R_L0:] = (le[C_S0] + off, le[C_S1] + off, le[C_BH], le[C_BW],
                        rt[lg, R_PAR])
    if len(rt) and (rt.min() < -(1 << 31) or rt.max() >= 1 << 31):
        raise ValueError("comp: a row value does not fit int32")
    table, items = _with_prefix(
        tab, n * tab[:, C_BH] * tab[:, C_BW] // COMP_ITEM, C_START)
    return (np.concatenate([table, rt.astype(np.int32).reshape(-1)]),
            (len(entries), len(rt), items))


def comp_table_parts(tab, work):
    """(entries (E, CENTRY), rows (R, CROW)) int64 arrays of a comp work
    list's table (a 1-D int32 tensor or array)."""
    n_e, n_r = work[:2]
    flat = np.asarray(tab.cpu() if isinstance(tab, torch.Tensor) else tab,
                      np.int64)
    return (flat[:n_e * CENTRY].reshape(n_e, CENTRY),
            flat[n_e * CENTRY:n_e * CENTRY + n_r * CROW].reshape(n_r, CROW))


def comp_run(tab, work, desc, planes, arena, bitdepth: int):
    """A frame's compound joins, the plain version of the ``csrc/comp.cu``
    kernel: one ``comp_record`` an entry, on its real slots, in order.
    Its seg-mask arena has a span a seg row: a seg chroma row's holds
    its luma slot's chroma mask, derived from that slot's sides
    (w_mask_batch), as the kernel derives it; a seg luma row's takes the
    mask it writes. tab, work: comp_build_table's; desc: the int32
    buffer of the origins and wedge masks; planes: the planes (entry
    plane i -> planes[i]); arena: the frame's flat int32 slot arena.
    Updates the planes in place."""
    ents, rows = comp_table_parts(tab, work)
    ent = np.repeat(np.arange(len(ents)), ents[:, C_NREAL])
    dev = desc.device
    kind = rows[:, R_KIND]
    moff = rows[:, R_MOFF].copy()
    spans, at = [], 0
    segc = np.flatnonzero(kind == CJ_SEGC)
    # the seg chroma rows' masks, a w_mask_batch for the rows of one luma
    # shape and mask cell
    key = np.stack([rows[segc, R_LH], rows[segc, R_LW], ents[ent[segc], C_CH],
                    ents[ent[segc], C_CV]], 1)
    for lh, lw, ch, cv in np.unique(key, axis=0).tolist():
        g = segc[(key == (lh, lw, ch, cv)).all(1)]
        luma = [arena[_flat_index(torch.from_numpy(rows[g, f]).to(dev),
                                  lh * lw)].view(-1, lh, lw)
                for f in (R_L0, R_L1)]
        cm = w_mask_batch(*luma, torch.from_numpy(rows[g, R_LSGN]).to(
            device=dev, dtype=torch.int32), ch, cv, bitdepth)[1]
        moff[g] = at + np.arange(len(g)) * cm[0].numel()
        at += cm.numel()
        spans.append(cm.reshape(-1))
    # a span for each seg luma row's mask, which no row reads here
    segl = np.flatnonzero(kind == CJ_SEGL)
    le = ents[ent[segl]]
    size = (le[:, C_BH] >> le[:, C_CV]) * (le[:, C_BW] >> le[:, C_CH])
    moff[segl] = at + np.cumsum(size) - size
    spans.append(torch.zeros(int(size.sum()), dtype=torch.int32, device=dev))
    masks = torch.cat(spans)
    t = torch.from_numpy(np.stack([rows[:, R_KIND], rows[:, R_PAR], moff],
                                  1).astype(np.int32)).to(dev)
    for e in ents.tolist():
        n, f, bh, bw = e[C_NREAL], e[C_FIRST], e[C_BH], e[C_BW]
        if not n:
            continue
        s0, s1 = (arena[o:o + n * bh * bw].view(n, bh, bw)
                  for o in (e[C_S0], e[C_S1]))
        comp_record(planes[e[C_PLANE]], s0, s1, t[f:f + n],
                    desc[e[C_DY]:e[C_DY] + n], desc[e[C_DX]:e[C_DX] + n],
                    masks, desc, e[C_CH], e[C_CV], bitdepth)


# ---------------------------------------------------------------------
# scaled-reference MC (dav1d mc_tmpl.c put/prep_8tap_scaled:172/287):
# per-pixel source stepping as closed-form index/phase arrays
# (xoff(x) = (posx_frac + x*dx) >> 10, ...) over a clamped window gather
# ---------------------------------------------------------------------
def _scaled_taps(src, off, axis, n_src):
    """The 8 taps of each output position: (8 tensors) of src gathered
    along `axis` (1 = rows, 2 = columns) at off + k, k = 0..7, clamped
    into [0, n_src - 1] as the reference's gather clamps them. off:
    (B, n) int32."""
    B = src.shape[0]
    ar8 = torch.arange(8, device=src.device, dtype=off.dtype)
    ids = (off[:, :, None] + ar8).clamp(0, n_src - 1).long()   # (B, n, 8)
    out = []
    for k in range(8):
        if axis == 2:
            idx = ids[:, None, :, k].expand(B, src.shape[1], off.shape[1])
        else:
            idx = ids[:, :, None, k].expand(B, off.shape[1], src.shape[2])
        out.append(torch.gather(src, axis, idx))
    return out


def mc_scaled_batch(ref_stack, args, uw: int, uh: int, win_w: int,
                    win_h: int, bitdepth: int, prep: bool):
    """args: (B, 9) [ref, top, left, mxf, myf, dx, dy, f2d, pad]; the
    window of (win_h, win_w) is gathered at (top-3, left-3), clamped into
    the reference; mxf/myf = pos & 0x3FF. Returns (B, uh, uw) int32:
    pixels (put) or prep tmp."""
    dev = ref_stack.device
    ref_idx = args[:, 0].long()
    top, left = args[:, 1], args[:, 2]
    mxf, myf = args[:, 3], args[:, 4]
    dx, dy = args[:, 5], args[:, 6]
    f2d = args[:, 7].long()
    H, W = ref_stack.shape[1], ref_stack.shape[2]
    ib = ibits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    irnd = (1 << ib) >> 1
    bd_max = (1 << bitdepth) - 1

    ar_h = torch.arange(win_h, device=dev, dtype=torch.int32)
    ar_w = torch.arange(win_w, device=dev, dtype=torch.int32)
    ys = (top[:, None] - 3 + ar_h[None, :]).clamp(0, H - 1).long()
    xs = (left[:, None] - 3 + ar_w[None, :]).clamp(0, W - 1).long()
    win = ref_stack[ref_idx[:, None, None], ys[:, :, None],
                    xs[:, None, :]].to(torch.int32)

    f2d_tab = _f2d_table(dev)
    th, tv = f2d_tab[f2d, 0], f2d_tab[f2d, 1]

    # ---- horizontal pass: mid (B, win_h, uw) ----
    x = torch.arange(uw, device=dev, dtype=torch.int32)[None, :]
    phx = mxf[:, None] + x * dx[:, None]                  # (B, uw)
    subx = (phx & 0x3FF) >> 6
    fh = _filters_for(th[:, None].expand(-1, uw), subx.clamp(min=1),
                      uw <= 4)                            # (B, uw, 8)
    taps = _scaled_taps(win, phx >> 10, 2, win_w)
    filt = taps[0] * fh[:, None, :, 0]
    for k in range(1, 8):
        filt = filt + taps[k] * fh[:, None, :, k]
    filt = (filt + ((1 << (6 - ib)) >> 1)) >> (6 - ib)
    mid = torch.where((subx == 0)[:, None, :], taps[3] << ib, filt)

    # ---- vertical pass ----
    y = torch.arange(uh, device=dev, dtype=torch.int32)[None, :]
    phy = myf[:, None] + y * dy[:, None]                  # (B, uh)
    suby = (phy & 0x3FF) >> 6
    fv = _filters_for(tv[:, None].expand(-1, uh), suby.clamp(min=1),
                      uh <= 4)                            # (B, uh, 8)
    tapsv = _scaled_taps(mid, phy >> 10, 1, win_h)
    vfilt = tapsv[0] * fv[:, :, None, 0]
    for k in range(1, 8):
        vfilt = vfilt + tapsv[k] * fv[:, :, None, k]
    vcopy = tapsv[3]
    copy_row = (suby == 0)[:, :, None]
    if prep:
        return torch.where(copy_row, vcopy - bias,
                           ((vfilt + 32) >> 6) - bias)
    return torch.where(
        copy_row, ((vcopy + irnd) >> ib).clamp(0, bd_max),
        ((vfilt + ((1 << (6 + ib)) >> 1)) >> (6 + ib)).clamp(0, bd_max))


def mc_scaled_plane(plane, ref_stack, rows, ys, xs, uw: int, uh: int,
                    bitdepth: int, prep: bool = False):
    """mc_scaled_batch on the (B, 9) rows (windows of (2uh+10, 2uw+10))
    written into `plane` at (ys, xs) by scatter_units. In place; returns
    the plane."""
    out = mc_scaled_batch(ref_stack, rows, uw, uh, 2 * uw + 10,
                          2 * uh + 10, bitdepth, prep)
    return scatter_units(plane, out, ys, xs, uh, uw)


def mc_scaled_slots(buf, ref_stack, rows, base, uw: int, uh: int,
                    bitdepth: int, prep: bool):
    """mc_scaled_batch written at the flat offsets `base` of the
    (N, bhp, bwp) slot buffer `buf` by scatter_slot_units. In place;
    returns buf."""
    out = mc_scaled_batch(ref_stack, rows, uw, uh, 2 * uw + 10,
                          2 * uh + 10, bitdepth, prep)
    return scatter_slot_units(buf, base, out, uh, uw, buf.shape[2])


# ---------------------------------------------------------------------
# the unit MC work lists: the table of csrc/mc_units.cu and
# csrc/mc_scaled.cu, and their plain versions. One entry a bucket (a put
# or scaled record, or a "t" or "s" sub-op of a compound side or an OBMC
# lap); its units are read from the frame's descriptor buffers in place.
# ---------------------------------------------------------------------
# the int32 fields of an entry: unit width and height, flags, reference
# (mc_units: the plane's reference stack; mc_scaled: the srefspec view),
# destination plane, rows B (pad rows included) and real rows (the first
# n_real), offsets of the descriptor rows, of ys (a plane's rows, a
# slot, or an "s" unit's flat base) and of xs, the slot buffer's offset
# in the arena and its elements, its row width ("s"), units an item, the
# entry's first item, and (mc_scaled) its real rows' largest steps,
# dx | dy << 12, 0 if not known (64 bytes an entry)
(M_UW, M_UH, M_FLAGS, M_REF, M_PLANE, M_B, M_NREAL, M_DESC, M_YS, M_XS,
 M_DST, M_DSTN, M_ROWW, M_G, M_ITEM0, M_STEPS) = range(16)
MENTRY = 16
# M_FLAGS bits: H pass, V pass, prep, the arena as destination, rows, ys
# and xs in the int16 buffer (else the int32 one)
MF_H, MF_V, MF_PREP, MF_ARENA, MF_DESC16, MF_YS16, MF_XS16 = (
    1, 2, 4, 8, 16, 32, 64)
# the geometry both kernels share (csrc/mc_units.cu MU_*, mc_scaled.cu
# MS_*): tiles of at most MC_TILE x MC_TILE outputs, at most MC_MAX_G
# units and MC_MAX_OUT outputs an item, a unit's side at most MC_MAX_SIDE
# (16 tiles), and the windows of one item in at most MC_STAGE_INTS ints
# of shared memory unless one unit's tile needs more
MC_TILE, MC_MAX_G, MC_MAX_OUT, MC_MAX_SIDE, MC_STAGE_INTS = (
    32, 64, 2048, 128, 6144)


def mc_steps(rows):
    """The M_STEPS field of scaled rows (B, 9): their largest steps,
    dx | dy << 12 (AV1 keeps both in 1..2048)."""
    if not len(rows):
        return 0
    dx, dy = int(rows[:, 5].max()), int(rows[:, 6].max())
    if not (0 < dx < 4096 and 0 < dy < 4096):
        return 0
    return dx | dy << 12


def _reach(n, step):
    """Region rows (columns) that n outputs' phases reach at `step`: from
    the first phase's to the last phase's eighth tap; 2 n + 8 at most,
    and for a step not known (0) (csrc/mc_scaled.cu reach)."""
    if not step:
        return 2 * n + 8
    return min(2 * n + 8, ((n - 1) * step + 1023 >> 10) + 8)


def mc_geometry(scaled: bool, uw: int, uh: int, has_h=True, has_v=True,
                steps=0):
    """(tiles, units an item G, window ints a unit, mid ints a unit) of a
    bucket of (uw, uh) units. A tile's window: mc_units (th + 7) x (tw +
    7) with H and V (no apron on an axis without its pass), mid
    (th + 7) x tw with both; mc_scaled the reference region its phases
    reach at the entry's largest steps (M_STEPS), (2 th + 8) x (2 tw + 8)
    under AV1's steps when they are not known, mid as many rows of tw."""
    if not (1 <= uw <= MC_MAX_SIDE and 1 <= uh <= MC_MAX_SIDE):
        raise ValueError(f"unit {uw}x{uh}: sides 1..{MC_MAX_SIDE}")
    tw, th = min(uw, MC_TILE), min(uh, MC_TILE)
    tiles = -(-uw // tw) * -(-uh // th)
    if scaled:
        mr = _reach(th, steps >> 12)
        win, mid = mr * _reach(tw, steps & 4095), mr * tw
    else:
        wh, ww = th + 7 * bool(has_v), tw + 7 * bool(has_h)
        win, mid = wh * ww, wh * tw if has_h and has_v else 0
    g = min(MC_MAX_G, max(1, MC_MAX_OUT // (tw * th)),
            max(1, MC_STAGE_INTS // win))
    return tiles, g, win, mid


def mc_build_table(scaled: bool, entries):
    """The work list of one run. entries: dicts of uw, uh, flags, ref,
    plane, B, n_real, desc, ys, xs, dst, dstn, row_w, steps (offsets in
    the descriptor buffers and the arena; absent fields 0). Returns (table,
    work): the int32 table (MENTRY ints an entry, then two an item:
    entry * 16 + tile, first unit), the items of each entry together,
    the largest items first (mc_item_order); work = (entries, items,
    window ints of a shared-memory stage, mid ints), the last two the
    largest of the run's items."""
    tab = np.zeros((len(entries), MENTRY), np.int32)
    geo = []
    for i, e in enumerate(entries):
        fl = e["flags"]
        geo.append(mc_geometry(scaled, e["uw"], e["uh"], fl & MF_H,
                               fl & MF_V, e.get("steps", 0)))
        for f, k in ((M_UW, "uw"), (M_UH, "uh"), (M_FLAGS, "flags"),
                     (M_REF, "ref"), (M_PLANE, "plane"), (M_B, "B"),
                     (M_NREAL, "n_real"), (M_DESC, "desc"), (M_YS, "ys"),
                     (M_XS, "xs"), (M_DST, "dst"), (M_DSTN, "dstn"),
                     (M_ROWW, "row_w"), (M_STEPS, "steps")):
            tab[i, f] = e.get(k, 0)
        if not 0 <= e["n_real"] <= e["B"]:
            raise ValueError(f"entry {i}: n_real {e['n_real']} of B "
                             f"{e['B']}")
        tab[i, M_G] = geo[-1][1]
    order = sorted(range(len(entries)), key=lambda i: (
        mc_item_order(entries[i], geo[i][1]), i))
    items = []
    stage = mid = 0
    for i in order:
        tiles, g, win, m = geo[i]
        n = entries[i]["n_real"]
        tab[i, M_ITEM0] = len(items) // 2
        for u0 in range(0, n, g):
            items.extend(x for t in range(tiles) for x in (i * 16 + t, u0))
        if n:
            stage = max(stage, min(g, n) * win)
            mid = max(mid, min(g, n) * m)
    table = np.concatenate([tab.reshape(-1), np.asarray(items, np.int32)])
    return table, (len(entries), len(items) // 2, stage, mid)


def mc_item_order(e, g) -> tuple:
    """Sort key of an entry's items in the map: the most outputs times
    passes an item first, so that they start in the kernel's first
    wave."""
    fl = e["flags"]
    out = min(e["uw"], MC_TILE) * min(e["uh"], MC_TILE) * min(
        g, max(e["n_real"], 1))
    return (-out * (1 + bool(fl & MF_H) + bool(fl & MF_V)),)


def mc_table_entries(tab, n_entries: int):
    """The entries of a table (a 1-D int32 tensor or array) as lists of
    MENTRY ints."""
    flat = np.asarray(tab.cpu() if isinstance(tab, torch.Tensor) else tab)
    return flat[:n_entries * MENTRY].reshape(n_entries, MENTRY).tolist()


def _run_slices(e, desc, desc16):
    """sl(field, flag, n): the entry's n descriptor values at `field`,
    from the int16 buffer when its flag is set."""
    def sl(f, flag, n):
        src = desc16 if e[M_FLAGS] & flag else desc
        return src[e[f]:e[f] + n]
    return sl


def mc_units_run(tab, work, desc, desc16, planes, refs, arena,
                 bitdepth: int):
    """A work list of translational unit MC buckets, the plain version
    of the ``csrc/mc_units.cu`` kernel: one ``mc_units_plane`` or
    ``mc_units_slots`` per table entry, on its real rows. tab: the run's
    int32 table (mc_build_table); work: its mc_build_table counts;
    desc/desc16: the int32 and int16 buffers its offsets count from;
    planes: the destination planes (entry plane i -> planes[i]); refs:
    the reference stacks (entry ref i -> refs[i]); arena: the frame's
    flat int32 slot arena. Updates planes and arena in place."""
    for e in mc_table_entries(tab, work[0]):
        uw, uh, fl, n, B = (e[M_UW], e[M_UH], e[M_FLAGS], e[M_NREAL],
                            e[M_B])
        sl = _run_slices(e, desc, desc16)
        arr = sl(M_DESC, MF_DESC16, 6 * B).view(B, 6)[:n]
        ys = sl(M_YS, MF_YS16, B)[:n]
        hh, hv, prep = bool(fl & MF_H), bool(fl & MF_V), bool(fl & MF_PREP)
        if fl & MF_ARENA:
            buf = arena[e[M_DST]:e[M_DST] + e[M_DSTN]].view(-1, uh, uw)
            mc_units_slots(buf, refs[e[M_REF]], arr, ys, hh, hv, bitdepth,
                           prep)
        else:
            mc_units_plane(planes[e[M_PLANE]], refs[e[M_REF]], arr, ys,
                           sl(M_XS, MF_XS16, B)[:n], uw, uh, hh, hv,
                           bitdepth, prep)


def mc_scaled_run(tab, work, desc, planes, srefs, arena, bitdepth: int):
    """A work list of scaled unit MC buckets, the plain version of the
    ``csrc/mc_scaled.cu`` kernel: one ``mc_scaled_plane`` or
    ``mc_scaled_slots`` per table entry, on its real rows. srefs: the
    frame's scaled reference views (entry ref i -> srefs[i]); rows, ys
    and xs (or the flat bases) in the int32 buffer `desc`; the rest as
    in mc_units_run."""
    for e in mc_table_entries(tab, work[0]):
        uw, uh, fl, n, B = (e[M_UW], e[M_UH], e[M_FLAGS], e[M_NREAL],
                            e[M_B])
        sl = _run_slices(e, desc, desc)
        rows = sl(M_DESC, 0, 9 * B).view(B, 9)[:n]
        ys = sl(M_YS, 0, B)[:n]
        prep = bool(fl & MF_PREP)
        if fl & MF_ARENA:
            buf = arena[e[M_DST]:e[M_DST] + e[M_DSTN]].view(1, -1, e[M_ROWW])
            mc_scaled_slots(buf, srefs[e[M_REF]], rows, ys, uw, uh, bitdepth,
                            prep)
        else:
            mc_scaled_plane(planes[e[M_PLANE]], srefs[e[M_REF]], rows, ys,
                            sl(M_XS, 0, B)[:n], uw, uh, bitdepth, prep)


# ---------------------------------------------------------------------
# horizontal super-res resample (dav1d src/mc_tmpl.c resize:877). step
# and mx0 are frame constants: the source columns and filter rows of each
# output column are computed once on the host; the device runs one gather
# and an 8-tap contraction.
# ---------------------------------------------------------------------
RESIZE_FILTER = np.asarray(TABLES["resize_filter"], np.int32)  # (64, 8)


@functools.lru_cache(maxsize=64)
def _resize_taps(out_w: int, src_w: int, step: int, mx0: int, device):
    """(source columns (out_w * 8,) int64, filter rows (out_w, 8) int32)
    on `device`."""
    xs = np.arange(out_w, dtype=np.int64)
    phase = mx0 + xs * step
    src_x = -1 + (phase >> 14)
    fidx = (phase & 0x3FFF) >> 8
    idx = np.clip(src_x[:, None] + np.arange(-3, 5)[None, :], 0, src_w - 1)
    return (torch.from_numpy(idx.reshape(-1)).to(device),
            torch.from_numpy(RESIZE_FILTER[fidx]).to(device))


def resize_plane(src, out_w: int, src_w: int, step: int, mx0: int,
                 bitdepth: int):
    """src: (h, >= src_w) int32. Returns (h, out_w) int32 pixels."""
    idx, f = _resize_taps(out_w, src_w, step, mx0, src.device)
    g = src.index_select(1, idx).view(src.shape[0], out_w, 8)
    acc = (g * f[None]).sum(dim=2, dtype=torch.int32)
    return ((-acc + 64) >> 7).clamp(0, (1 << bitdepth) - 1)
