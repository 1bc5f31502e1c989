"""Device inter-frame reconstruction: plan, pack, execute.

Port of ``dav1d_mirror_tpu/models/tpu_inter.py`` (``build_frame_program``
:443 with its helpers, and ``execute_frame_program`` :1319). The host
entropy pass has produced per-block modes/MVs and dequantized
coefficients; the planner (numpy, copied) turns them into one packed
frame program (models/frame_exec), which runs on the device:

  * translational MC as fixed-size unit batches over stacked reference
    planes (ops/mc, ops/mc_cuda),
  * MC from a reference of another size than the frame (a super-res
    frame reads every reference so) as scaled unit batches over a view
    of that reference (ops/mc.mc_scaled_batch),
  * affine warp (local and global motion) as 8x8 unit batches,
  * compound blocks as whole-block prep batches per side, joined by
    average, distance weights, wedge or difference-weighted (seg) masks,
  * OBMC laps from the neighbours' motion, blended top then left,
  * residual inverse transforms bucketed by tx size with scatter-add
    (ops/itx), lossless WHT in buckets of their own.

Intra blocks (sequential neighbour dependency) run on the host
afterwards, in decode order, in the native walk (native/recon.cpp) —
valid because inter prediction never reads current-frame pixels. So do
the intra halves of inter-intra blocks: their inter prediction is put on
the device, the native walk blends it with the intra prediction
(dd == 2 in ``BuiltFrame.dd_per``).

The planner always runs the vectorized path (models/plan_vec), which the
native entropy walk always feeds, and packs without the reference's
ProgramSchema: every batch is padded to a power of two on its own.
"""
from __future__ import annotations

import numpy as np

from ..host.tilecoder import (COMP_INTER_AVG, COMP_INTER_SEG,
                              COMP_INTER_WEDGE, COMP_INTER_WEIGHTED_AVG,
                              T_BLOCK_DIM)
from ..ops.mc import PAD_OOB
from .frame_buffers import _gmv_warp_params


def _p2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def _pad_rows(arr: np.ndarray, ycol: int | None, P: int | None = None):
    """Pad (B, ...) int32 array to pow2 (or P) rows (dup of last row);
    mark the pad rows' scatter origin column OOB when ycol is given."""
    b = arr.shape[0]
    p = P if P is not None else _p2(b)
    if p == b:
        return arr
    pad = np.repeat(arr[-1:], p - b, axis=0)
    if ycol is not None:
        pad[:, ycol] = PAD_OOB
    return np.concatenate([arr, pad], axis=0)


def _pad_vec(vec: np.ndarray, oob: bool, P: int | None = None):
    """Pad a (B,) vector to pow2 (or P) (dup last, or PAD_OOB)."""
    b = vec.shape[0]
    p = P if P is not None else _p2(b)
    if p == b:
        return vec
    fill = np.full(p - b, PAD_OOB if oob else vec[-1], vec.dtype)
    return np.concatenate([vec, fill])


def _block_device_class(fhdr, coder, b, refs, cur_w, cur_h):
    """'single' / 'comp' if the batched device path covers this block's
    motion-compensated prediction, else None (host work: intra, and
    intrabc, which reads the current frame's decoded pixels)."""
    if b.intra:
        return None
    if fhdr.frame_type in (0, 2):  # intrabc
        return None
    for i in range(2 if b.comp_type else 1):
        rb = refs[fhdr.refidx[b.ref[i]]]
        if rb is None:
            return None
    return "comp" if b.comp_type else "single"


def _scale_fac(ref_sz, this_sz):
    return ((ref_sz << 14) + (this_sz >> 1)) // this_sz


def _scale_mv(val, scale):
    tmp = val * scale + (scale - 0x4000) * 8
    v = (abs(tmp) + 128) >> 8
    return (-v if tmp < 0 else v) + 32


def _ctrunc_div(a, b):
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _resize_params(in_w, out_w):
    """dav1d decode.c scale_fac:3517 + get_upscale_x0:3365 (C truncating
    division semantics). Copied from dav1d_mirror_tpu/models/
    ref_decoder.py."""
    step = ((in_w << 14) + (out_w >> 1)) // out_w
    err = out_w * step - (in_w << 14)
    x0 = _ctrunc_div(-((out_w - in_w) << 13) + (out_w >> 1), out_w) + \
        128 - _ctrunc_div(err, 2)
    return step, x0 & 0x3FFF


def _units_for_block_raw(plan, pl, ss_hor, ss_ver, b_dims, bx, by, mv,
                         ref_i, f2d, dst=None, whole=False):
    """Decompose one plane region into fixed-size translational MC units
    (dav1d recon_tmpl.c mc:957 geometry). b_dims/bx/by are the
    ALREADY-ALIGNED block dims/pos in (luma-scaled) 4px units; dst
    overrides the destination pixel position (sub-8x8 chroma places
    neighbour predictions at the current block)."""
    bw4, bh4 = b_dims
    if pl == 0:
        ss_hor = ss_ver = 0
    h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
    pw, ph = bw4 * h_mul, bh4 * v_mul
    mvy, mvx = mv
    mx = (mvx & (15 >> (0 if ss_hor else 1))) << (0 if ss_hor else 1)
    my = (mvy & (15 >> (0 if ss_ver else 1))) << (0 if ss_ver else 1)
    sx = bx * h_mul + (mvx >> (3 + ss_hor))
    sy = by * v_mul + (mvy >> (3 + ss_ver))
    dst_y, dst_x = dst if dst is not None else (by * v_mul, bx * h_mul)
    has_h, has_v = mx != 0, my != 0
    uw, uh = (pw, ph) if whole else (min(pw, 8), min(ph, 8))
    key = (uw, uh, has_h, has_v)
    lst = plan.setdefault(key, [])
    for oy in range(0, ph, uh):
        for ox in range(0, pw, uw):
            lst.append((ref_i,
                        sy + oy - (3 if has_v else 0),
                        sx + ox - (3 if has_h else 0),
                        mx, my, f2d, dst_y + oy, dst_x + ox))


def _warp_rows(ss_hor, ss_ver, wm, bx, by, bw4, bh4, ref_slot):
    """8x8 warp sub-unit descriptor rows (dav1d recon_tmpl.c
    warp_affine:1134 loop). Returns [(row10, sub_y, sub_x)] with sub
    offsets in plane pixels."""
    h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
    mat = wm.matrix
    out = []
    for y in range(0, bh4 * v_mul, 8):
        src_y = by * 4 + ((y + 4) << ss_ver)
        mat3_y = mat[3] * src_y + mat[0]
        mat5_y = mat[5] * src_y + mat[1]
        for x in range(0, bw4 * h_mul, 8):
            src_x = bx * 4 + ((x + 4) << ss_hor)
            mvx = (mat[2] * src_x + mat3_y) >> ss_hor
            mvy = (mat[4] * src_x + mat5_y) >> ss_ver
            dx = (mvx >> 16) - 4
            mx = ((mvx & 0xFFFF) - wm.alpha * 4 - wm.beta * 7) & ~0x3F
            dy = (mvy >> 16) - 4
            my = ((mvy & 0xFFFF) - wm.gamma * 4 - wm.delta * 4) & ~0x3F
            out.append(((ref_slot, dy - 3, dx - 3, mx, my, wm.alpha,
                         wm.beta, wm.gamma, wm.delta, 0), y, x))
    return out


def _scaled_pos(ss_hor, ss_ver, bx, by, mv, scale):
    h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
    mvy, mvx = mv
    orig_x = (bx * h_mul << 4) + mvx * (1 << (0 if ss_hor else 1))
    orig_y = (by * v_mul << 4) + mvy * (1 << (0 if ss_ver else 1))
    return _scale_mv(orig_x, scale[0]), _scale_mv(orig_y, scale[1])


def _scaled_rows(ss_hor, ss_ver, b_dims, bx, by, mv, f2d, ref_slot,
                 scale, step, split=True):
    """Scaled-MC sub-unit rows (dav1d recon_tmpl.c mc:1010-1037); pos
    recomputed per sub-unit via the closed-form per-pixel stepping.
    Returns [(row9, uw, uh, sub_y, sub_x)]."""
    bw4, bh4 = b_dims
    h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
    pw, ph = bw4 * h_mul, bh4 * v_mul
    pos_x, pos_y = _scaled_pos(ss_hor, ss_ver, bx, by, mv, scale)
    su = 8 if split else max(pw, ph)
    out = []
    for oy in range(0, ph, su):
        uh = min(su, ph - oy)
        py = pos_y + oy * step[1]
        for ox in range(0, pw, su):
            uw = min(su, pw - ox)
            px = pos_x + ox * step[0]
            out.append(((ref_slot, py >> 10, px >> 10, px & 0x3FF,
                         py & 0x3FF, step[0], step[1], f2d, 0),
                        uw, uh, oy, ox))
    return out


class _FramePlan:
    """All device MC work for one frame, bucketed for batching."""

    def __init__(self, n_planes):
        self.put = [dict() for _ in range(n_planes)]       # translational
        self.warp_put = [[] for _ in range(n_planes)]      # (row, y, x)
        # scaled references: bucket (uw, uh, ref) -> [(row9, y, x)]
        self.scaled_put = [dict() for _ in range(n_planes)]
        # OBMC laps, applied after all puts: phase 0 = top, 1 = left;
        # bucket (phase, lap_h, lap_w, region_dim); entries
        # (kind, row, (dst_y, dst_x))
        self.laps = [dict() for _ in range(n_planes)]
        # compound: bucket (bw_px, bh_px) -> list of block entry dicts
        self.comp = [dict() for _ in range(n_planes)]
        # vector-planned translational puts (models/plan_vec): per-plane
        # {(uw, uh, hh, hv): (B, 8) int32}; merged with self.put at pack
        self.put_vec = [dict() for _ in range(n_planes)]


def _vec_plan(fhdr, coders, refs, plan, n_planes, ss_hor, ss_ver,
              cur_w, cur_h):
    """Vectorized bulk planning (models/plan_vec): plans every plain
    translational put as numpy array programs, precomputes the decode-
    order filter state, and returns the per-coder special-block indices
    the per-block loop still has to visit (warp / scaled / OBMC laps /
    sub-8x8 chroma / compound)."""
    from . import plan_vec as pv
    ref_ok = np.zeros(7, bool)
    ref_scaled = np.zeros(7, bool)
    gm_warp = np.zeros(7, bool)
    for i in range(7):
        rb = refs[fhdr.refidx[i]]
        ref_ok[i] = rb is not None
        if rb is not None:
            ref_scaled[i] = rb.width != cur_w or rb.height != cur_h
        gm_warp[i] = _gmv_warp_params(fhdr, i,
                                      bool(ref_scaled[i])) is not None
    rf = coders[0].rf
    blk_all, _, _ = pv.blocks_meta(coders)
    tl_all = pv.f2d_products(blk_all)
    f2d_map = pv.paint_f2d_map(blk_all, coders[0].bw, coders[0].bh)

    special, dd_per, tl_per = [], [], []
    off = 0
    for ci, coder in enumerate(coders):
        blk = coder.native_arrays[0]
        nb = blk.shape[0]
        cl = pv.classify(blk, ref_ok, gm_warp, ref_scaled)
        bw4, bh4 = cl["bw4"], cl["bh4"]
        bx, by = blk[:, pv.B_BX], blk[:, pv.B_BY]
        has_chroma = np.zeros(nb, bool) if n_planes == 1 else (
            ((bw4 > ss_hor) | (bx & 1).astype(bool)) &
            ((bh4 > ss_ver) | (by & 1).astype(bool)))
        sub8 = _sub8x8_refined_vec(blk, bw4, bh4, ss_hor, ss_ver,
                                   has_chroma, rf)
        luma_vec = cl["single"] & ~cl["use_warp"] & ~cl["scaled0"]
        chroma_vec = luma_vec & has_chroma & ~sub8
        vp = pv.plan_translational(blk, ss_hor, ss_ver, n_planes,
                                   luma_vec, chroma_vec)
        for pl in range(n_planes):
            for k, arr in vp[pl].items():
                prev = plan.put_vec[pl].get(k)
                plan.put_vec[pl][k] = (arr if prev is None else
                                       np.concatenate([prev, arr]))
        dd = np.zeros(nb, np.uint8)
        dd[cl["covered"]] = 1
        dd[cl["ii"]] = 2
        dd_per.append(dd)
        sp = cl["comp"] | (cl["single"] &
                           (cl["use_warp"] | cl["scaled0"] |
                            (blk[:, pv.B_MOTION_MODE] == 1) |
                            (sub8 & has_chroma)))
        special.append(np.nonzero(sp)[0])
        tl_per.append(tl_all[off:off + nb])
        off += nb
    return dict(special=special, dd_per=dd_per, tl=tl_per,
                f2d_map=f2d_map)


def _sub8x8_refined_vec(blk, bw4, bh4, ssh, ssv, has_chroma, rf):
    """Vectorized is_sub8x8 refinement (recon_tmpl.c:1703): neighbour
    inter-ness gathered from rf.ref. Negative-index wrap matches the
    per-block Python semantics."""
    from . import plan_vec as pv
    cand = has_chroma & ((bw4 == ssh) | (bh4 == ssv))
    if not cand.any():
        return cand
    idx = np.nonzero(cand)[0]
    by = blk[idx, pv.B_BY]
    bx = blk[idx, pv.B_BX]
    refarr = rf.ref[:, :, 0]
    ok = np.ones(len(idx), bool)
    w1 = bw4[idx] == 1
    h1 = bh4[idx] == ssv
    if w1.any():
        ok &= ~w1 | (refarr[by, bx - 1] > 0)
    if h1.any():
        ok &= ~h1 | (refarr[by - 1, bx] > 0)
    both = w1 & h1
    if both.any():
        ok &= ~both | (refarr[by - 1, bx - 1] > 0)
    out = np.zeros(blk.shape[0], bool)
    out[idx] = ok
    return out


def _plan_obmc(plan, pl, ssh, ssv, coder, fhdr, refs, rf, f2d_map, b,
               scaled_of, scale_step):
    """OBMC lap planning (dav1d recon_tmpl.c obmc:1071)."""
    b_dim = T_BLOCK_DIM[b.bs]
    bw4, bh4 = int(b_dim[0]), int(b_dim[1])
    bx, by = b.bx, b.by
    w4 = min(bw4, coder.bw - bx)
    h4 = min(bh4, coder.bh - by)
    h_mul, v_mul = 4 >> ssh, 4 >> ssv
    dst_y = (by * 4) >> ssv
    dst_x = (bx * 4) >> ssh

    def emit(phase, ow4, mc_h4, cy, cx, src_bx, src_by, d):
        """one lap: MC of (ow4, mc_h4) at (src_bx, src_by) with the
        neighbour's mv/ref, blended at d."""
        rref = int(rf.ref[cy, cx, 0]) - 1
        rmv = (int(rf.mv[cy, cx, 0, 0]), int(rf.mv[cy, cx, 0, 1]))
        f2d = int(f2d_map[cy, cx])
        lw = ow4 * h_mul
        lh = mc_h4 * v_mul
        # top laps blend d[2] = v_mul * oh4 rows (the mask covers 3/4 of
        # them); left laps use the full lap width
        region = d[2] if phase == 0 else lw
        key = (phase, lh, lw, region)
        lst = plan.laps[pl].setdefault(key, [])
        if scaled_of(rref):
            scale, step = scale_step(rref)
            (row, _, _, _, _), = _scaled_rows(
                ssh if pl else 0, ssv if pl else 0, (ow4, mc_h4),
                src_bx, src_by, rmv, f2d, rref, scale, step, split=False)
            lst.append(("s", row, (d[0], d[1])))
            return
        tmp = {}
        _units_for_block_raw(tmp, pl, ssh, ssv, (ow4, mc_h4), src_bx,
                             src_by, rmv, rref, f2d, dst=(d[0], d[1]),
                             whole=True)
        (k2, l2), = tmp.items()
        lst.append(("t", l2[0][:6] + k2[2:4], (d[0], d[1])))

    if by > coder.row_start and (pl == 0 or
                                 bw4 * h_mul + bh4 * v_mul >= 16):
        i = 0
        x = 0
        while x < w4 and i < min(int(b_dim[2]), 4):
            cy, cx = by - 1, bx + x + 1
            step4 = max(2, min(16, int(T_BLOCK_DIM[rf.bs[cy, cx]][0])))
            if rf.ref[cy, cx, 0] > 0:
                ow4 = min(step4, bw4)
                oh4 = min(bh4, 16) >> 1
                mc_h4 = (oh4 * 3 + 3) >> 2
                emit(0, ow4, mc_h4, cy, cx, bx + x, by,
                     (dst_y, dst_x + x * h_mul, v_mul * oh4))
                i += 1
            x += step4
    if bx > coder.col_start:
        i = 0
        y = 0
        while y < h4 and i < min(int(b_dim[3]), 4):
            cy, cx = by + y + 1, bx - 1
            step4 = max(2, min(16, int(T_BLOCK_DIM[rf.bs[cy, cx]][1])))
            if rf.ref[cy, cx, 0] > 0:
                ow4 = min(bw4, 16) >> 1
                oh4 = min(step4, bh4)
                emit(1, ow4, oh4, cy, cx, bx, by + y,
                     (dst_y + y * v_mul, dst_x, 0))
                i += 1
            y += step4


class BuiltFrame:
    """Output of build_frame_program: the frame's packed device program
    plus everything execute_frame_program needs. Holds only entropy-
    stage products and reference IDENTITY — no reference pixels."""
    __slots__ = ("prog", "ref_desc", "hres_meta", "intra_frame",
                 "full_device", "dd_per", "intra_engine")


def build_frame_program(seq, fhdr, coders, bufs, refs, jnt_weights=None,
                        intra_engine=False):
    """Plan + pack the whole per-frame device pixel stage. Reads only
    entropy products (blocks/coefs/refmvs) and reference METADATA
    (dims/slots) — reference pixels are bound by execute_frame_program.
    jnt_weights: the frame's distance weights (host/obu.
    compute_jnt_weights), needed when it has distance-weighted compound
    blocks. intra_engine: reconstruct the plain intra blocks of an
    eligible inter frame with the device intra engine (models/intra) in
    this same program; built.intra_engine says whether the frame was
    eligible."""
    bd = seq.bitdepth
    cur_w, cur_h = fhdr.width[0], fhdr.height
    ss_hor, ss_ver = bufs.ss_hor, bufs.ss_ver
    n_planes = len(bufs.planes)
    intra_frame = fhdr.frame_type in (0, 2)
    if not all(getattr(c, "native_arrays", None) is not None
               for c in coders):
        raise ValueError("frame planning needs the native tile walk's "
                         "dense records")
    from ..ops.wedge import wedge_mask

    plan = _FramePlan(n_planes)

    def scaled_of(i):
        rb = refs[fhdr.refidx[i]]
        return rb.width != cur_w or rb.height != cur_h

    def scale_step(i):
        rb = refs[fhdr.refidx[i]]
        sx = _scale_fac(rb.width, cur_w)
        sy = _scale_fac(rb.height, cur_h)
        return (sx, sy), ((sx + 8) >> 4, (sy + 8) >> 4)

    def plan_put(pl, b_dims, bx, by, mv, f2d, ref_i, ssh, ssv, dst=None):
        if scaled_of(ref_i):
            scale, step = scale_step(ref_i)
            h_mul = 4 >> (ssh if pl else 0)
            v_mul = 4 >> (ssv if pl else 0)
            base = dst if dst is not None else (by * v_mul, bx * h_mul)
            for row, uw, uh, oy, ox in _scaled_rows(
                    ssh if pl else 0, ssv if pl else 0, b_dims, bx, by,
                    mv, f2d, ref_i, scale, step):
                plan.scaled_put[pl].setdefault((uw, uh, ref_i), []).append(
                    (row, base[0] + oy, base[1] + ox))
        else:
            _units_for_block_raw(plan.put[pl], pl, ssh, ssv, b_dims, bx,
                                 by, mv, ref_i, f2d, dst=dst)

    vec = None
    f2d_map = None
    if not intra_frame:
        vec = _vec_plan(fhdr, coders, refs, plan, n_planes, ss_hor,
                        ss_ver, cur_w, cur_h)
        f2d_map = vec["f2d_map"]

    # per-block loop over the special shapes _vec_plan leaves: warp,
    # scaled references, OBMC laps, sub-8x8 chroma and compound blocks
    for ci, coder in enumerate(coders):
        if intra_frame:
            break
        rf = coder.rf
        for bi in vec["special"][ci]:
            bi = int(bi)
            b = coder.blocks[bi]
            cls = _block_device_class(fhdr, coder, b, refs, cur_w, cur_h)
            b_dim = T_BLOCK_DIM[b.bs]
            bw4, bh4 = int(b_dim[0]), int(b_dim[1])
            bx, by = b.bx, b.by
            has_chroma = (n_planes > 1 and
                          (bw4 > ss_hor or bx & 1) and
                          (bh4 > ss_ver or by & 1))

            if cls == "single":
                scaled = scaled_of(b.ref[0])
                warp_wm = None
                if min(bw4, bh4) > 1:
                    if b.motion_mode == 2 and b.warp is not None and \
                            b.warp.type > 1:
                        warp_wm = b.warp
                    elif b.inter_mode == 2:  # GLOBALMV
                        warp_wm = _gmv_warp_params(fhdr, b.ref[0], scaled)
                use_warp = warp_wm is not None

                if use_warp:
                    for row, sy, sx in _warp_rows(0, 0, warp_wm, bx, by,
                                                  bw4, bh4, b.ref[0]):
                        plan.warp_put[0].append(
                            (row, by * 4 + sy, bx * 4 + sx))
                else:
                    if scaled:
                        # plain translational luma is vector-planned
                        plan_put(0, (bw4, bh4), bx, by, b.mv[0],
                                 b.filter2d, b.ref[0], 0, 0)
                    if b.motion_mode == 1:  # OBMC
                        _plan_obmc(plan, 0, 0, 0, coder, fhdr, refs, rf,
                                   f2d_map, b, scaled_of, scale_step)

                if has_chroma:
                    cbw4 = (bw4 + ss_hor) >> ss_hor
                    cbh4 = (bh4 + ss_ver) >> ss_ver
                    is_sub8x8 = bw4 == ss_hor or bh4 == ss_ver
                    if is_sub8x8:
                        if bw4 == 1:
                            is_sub8x8 &= rf.ref[by, bx - 1, 0] > 0
                        if bh4 == ss_ver:
                            is_sub8x8 &= rf.ref[by - 1, bx, 0] > 0
                        if bw4 == 1 and bh4 == ss_ver:
                            is_sub8x8 &= rf.ref[by - 1, bx - 1, 0] > 0
                    if is_sub8x8:
                        # neighbour-MV chroma MC quadrants (dav1d
                        # recon_tmpl.c:1703-1747)
                        uvx = (bx >> ss_hor) * 4
                        uvy = (by >> ss_ver) * 4
                        h_off = v_off = 0

                        def sub_mc(cy, cx, dyo, dxo, f2d_val):
                            rref = int(rf.ref[cy, cx, 0]) - 1
                            rmv = (int(rf.mv[cy, cx, 0, 0]),
                                   int(rf.mv[cy, cx, 0, 1]))
                            for pl in (1, 2):
                                plan_put(pl, (bw4, bh4), cx, cy, rmv,
                                         f2d_val, rref, ss_hor, ss_ver,
                                         dst=(uvy + dyo, uvx + dxo))

                        tl_val = int(vec["tl"][ci][bi])
                        if bw4 == 1 and bh4 == ss_ver:
                            sub_mc(by - 1, bx - 1, 0, 0, tl_val)
                            v_off, h_off = 2, 2
                        if bw4 == 1:
                            sub_mc(by, bx - 1, v_off, 0,
                                   int(f2d_map[by, bx - 1]))
                            h_off = 2
                        if bh4 == ss_ver:
                            sub_mc(by - 1, bx, 0, h_off,
                                   int(f2d_map[by - 1, bx]))
                            v_off = 2
                        for pl in (1, 2):
                            plan_put(pl, (bw4, bh4), bx, by, b.mv[0],
                                     b.filter2d, b.ref[0], ss_hor,
                                     ss_ver, dst=(uvy + v_off,
                                                  uvx + h_off))
                    elif use_warp and min(cbw4, cbh4) > 1:
                        for pl in (1, 2):
                            for row, sy, sx in _warp_rows(
                                    ss_hor, ss_ver, warp_wm, bx, by, bw4,
                                    bh4, b.ref[0]):
                                plan.warp_put[pl].append(
                                    (row, ((by * 4) >> ss_ver) + sy,
                                     ((bx * 4) >> ss_hor) + sx))
                    else:
                        for pl in (1, 2):
                            if use_warp or scaled:
                                # plain translational chroma is
                                # vector-planned
                                plan_put(pl, (bw4 << (bw4 == ss_hor),
                                              bh4 << (bh4 == ss_ver)),
                                         bx & ~ss_hor, by & ~ss_ver,
                                         b.mv[0], b.filter2d, b.ref[0],
                                         ss_hor, ss_ver)
                            if not use_warp and b.motion_mode == 1:
                                _plan_obmc(plan, pl, ss_hor, ss_ver,
                                           coder, fhdr, refs, rf,
                                           f2d_map, b, scaled_of,
                                           scale_step)
            else:
                # compound (dav1d recon_tmpl.c:1822-1907)
                def side(i, pl, ssh, ssv):
                    wm = _gmv_warp_params(fhdr, b.ref[i],
                                          scaled_of(b.ref[i])) \
                        if b.inter_mode == 6 else None   # GLOBALMV x2
                    cbw4c = (bw4 + ssh) >> ssh
                    cbh4c = (bh4 + ssv) >> ssv
                    if wm is not None and (pl == 0 or
                                           min(cbw4c, cbh4c) > 1):
                        return ("w", _warp_rows(ssh, ssv, wm, bx, by,
                                                bw4, bh4, b.ref[i]))
                    if scaled_of(b.ref[i]):
                        scale, step = scale_step(b.ref[i])
                        return ("s", _scaled_rows(ssh, ssv, (bw4, bh4),
                                                  bx, by, b.mv[i],
                                                  b.filter2d, b.ref[i],
                                                  scale, step))
                    return ("t", (b.ref[i], b.mv[i], b.filter2d))

                jw = 8
                if b.comp_type == COMP_INTER_WEIGHTED_AVG:
                    jw = jnt_weights[b.ref[0]][b.ref[1]]
                join = {COMP_INTER_AVG: ("avg", 8),
                        COMP_INTER_WEIGHTED_AVG: ("wavg", jw),
                        COMP_INTER_SEG: ("seg", 0),
                        COMP_INTER_WEDGE: ("wedge", b.wedge_idx)}[
                            b.comp_type]
                entry = dict(sides=[side(0, 0, 0, 0), side(1, 0, 0, 0)],
                             join=join, sign=b.mask_sign,
                             dst=(by * 4, bx * 4), bs=b.bs,
                             dims=(bw4, bh4), pos=(bx, by))
                plan.comp[0].setdefault((bw4 * 4, bh4 * 4),
                                        []).append(entry)
                if has_chroma:
                    for pl in (1, 2):
                        centry = dict(
                            sides=[side(0, pl, ss_hor, ss_ver),
                                   side(1, pl, ss_hor, ss_ver)],
                            join=join, sign=b.mask_sign,
                            dst=((by * 4) >> ss_ver, (bx * 4) >> ss_hor),
                            bs=b.bs, dims=(bw4, bh4), pos=(bx, by),
                            luma=entry)
                        plan.comp[pl].setdefault(
                            ((bw4 * 4) >> ss_hor, (bh4 * 4) >> ss_ver),
                            []).append(centry)

    # --- reference sources ---
    # A source is the device copy a previous frame's filter chain left
    # behind (rb.dev_planes) or the numpy plane of a host-decoded ref.
    # Only the (buffer, plane) IDENTITY is recorded here; the tensors are
    # bound by execute_frame_program.
    ref_desc = []
    _src_ids = {}

    def _src(rb, pl):
        k = (id(rb), pl)
        if k not in _src_ids:
            ref_desc.append((rb, pl))
            _src_ids[k] = len(ref_desc) - 1
        return _src_ids[k]

    # A scaled reference's stacked slot is -1 (zeros, which no op reads);
    # its ops read a view of its own size (srefspec, indexed by sref_idx)
    refspec = []
    sref_keys = []
    srefspec = []
    for pl in range(n_planes if not intra_frame else 0):
        ssh = ss_hor if pl else 0
        ssv = ss_ver if pl else 0
        w_vis = (cur_w + ssh) >> ssh
        h_vis = (cur_h + ssv) >> ssv
        slots = []
        for i in range(7):
            rb = refs[fhdr.refidx[i]]
            if rb is None or rb.width != cur_w or rb.height != cur_h:
                if rb is not None and (pl, i) not in sref_keys:
                    w_v = (rb.width + ssh) >> ssh
                    h_v = (rb.height + ssv) >> ssv
                    sref_keys.append((pl, i))
                    srefspec.append((_src(rb, pl), h_v, w_v))
                slots.append(-1)
            else:
                slots.append(_src(rb, pl))
        refspec.append(((h_vis, w_vis), tuple(slots)))

    # --- pack the whole device pixel stage into one program ---
    from .frame_exec import (FrameProgram, ItxRun, McRun, compact_cf,
                             pack_put_case)
    sref_idx = {k: i for i, k in enumerate(sref_keys)}
    prog = FrameProgram(
        n_planes, bd,
        [] if intra_frame else [p.shape for p in bufs.planes],
        refspec, srefspec,
        out_dtype=None if intra_frame else bufs.planes[0].dtype)

    # the frame's unit MC, warp and OBMC work lists (McRun): its put,
    # scaled, warp and obmc records and the "t", "s" and "w" sub-ops of
    # its comp and obmc records, n_real the rows before their pad rows
    mcr = McRun(prog)

    # translational put batches
    for pl in range(0 if intra_frame else n_planes):
        merged_put = dict(plan.put[pl])
        for key, varr in plan.put_vec[pl].items():
            got = merged_put.get(key)
            merged_put[key] = (varr if got is None else np.concatenate(
                [varr, np.asarray(got, np.int32).reshape(-1, 8)]))
        for key in sorted(merged_put):
            arr = np.asarray(merged_put[key], np.int32).reshape(-1, 8)
            pack_put_case(prog, pl, key, _pad_rows(arr, 6), mcr)

    # warp put batches
    for pl in range(0 if intra_frame else n_planes):
        wl = plan.warp_put[pl]
        if not wl:
            continue
        P = _p2(len(wl))
        rows = _pad_rows(np.asarray([r for r, _, _ in wl], np.int32),
                         None, P)
        ys = _pad_vec(np.asarray([y for _, y, _ in wl], np.int32), True, P)
        xs = _pad_vec(np.asarray([x for _, _, x in wl], np.int32), False, P)
        mcr.op("warp", pl, prog.emit(rows), prog.emit(ys), prog.emit(xs),
               n_real=len(wl))

    # scaled put batches; a view holds one reference, so each row's
    # reference index is 0
    for pl in range(0 if intra_frame else n_planes):
        for (uw, uh, ref_i), lst in sorted(plan.scaled_put[pl].items()):
            P = _p2(len(lst))
            rows = np.asarray([r for r, _, _ in lst], np.int32)
            rows[:, 0] = 0
            rows = _pad_rows(rows, None, P)
            ys = _pad_vec(np.asarray([y for _, y, _ in lst], np.int32),
                          True, P)
            xs = _pad_vec(np.asarray([x for _, _, x in lst], np.int32),
                          False, P)
            mcr.op("scaled", pl, sref_idx[(pl, ref_i)], uw, uh,
                   prog.emit(rows), prog.emit(ys), prog.emit(xs),
                   n_real=len(lst))

    # compound batches (luma first: seg chroma masks derive from the
    # luma preps)
    def _pack_side(pl, bwp, bhp, group, i, ssh, ssv):
        tcases, wunits, sunits = {}, [], {}
        for slot, e in enumerate(group):
            kind, payload = e["sides"][i]
            if kind == "t":
                ref_i, mv, f2d = payload
                tmp2 = {}
                _units_for_block_raw(tmp2, pl, ssh, ssv, e["dims"],
                                     e["pos"][0], e["pos"][1], mv,
                                     ref_i, f2d, whole=True)
                (k2, l2), = tmp2.items()
                tcases.setdefault(k2[2:4], []).append((slot, l2[0]))
            elif kind == "w":
                for row, sy, sx in payload:
                    wunits.append((slot, row, sy, sx))
            else:   # "s"
                for row, uw, uh, sy, sx in payload:
                    sunits.setdefault((uw, uh, row[0]), []).append(
                        (slot, row, sy, sx))
        subops, n_real = [], []
        for (hh, hv), lst in sorted(tcases.items()):
            P = _p2(len(lst))
            arr = _pad_rows(np.asarray([u[:6] for _, u in lst], np.int32),
                            None, P)
            slots = _pad_vec(np.asarray([s for s, _ in lst], np.int32),
                             False, P)
            subops.append(("t", bool(hh), bool(hv), prog.emit(arr),
                           prog.emit(slots)))
            n_real.append(len(lst))
        if wunits:
            P = _p2(len(wunits))
            rows = _pad_rows(np.asarray([r for _, r, _, _ in wunits],
                                        np.int32), None, P)
            base = _pad_vec(np.asarray(
                [s * bhp * bwp + sy * bwp + sx
                 for s, _, sy, sx in wunits], np.int32), False, P)
            subops.append(("w", prog.emit(rows), prog.emit(base)))
            n_real.append(len(wunits))
        for (uw, uh, ref_i), lst in sorted(sunits.items()):
            P = _p2(len(lst))
            rows = np.asarray([r for _, r, _, _ in lst], np.int32)
            rows[:, 0] = 0
            rows = _pad_rows(rows, None, P)
            base = _pad_vec(np.asarray(
                [s * bhp * bwp + sy * bwp + sx
                 for s, _, sy, sx in lst], np.int32), False, P)
            subops.append(("s", sref_idx[(pl, ref_i)], uw, uh,
                           prog.emit(rows), prog.emit(base)))
            n_real.append(len(lst))
        return tuple(subops), tuple(n_real)

    for pl in range(0 if intra_frame else n_planes):
        ssh = ss_hor if pl else 0
        ssv = ss_ver if pl else 0
        for key in sorted(plan.comp[pl]):
            group = plan.comp[pl][key]
            bwp, bhp = key
            # shape-stabilize: pad the group with copies of the last
            # entry whose destination is OOB (the scatter drops them);
            # always reserve >= 1 pad, so slot N-1 is sacrificial
            npad = _p2(len(group) + 1) - len(group)
            last = group[-1]
            group = group + [dict(last, dst=(PAD_OOB, 0))
                             for _ in range(npad)]
            N = len(group)
            sides, side_n = zip(*(_pack_side(pl, bwp, bhp, group, i, ssh,
                                             ssv) for i in (0, 1)))

            joins = []
            idx_by_kind = {}
            for slot, e in enumerate(group):
                idx_by_kind.setdefault(e["join"][0], []).append(slot)
            for kind, slots in sorted(idx_by_kind.items()):
                P = _p2(len(slots))
                slots = slots + [slots[-1]] * (P - len(slots))
                h_sl = prog.emit(np.asarray(slots, np.int32))
                h_sgn = prog.emit(np.asarray(
                    [group[s]["sign"] for s in slots], np.int32))
                if kind in ("avg", "wavg"):
                    h_w = prog.emit(np.asarray(
                        [group[s]["join"][1] for s in slots], np.int32))
                    joins.append(("wavg", h_sl, h_w))
                elif kind == "seg":
                    if pl == 0:
                        cmid = prog.new_cm()
                        joins.append(("segl", h_sl, h_sgn, cmid))
                        # chroma gathers its rows from the registered
                        # luma mask batch
                        for j, s in enumerate(slots):
                            group[s]["cmask"] = (cmid, j)
                    else:
                        crefs = [group[s]["luma"]["cmask"]
                                 for s in slots]
                        if all(r[0] == crefs[0][0] for r in crefs):
                            spec = ("one", crefs[0][0], prog.emit(
                                np.asarray([r[1] for r in crefs],
                                           np.int32)))
                        else:   # slots span several luma batches
                            spec = ("mix", tuple(crefs))
                        joins.append(("segc", h_sl, h_sgn, spec))
                else:  # wedge
                    chr_idx = 0 if pl == 0 else ss_hor + ss_ver
                    masks = np.stack([
                        wedge_mask(chr_idx, group[s]["bs"],
                                   group[s]["sign"] if pl else 0,
                                   group[s]["join"][1])[:bhp, :bwp]
                        for s in slots]).astype(np.int32)
                    joins.append(("wedge", h_sl, h_sgn, prog.emit(masks)))

            h_dy = prog.emit(np.asarray([e["dst"][0] for e in group],
                                        np.int32))
            h_dx = prog.emit(np.asarray([e["dst"][1] for e in group],
                                        np.int32))
            mcr.op("comp", pl, bwp, bhp, N, sides, tuple(joins), ss_hor,
                   ss_ver, h_dy, h_dx, n_real=side_n)

    # OBMC lap batches (after ALL puts; top phase, then left)
    for phase in (0, 1):
        for pl in range(0 if intra_frame else n_planes):
            for (ph_, lh, lw, region), lst in sorted(plan.laps[pl].items()):
                if ph_ != phase:
                    continue
                lk, lr, _ = lst[-1]
                # extra=1 reserves a sacrificial pad: slot nL-1 is never
                # a real lap
                nL = _p2(len(lst) + 1)
                lst = lst + [(lk, lr, (PAD_OOB, 0))] * (nL - len(lst))
                tcases, sunits = {}, {}
                for slot, (kind, row, _) in enumerate(lst):
                    if kind == "t":
                        tcases.setdefault(tuple(row[6:8]), []).append(
                            (slot, row[:6]))
                    else:
                        sunits.setdefault(row[0], []).append((slot, row))
                subops, n_real = [], []
                for (hh, hv), l2 in sorted(tcases.items()):
                    P = _p2(len(l2))
                    arr = _pad_rows(np.asarray([u for _, u in l2],
                                               np.int32), None, P)
                    slots = _pad_vec(np.asarray([s for s, _ in l2],
                                                np.int32), False, P)
                    subops.append(("t", bool(hh), bool(hv),
                                   prog.emit(arr), prog.emit(slots)))
                    n_real.append(len(l2))
                for ref_i, l2 in sorted(sunits.items()):
                    P = _p2(len(l2))
                    rows = np.asarray([r for _, r in l2], np.int32)
                    rows[:, 0] = 0
                    rows = _pad_rows(rows, None, P)
                    # whole-slot writes as sub-rect scatters at
                    # slot * lh * lw
                    base = _pad_vec(np.asarray([s * lh * lw for s, _ in l2],
                                               np.int32), False, P)
                    subops.append(("s", sref_idx[(pl, ref_i)], lw, lh,
                                   prog.emit(rows), prog.emit(base)))
                    n_real.append(len(l2))
                h_ys = prog.emit(np.asarray([d[0] for _, _, d in lst],
                                            np.int32))
                h_xs = prog.emit(np.asarray([d[1] for _, _, d in lst],
                                            np.int32))
                mcr.op("obmc", pl, lh, lw, region if phase == 0 else lw,
                       phase == 1, nL, tuple(subops), h_ys, h_xs,
                       n_real=tuple(n_real))
    mcr.close()

    # --- residual inverse transforms, ALL blocks ---
    # Device-covered inter blocks scatter-add straight onto the plane
    # (their prediction is already there). Every other block (intra,
    # intrabc, inter-intra) gets its residual computed on device too and
    # handed to the host walk via a (plane, y, x) map: prediction needs
    # reconstructed neighbours (sequential), but the inverse transforms
    # depend only on coefficients. Buckets are keyed by (plane, tx SIZE);
    # the transform TYPE is per-block data (ops/itx.itx_residual_multi).
    # Lossless WHT keeps buckets of its own (residc / hresc).
    from ..ops.itx_meta import TX_INFO as _TXI, WHT_WHT
    from .plan_vec import B_INTRA, ResidBucket, plan_residuals_vec
    if intra_frame:
        dd_per = [np.zeros(c.native_arrays[0].shape[0], np.uint8)
                  for c in coders]
    else:
        dd_per = vec["dd_per"]
    # ---- mixed-frame device intra (the intra engine) eligibility ----
    # Every non-intra block must be device-covered (dd 1) and there may
    # be no inter-intra blends (dd 2, host decode-order work): intra
    # units' edges must only ever read pixels the device itself produced.
    # Eligible intra blocks are re-marked dd 3; their residuals feed the
    # engine's residual planes instead of the host map (hres), and the
    # frame becomes full_device: no plane download, no host pass 2.
    eng = bool(intra_engine and not intra_frame)
    if eng:
        for ci, coder in enumerate(coders):
            intra_m = coder.native_arrays[0][:, B_INTRA] != 0
            dd = dd_per[ci]
            if (dd == 2).any() or ((dd == 0) & ~intra_m).any():
                eng = False
                break
        if eng:
            for ci, coder in enumerate(coders):
                dd = dd_per[ci]
                dd[(dd == 0) & (coder.native_arrays[0][:, B_INTRA] != 0)] = 3
    rv = plan_residuals_vec(coders, dd_per)
    if rv is None:
        raise ValueError("coefficient records are not in decode order")
    rplans, hplans, iplans = rv

    # Sparse/dense split threshold: blocks with <= KS nonzeros ride the
    # K=KS lanes; the rare dense tail gets its own sub-bucket.
    KS_SPARSE = 16

    def _emit_compact_cf(cf):
        """Sparse coefficient upload (frame_exec.compact_cf): (vals, pos)
        of the nonzeros only, K padded to a power of two."""
        vals, pos, K = compact_cf(cf)
        S = cf.shape[1] * cf.shape[2]
        Kp = _p2(K)
        if Kp > K:
            vals = np.pad(vals, ((0, 0), (0, Kp - K)))
            pos = np.pad(pos, ((0, 0), (0, Kp - K)), constant_values=S)
        # 8 bpc coefficient values fit int16 (dav1d's own 8bpc coef
        # type); positions always do (S <= 1024)
        h_vals = prog.emit16(vals) if bd == 8 else prog.emit(vals)
        return h_vals, prog.emit16(pos)

    def _split_sparse(cf_real):
        """[(tag, real-row index)]: all rows, or the sparse rows and the
        dense tail when the bucket has one."""
        nnz = (cf_real.reshape(cf_real.shape[0], -1) != 0).sum(axis=1)
        sp = nnz <= KS_SPARSE
        if sp.all():
            return [("s", np.arange(cf_real.shape[0]))]
        return [("s", np.nonzero(sp)[0]), ("d", np.nonzero(~sp)[0])]

    # one work list (ItxRun) for the run of clip-add buckets, one for the
    # host-map buckets; n_real: the bucket's rows before its pad rows
    with ItxRun(prog, "add") as run:
        for (pl, tx, is_wht), lst in sorted(rplans.items()):
            w_t, h_t, _ = _TXI[tx]
            sh, sw = min(h_t, 32), min(w_t, 32)
            for _, idx in _split_sparse(lst.cf):
                Bs = len(idx)
                Ps = _p2(Bs)
                cfs = np.zeros((Ps, sh, sw), np.int32)
                yss = np.full(Ps, PAD_OOB, np.int32)
                xss = np.zeros(Ps, np.int32)
                sels = np.zeros((Ps, 2), np.int32)
                cfs[:Bs] = lst.cf[idx]
                yss[:Bs] = lst.ys[idx]
                xss[:Bs] = lst.xs[idx]
                sels[:Bs] = lst.sel[idx]
                h_vals, h_pos = _emit_compact_cf(cfs)
                if is_wht:
                    run.op("residc", pl, sh, sw, tx, WHT_WHT, h_vals, h_pos,
                           prog.emit(yss), prog.emit(xss), n_real=Bs)
                else:
                    run.op("residmc", pl, sh, sw, tx, h_vals, h_pos,
                           prog.emit(sels[:, 0]), prog.emit(sels[:, 1]),
                           prog.emit(yss), prog.emit(xss), n_real=Bs)
    # host-map buckets: residuals computed in the same program, fetched
    # after execution for the decode-order host pass
    hres_meta = []
    with ItxRun(prog, "hres") as run:
        for (pl, tx, is_wht), lst in sorted(hplans.items()):
            w_t, h_t, _ = _TXI[tx]
            sh, sw = min(h_t, 32), min(w_t, 32)
            for _, idx in _split_sparse(lst.cf):
                Bs = len(idx)
                Ps = _p2(Bs)
                cfs = np.zeros((Ps, sh, sw), np.int32)
                sel = np.zeros((Ps, 2), np.int32)
                cfs[:Bs] = lst.cf[idx]
                sel[:Bs] = lst.sel[idx]
                h_vals, h_pos = _emit_compact_cf(cfs)
                if is_wht:
                    run.op("hresc", tx, WHT_WHT, sh, sw, h_vals, h_pos,
                           n_real=Bs)
                else:
                    run.op("hresmc", tx, sh, sw, h_vals, h_pos,
                           prog.emit(sel[:, 0]), prog.emit(sel[:, 1]),
                           n_real=Bs)
                hres_meta.append((pl, ResidBucket(
                    lst.cf[idx], lst.ys[idx], lst.xs[idx], lst.sel[idx],
                    lst.ci[idx], lst.cj[idx])))

    if eng:
        # every remaining (plain intra) block reconstructs in this same
        # program through the wave scan (models/intra)
        from .intra import emit_mixed_intra
        emit_mixed_intra(prog, seq, fhdr, coders, iplans, prog.plane_shapes)

    if not intra_frame:
        prog.op("out")   # native-dtype planes for downloads and refs

    total_blocks = sum(c.native_arrays[0].shape[0] for c in coders)
    built = BuiltFrame()
    built.prog = prog
    built.ref_desc = ref_desc
    built.hres_meta = hres_meta
    built.intra_frame = intra_frame
    built.dd_per = dd_per
    built.intra_engine = eng
    n_dev = sum(int(((dd == 1) | (dd == 3)).sum()) for dd in dd_per)
    built.full_device = (not intra_frame and not hplans
                         and n_dev == total_blocks)
    return built


def execute_frame_program(built, seq, fhdr, coders, bufs, device):
    """Bind reference planes (built.ref_desc), run the packed frame
    program on `device`, and finish the frame on the host (download +
    decode-order native pass 2: intra blocks, and the intra blend of
    inter-intra blocks). Mutates bufs.planes and sets bufs.dev_planes."""
    from ..host import native_recon
    from ..utils import stages
    from .frame_exec import (download_views, plane_to_torch,
                             run_frame_program)
    n_planes = len(bufs.planes)
    intra_frame = built.intra_frame
    with stages.scope("device", device):
        refsrc = [rb.dev_planes[pl] if rb.dev_planes is not None
                  else plane_to_torch(rb.planes[pl], device)
                  for rb, pl in built.ref_desc]
        dev_out, hres = run_frame_program(built.prog, tuple(refsrc),
                                          device)
    dev_planes = None if intra_frame else list(dev_out)

    if not built.full_device:
        # pass 2 (host): intra blocks in decode order, in the native
        # walk, over the downloaded planes
        with stages.scope("host-pass2", device):
            if not intra_frame:
                for pl in range(n_planes):
                    bufs.planes[pl][...] = dev_planes[pl].cpu().numpy()
            if not native_recon.available():
                raise RuntimeError("native recon walk unavailable")
            # one host copy for each run's flat output (download_views)
            res_buf, offs = native_recon.pack_residuals(
                coders, built.hres_meta, download_views(hres))
            for ci, coder in enumerate(coders):
                rc = native_recon.recon_tile_native(
                    seq, fhdr, coder, bufs, built.dd_per[ci], res_buf,
                    offs[ci])
                if rc != 0:
                    raise RuntimeError(
                        f"native pass 2 refused tile {ci} (rc {rc}): a "
                        "block needs host inter work that the planner did "
                        "not send to the device")
            if not intra_frame:
                # the host pass touched the planes: upload them again
                dev_planes = [plane_to_torch(p, device)
                              for p in bufs.planes]
    if not intra_frame:
        bufs.dev_planes = dev_planes
    return bufs
