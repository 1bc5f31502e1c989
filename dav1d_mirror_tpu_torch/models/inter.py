"""Device inter-frame reconstruction: plan, pack, execute.

Port of ``dav1d_mirror_tpu/models/tpu_inter.py`` (``build_frame_program``
:443 with its helpers, and ``execute_frame_program`` :1319). The host
entropy pass has produced per-block modes/MVs and dequantized
coefficients; the planner (numpy, copied) turns them into one packed
frame program (models/frame_exec), which runs on the device:

  * translational MC as fixed-size unit batches over stacked reference
    planes (ops/mc, ops/mc_cuda),
  * residual inverse transforms bucketed by tx size with scatter-add
    (ops/itx).

Intra blocks (sequential neighbour dependency) run on the host
afterwards, in decode order, in the native walk (native/recon.cpp) —
valid because inter prediction never reads current-frame pixels.

This slice plans single-reference translational MC. Compound, warp,
OBMC, inter-intra and scaled references raise NotImplementedError
(ROADMAP queue 1, item 1a); the planner always runs the vectorized path
(models/plan_vec), which the native entropy walk always feeds.
"""
from __future__ import annotations

import numpy as np

from ..host.tilecoder import T_BLOCK_DIM
from ..ops.mc import PAD_OOB
from .frame_buffers import _gmv_warp_params

_LATER_MC = "ROADMAP queue 1, item 1a (compound, OBMC, warp, scaled MC)"


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


class _FramePlan:
    """All device MC work for one frame, bucketed for batching."""

    def __init__(self, n_planes):
        self.put = [dict() for _ in range(n_planes)]       # translational
        # vector-planned translational puts (models/plan_vec): per-plane
        # {(uw, uh, hh, hv): (B, 8) int32}; merged with self.put at pack
        self.put_vec = [dict() for _ in range(n_planes)]


def _vec_plan(fhdr, coders, refs, plan, n_planes, ss_hor, ss_ver,
              cur_w, cur_h):
    """Vectorized bulk planning (models/plan_vec): plans every plain
    translational put as numpy array programs, precomputes the decode-
    order filter state, and returns the per-coder special-block indices
    the per-block loop still has to visit (here: sub-8x8 chroma). Raises
    for the block families this slice does not plan."""
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
        for fam in ("comp", "use_warp", "scaled0", "obmc", "ii"):
            if cl[fam].any():
                raise NotImplementedError(
                    f"{fam} blocks in an inter frame: {_LATER_MC}")
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


class BuiltFrame:
    """Output of build_frame_program: the frame's packed device program
    plus everything execute_frame_program needs. Holds only entropy-
    stage products and reference IDENTITY — no reference pixels."""
    __slots__ = ("prog", "ref_desc", "hres_meta", "intra_frame",
                 "full_device", "dd_per")


def build_frame_program(seq, fhdr, coders, bufs, refs):
    """Plan + pack the whole per-frame device pixel stage. Reads only
    entropy products (blocks/coefs/refmvs) and reference METADATA
    (dims/slots) — reference pixels are bound by execute_frame_program."""
    bd = seq.bitdepth
    cur_w, cur_h = fhdr.width[0], fhdr.height
    ss_hor, ss_ver = bufs.ss_hor, bufs.ss_ver
    n_planes = len(bufs.planes)
    intra_frame = fhdr.frame_type in (0, 2)
    if not all(getattr(c, "native_arrays", None) is not None
               for c in coders):
        raise ValueError("frame planning needs the native tile walk's "
                         "dense records")

    plan = _FramePlan(n_planes)

    def plan_put(pl, b_dims, bx, by, mv, f2d, ref_i, ssh, ssv, dst=None):
        rb = refs[fhdr.refidx[ref_i]]
        if rb.width != cur_w or rb.height != cur_h:
            raise NotImplementedError(f"scaled reference: {_LATER_MC}")
        _units_for_block_raw(plan.put[pl], pl, ssh, ssv, b_dims, bx,
                             by, mv, ref_i, f2d, dst=dst)

    vec = None
    f2d_map = None
    if not intra_frame:
        vec = _vec_plan(fhdr, coders, refs, plan, n_planes, ss_hor,
                        ss_ver, cur_w, cur_h)
        f2d_map = vec["f2d_map"]

    # per-block loop over the special shapes: _vec_plan leaves only
    # single-reference translational blocks with sub-8x8 chroma here
    for ci, coder in enumerate(coders):
        if intra_frame:
            break
        rf = coder.rf
        for bi in vec["special"][ci]:
            bi = int(bi)
            b = coder.blocks[bi]
            cls = _block_device_class(fhdr, coder, b, refs, cur_w, cur_h)
            if cls != "single":
                raise NotImplementedError(f"{cls} block: {_LATER_MC}")
            b_dim = T_BLOCK_DIM[b.bs]
            bw4, bh4 = int(b_dim[0]), int(b_dim[1])
            bx, by = b.bx, b.by
            if min(bw4, bh4) > 1 and (
                    (b.motion_mode == 2 and b.warp is not None and
                     b.warp.type > 1) or
                    (b.inter_mode == 2 and
                     _gmv_warp_params(fhdr, b.ref[0], False) is not None)):
                raise NotImplementedError(f"warped block: {_LATER_MC}")
            if b.motion_mode == 1:
                raise NotImplementedError(f"OBMC block: {_LATER_MC}")
            has_chroma = (n_planes > 1 and
                          (bw4 > ss_hor or bx & 1) and
                          (bh4 > ss_ver or by & 1))
            if not has_chroma:
                continue
            is_sub8x8 = bw4 == ss_hor or bh4 == ss_ver
            if is_sub8x8:
                if bw4 == 1:
                    is_sub8x8 &= rf.ref[by, bx - 1, 0] > 0
                if bh4 == ss_ver:
                    is_sub8x8 &= rf.ref[by - 1, bx, 0] > 0
                if bw4 == 1 and bh4 == ss_ver:
                    is_sub8x8 &= rf.ref[by - 1, bx - 1, 0] > 0
            if not is_sub8x8:
                continue
            # neighbour-MV chroma MC quadrants (dav1d
            # recon_tmpl.c:1703-1747)
            uvx = (bx >> ss_hor) * 4
            uvy = (by >> ss_ver) * 4
            h_off = v_off = 0

            def sub_mc(cy, cx, dyo, dxo, f2d_val):
                rref = int(rf.ref[cy, cx, 0]) - 1
                rmv = (int(rf.mv[cy, cx, 0, 0]), int(rf.mv[cy, cx, 0, 1]))
                for pl in (1, 2):
                    plan_put(pl, (bw4, bh4), cx, cy, rmv, f2d_val, rref,
                             ss_hor, ss_ver, dst=(uvy + dyo, uvx + dxo))

            tl_val = int(vec["tl"][ci][bi])
            if bw4 == 1 and bh4 == ss_ver:
                sub_mc(by - 1, bx - 1, 0, 0, tl_val)
                v_off, h_off = 2, 2
            if bw4 == 1:
                sub_mc(by, bx - 1, v_off, 0, int(f2d_map[by, bx - 1]))
                h_off = 2
            if bh4 == ss_ver:
                sub_mc(by - 1, bx, 0, h_off, int(f2d_map[by - 1, bx]))
                v_off = 2
            for pl in (1, 2):
                plan_put(pl, (bw4, bh4), bx, by, b.mv[0], b.filter2d,
                         b.ref[0], ss_hor, ss_ver,
                         dst=(uvy + v_off, uvx + h_off))

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

    refspec = []
    for pl in range(n_planes if not intra_frame else 0):
        ssh = ss_hor if pl else 0
        ssv = ss_ver if pl else 0
        w_vis = (cur_w + ssh) >> ssh
        h_vis = (cur_h + ssv) >> ssv
        slots = []
        for i in range(7):
            rb = refs[fhdr.refidx[i]]
            if rb is None or rb.width != cur_w or rb.height != cur_h:
                slots.append(-1)
            else:
                slots.append(_src(rb, pl))
        refspec.append(((h_vis, w_vis), tuple(slots)))

    # --- pack the whole device pixel stage into one program ---
    from .frame_exec import FrameProgram, compact_cf, pack_put_case
    prog = FrameProgram(
        n_planes, bd,
        [] if intra_frame else [p.shape for p in bufs.planes],
        refspec, out_dtype=None if intra_frame else bufs.planes[0].dtype)

    # translational put batches
    for pl in range(0 if intra_frame else n_planes):
        merged_put = dict(plan.put[pl])
        for key, varr in plan.put_vec[pl].items():
            got = merged_put.get(key)
            merged_put[key] = (varr if got is None else np.concatenate(
                [varr, np.asarray(got, np.int32).reshape(-1, 8)]))
        for key in sorted(merged_put):
            arr = np.asarray(merged_put[key], np.int32).reshape(-1, 8)
            pack_put_case(prog, pl, key, _pad_rows(arr, 6))

    # --- residual inverse transforms, ALL blocks ---
    # Device-covered inter blocks scatter-add straight onto the plane
    # (their prediction is already there). Every other block (intra,
    # intrabc) gets its residual computed on device too and handed to
    # the host walk via a (plane, y, x) map: prediction needs
    # reconstructed neighbours (sequential), but the inverse transforms
    # depend only on coefficients. Buckets are keyed by (plane, tx SIZE);
    # the transform TYPE is per-block data (ops/itx.itx_residual_multi).
    from ..ops.itx_meta import TX_INFO as _TXI
    from .plan_vec import ResidBucket, plan_residuals_vec
    if intra_frame:
        dd_per = [np.zeros(c.native_arrays[0].shape[0], np.uint8)
                  for c in coders]
    else:
        dd_per = vec["dd_per"]
    rv = plan_residuals_vec(coders, dd_per)
    if rv is None:
        raise ValueError("coefficient records are not in decode order")
    rplans, hplans, _ = rv
    for (_, _, is_wht) in list(rplans) + list(hplans):
        if is_wht:
            raise NotImplementedError(
                "lossless WHT residuals: ROADMAP queue 1, item 1a")

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

    for (pl, tx, _), lst in sorted(rplans.items()):
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
            prog.op("residmc", pl, sh, sw, tx, h_vals, h_pos,
                    prog.emit(sels[:, 0]), prog.emit(sels[:, 1]),
                    prog.emit(yss), prog.emit(xss))
    # host-map buckets: residuals computed in the same program, fetched
    # after execution for the decode-order host pass
    hres_meta = []
    for (pl, tx, _), lst in sorted(hplans.items()):
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
            prog.op("hresmc", tx, sh, sw, h_vals, h_pos,
                    prog.emit(sel[:, 0]), prog.emit(sel[:, 1]))
            hres_meta.append((pl, ResidBucket(
                lst.cf[idx], lst.ys[idx], lst.xs[idx], lst.sel[idx],
                lst.ci[idx], lst.cj[idx])))

    if not intra_frame:
        prog.op("out")   # native-dtype planes for downloads and refs

    total_blocks = sum(c.native_arrays[0].shape[0] for c in coders)
    built = BuiltFrame()
    built.prog = prog
    built.ref_desc = ref_desc
    built.hres_meta = hres_meta
    built.intra_frame = intra_frame
    built.dd_per = dd_per
    n_dev = sum(int((dd == 1).sum()) for dd in dd_per)
    built.full_device = (not intra_frame and not hplans
                         and n_dev == total_blocks)
    return built


def execute_frame_program(built, seq, fhdr, coders, bufs, device):
    """Bind reference planes (built.ref_desc), run the packed frame
    program on `device`, and finish the frame on the host (download +
    decode-order native pass 2). Mutates bufs.planes and sets
    bufs.dev_planes."""
    from ..host import native_recon
    from ..utils import stages
    from .frame_exec import plane_to_torch, run_frame_program
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
            res_buf, offs = native_recon.pack_residuals(
                coders, built.hres_meta, [r.cpu().numpy() for r in hres])
            for ci, coder in enumerate(coders):
                rc = native_recon.recon_tile_native(
                    seq, fhdr, coder, bufs, built.dd_per[ci], res_buf,
                    offs[ci])
                if rc != 0:
                    raise NotImplementedError(
                        f"native pass 2 refused tile {ci} (rc {rc}): "
                        "intrabc / inter-intra blocks, ROADMAP queue 1, "
                        "item 1a")
            if not intra_frame:
                # the host pass touched the planes: upload them again
                dev_planes = [plane_to_torch(p, device)
                              for p in bufs.planes]
    if not intra_frame:
        bufs.dev_planes = dev_planes
    return bufs
