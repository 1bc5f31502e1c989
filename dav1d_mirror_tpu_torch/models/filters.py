"""Device in-loop filter chain: deblock -> CDEF -> super-resolution ->
loop restoration.

Port of ``dav1d_mirror_tpu/models/tpu_filters.py`` (``build_cdef_plan``
:39, ``_lr_stripe_plan`` :63, ``apply_inloop_filters_tpu`` :136). The
host builds small integer plan arrays (edge/level maps, the CDEF index
map, the LR stripe-unit batches) from the parsed headers and entropy
state; the pixels stay device tensors across the stages, packed into one
program (models/frame_exec, plane-input mode). A super-res frame is
deblocked and CDEF-filtered at its coded width, upscaled (``sres``), and
loop-restored at the upscaled width.
"""
from __future__ import annotations

import numpy as np

from ..host.lf import build_lf_arrays
from ..ops.mc import PAD_OOB
from ..ops.spec_consts import (LR_HAVE_BOTTOM, LR_HAVE_LEFT, LR_HAVE_RIGHT,
                               LR_HAVE_TOP, RESTORATION_WIENER, SGR_PARAMS,
                               calc_eih)
from .frame_buffers import FrameBuffers
from .inter import _p2, _resize_params


def build_cdef_plan(fhdr, coders):
    """Host plan for CDEF: per-64x64 index map + 4x4 noskip map."""
    bw4 = coders[0].bw
    bh4 = coders[0].bh
    n64x = (bw4 + 15) >> 4
    n64y = (bh4 + 15) >> 4
    cdef_idx_map = np.full((n64y, n64x), -1, np.int32)
    for coder in coders:
        sb_step = coder.sb_step
        for (bx, by, idxs) in coder.cdef_idx:
            if sb_step == 32:
                for q, v in enumerate(idxs):
                    qx = (bx >> 4) + (q & 1)
                    qy = (by >> 4) + (q >> 1)
                    if qy < n64y and qx < n64x:
                        cdef_idx_map[qy, qx] = v
            else:
                cdef_idx_map[by >> 4, bx >> 4] = idxs[0]
    from .plan_vec import build_cdef_noskip
    noskip = build_cdef_noskip(fhdr, coders)
    return cdef_idx_map, noskip


def _lr_stripe_plan(fhdr, coders, bufs, p):
    """Enumerate LR stripe-units for plane p exactly as the reference
    decoder's stripe loop (models.ref_decoder.apply_lr); yields dicts
    with geometry + params."""
    lr_units = {}
    for coder in coders:
        lr_units.update(coder.lr_units)
    ss_ver = bufs.ss_ver if p else 0
    ss_hor = bufs.ss_hor if p else 0
    hh = (bufs.height + ss_ver) >> ss_ver
    ww = (bufs.width + ss_hor) >> ss_hor
    us_log2 = fhdr.restoration_unit_size[1 if p else 0]
    unit_size = 1 << us_log2
    half = unit_size >> 1
    max_unit = unit_size + half

    y = 0
    while y < hh:
        stripe_h = min((64 - 8 * (y == 0)) >> ss_ver, hh - y)
        row_y = y + ((8 >> ss_ver) if y else 0)
        aligned = row_y & ~(unit_size - 1)
        if aligned and aligned + half > hh:
            aligned -= unit_size
        urow64 = (aligned << ss_ver) >> 6
        edges_base = ((LR_HAVE_TOP if y > 0 else 0) |
                      (LR_HAVE_BOTTOM if y + stripe_h < hh else 0))
        x = 0
        while x < ww:
            if x + max_unit <= ww:
                uw = unit_size
                last = False
            else:
                uw = ww - x
                last = True
            ucol64 = (x << ss_hor) >> 6
            lr = lr_units.get((p, urow64, ucol64))
            if lr is not None and lr["type"] != 0:
                edges = edges_base | \
                    (LR_HAVE_LEFT if x > 0 else 0) | \
                    (0 if last else LR_HAVE_RIGHT)
                yield dict(x=x, y=y, w=uw, h=stripe_h, edges=edges, lr=lr)
            x += uw
        y += stripe_h


def _emit_lr_plane(prog, fhdr, coders, bufs, p):
    """Snapshot plane p before its restoration and emit one ``lrw`` or
    ``lrs`` op per bucket of stripe-units of one geometry (and SGR kind),
    each padded to a power of two: pad rows repeat the last unit for the
    window gather and carry PAD_OOB destinations, which the scatter
    drops."""
    def sgr(u):
        """(s0, s1) strengths of an SGR unit's parameter set."""
        s0, s1 = SGR_PARAMS[u["lr"]["type"] - 3]
        return int(s0), int(s1)

    prog.op("snap", ("prelr", p))
    groups = {}
    for u in _lr_stripe_plan(fhdr, coders, bufs, p):
        if u["lr"]["type"] == RESTORATION_WIENER:
            key = ("wiener", u["w"], u["h"])
        else:
            s0, s1 = sgr(u)
            kind = 2 if (s0 and s1) else (0 if s0 else 1)
            key = ("sgr", kind, u["w"], u["h"])
        groups.setdefault(key, []).append(u)

    for key, units in sorted(groups.items()):
        B = len(units)
        P = _p2(B)
        w, h = key[-2], key[-1]

        def col(f, pad=None):
            v = np.asarray([f(u) for u in units], np.int32)
            if P != B:
                fill = v[-1] if pad is None else pad
                v = np.concatenate([v, np.full(P - B, fill, np.int32)])
            return prog.emit(v)

        h_xs = col(lambda u: u["x"])
        h_ysin = col(lambda u: u["y"])               # gather: in bounds
        h_ysout = col(lambda u: u["y"], pad=PAD_OOB)  # scatter: dropped
        h_eg = col(lambda u: u["edges"])
        if key[0] == "wiener":
            def taps(name):
                f = np.zeros((P, 7), np.int32)
                for i, u in enumerate(units):
                    f3 = u["lr"][name]
                    f[i, :3] = f3
                    f[i, 4:] = f3[::-1]
                    f[i, 3] = 128 - 2 * (f3[0] + f3[1] + f3[2])
                f[B:] = f[B - 1]
                return prog.emit(f)
            prog.op("lrw", p, "precdef", w, h, h_xs, h_ysin, h_ysout, h_eg,
                    taps("filter_h"), taps("filter_v"))
        else:
            h_s0 = col(lambda u: sgr(u)[0])
            h_s1 = col(lambda u: sgr(u)[1])
            h_w0 = col(lambda u: u["lr"]["sgr_weights"][0])
            h_w1 = col(lambda u: 128 - (u["lr"]["sgr_weights"][0] +
                                        u["lr"]["sgr_weights"][1]))
            prog.op("lrs", p, "precdef", key[1], w, h, h_xs, h_ysin,
                    h_ysout, h_eg, h_s0, h_s1, h_w0, h_w1)


def apply_inloop_filters(seq, fhdr, coders, bufs, device, filters_mask=7):
    """Deblock, CDEF, super-resolution and loop restoration over the
    frame's planes on `device`, starting from the device planes the
    reconstruction left (bufs.dev_planes) or from an upload of
    bufs.planes. Returns the frame's final buffers: `bufs`, or for a
    super-res frame new buffers of the upscaled width (fhdr.width[1]).
    Publishes the filtered device planes on their dev_planes (later frames
    read them as references); download_planes copies them to the
    host."""
    from .frame_exec import FrameProgram, plane_to_torch, run_frame_program

    if bufs.dev_planes is not None:
        planes_in = list(bufs.dev_planes)
    else:
        planes_in = [plane_to_torch(p, device) for p in bufs.planes]
    bd = seq.bitdepth
    prog = FrameProgram(len(planes_in), bd,
                        [tuple(p.shape) for p in planes_in],
                        plane_inputs=True,
                        out_dtype=bufs.planes[0].dtype)

    # ---- deblock ----
    if (filters_mask & 1) and (fhdr.loopfilter_level_y[0] or
                               fhdr.loopfilter_level_y[1]):
        lf = build_lf_arrays(seq, fhdr, coders, bufs.width, bufs.height)
        e_lut, i_lut = calc_eih(fhdr.loopfilter_sharpness)
        # deblock maps are dense per-4x4 frames of tiny values (levels
        # <= 63, edge classes -1..2): the int8 side carries them. e_lut
        # peaks at 193 (2*(63+2)+63) so it stays on the int16 side.
        h_el = prog.emit16(np.asarray(e_lut))
        h_il = prog.emit8(np.asarray(i_lut))
        sb_step4 = 32 if seq.sb128 else 16
        lv = lf.lvl_y[:, :, 0].astype(np.int8)
        lh_ = lf.lvl_y[:, :, 1].astype(np.int8)
        # a dbk record a plane (the JAX interpreter's form, which the
        # tests replay), then one dbkrun record with every plane's maps:
        # the executor deblocks the frame in one launch
        maps = [(prog.emit8(lf.edge_v_y), prog.emit8(lf.edge_h_y),
                 prog.emit8(lv), prog.emit8(lh_))]
        prog.op("dbk", 0, True, sb_step4, *maps[0], h_el, h_il)
        if (len(planes_in) > 1 and
                (fhdr.loopfilter_level_u or fhdr.loopfilter_level_v)):
            h_ev = prog.emit8(lf.edge_v_uv)
            h_eh = prog.emit8(lf.edge_h_uv)
            for pl in (0, 1):
                # chroma v/h share one level channel
                lvc = lf.lvl_uv[:, :, pl].astype(np.int8)
                h_lvc = prog.emit8(lvc)
                maps.append((h_ev, h_eh, h_lvc, h_lvc))
                prog.op("dbk", 1 + pl, False, sb_step4 >> bufs.ss_ver,
                        *maps[-1], h_el, h_il)
        prog.op("dbkrun", tuple(maps), h_el, h_il)

    restore = [(filters_mask & 4) and fhdr.restoration_type[p] != 0
               for p in range(len(planes_in))]
    if any(restore):
        prog.op("snap", "precdef")   # boundary-row source for LR

    # ---- CDEF ----
    if (filters_mask & 2) and seq.cdef and \
            (any(fhdr.cdef_y_strength[:1 << fhdr.cdef_n_bits]) or
             any(fhdr.cdef_uv_strength[:1 << fhdr.cdef_n_bits])):
        cdef_idx_map, noskip = build_cdef_plan(fhdr, coders)
        prog.op("cdef", prog.emit8(cdef_idx_map),
                prog.emit8(noskip.astype(np.int8)),
                prog.emit8(np.asarray(fhdr.cdef_y_strength, np.int8)),
                prog.emit8(np.asarray(fhdr.cdef_uv_strength, np.int8)),
                fhdr.cdef_damping + (bd - 8), bufs.ss_hor, bufs.ss_ver,
                seq.layout == 0)

    # ---- super-resolution: the planes, and the pre-CDEF snapshot that
    # LR reads its stripe boundaries from ----
    if fhdr.width[0] != fhdr.width[1]:
        new_bufs = FrameBuffers(seq, fhdr, width=fhdr.width[1])
        bw4f = ((fhdr.width[0] + 7) >> 3) << 1
        for pl in range(len(planes_in)):
            ss_hor = bufs.ss_hor if pl else 0
            ss_ver = bufs.ss_ver if pl else 0
            in_w = (fhdr.width[0] + ss_hor) >> ss_hor
            out_w = (fhdr.width[1] + ss_hor) >> ss_hor
            step, start = _resize_params(in_w, out_w)
            src_w = (4 * bw4f + ss_hor) >> ss_hor
            h_vis = (fhdr.height + ss_ver) >> ss_ver
            oshape = tuple(new_bufs.planes[pl].shape)
            prog.op("sres", None, pl, out_w, src_w, step, start, h_vis,
                    oshape)
            if any(restore):
                prog.op("sres", "precdef", pl, out_w, src_w, step, start,
                        h_vis, oshape)
        bufs.dev_planes = None   # the coded-width planes are dead now
        bufs = new_bufs

    # ---- loop restoration ----
    for p in range(len(planes_in)):
        if restore[p]:
            _emit_lr_plane(prog, fhdr, coders, bufs, p)

    prog.op("out")   # native-dtype planes for the download and the refs
    planes, _ = run_frame_program(prog, tuple(planes_in), device)
    bufs.dev_planes = list(planes)
    return bufs


def download_planes(bufs):
    """Copy the filtered device planes (bufs.dev_planes) into bufs.planes
    on the host."""
    for i, p in enumerate(bufs.dev_planes):
        bufs.planes[i] = p.cpu().numpy().astype(bufs.planes[i].dtype)
