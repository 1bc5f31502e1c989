"""Device in-loop filter chain: deblock -> CDEF.

Port of the deblock and CDEF part of ``dav1d_mirror_tpu/models/
tpu_filters.py`` (``build_cdef_plan`` :39, ``apply_inloop_filters_tpu``
:136-211 and its ``out`` op :292). The host builds small integer plan
arrays (edge/level maps, the CDEF index map) from the parsed headers and
entropy state; the pixels stay device tensors across both stages, packed
into one program (models/frame_exec, plane-input mode).

Super-resolution and loop restoration raise NotImplementedError: they
are config 3's slice (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import numpy as np

from ..host.lf import build_lf_arrays
from ..ops.spec_consts import calc_eih


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


def apply_inloop_filters(seq, fhdr, coders, bufs, device, filters_mask=7):
    """Deblock and CDEF over the frame's planes on `device`, starting from
    the device planes the reconstruction left (bufs.dev_planes) or from
    an upload of bufs.planes. Publishes the filtered device planes on
    bufs.dev_planes (later frames read them as references) and downloads
    them into bufs.planes. Returns bufs."""
    from .frame_exec import FrameProgram, plane_to_torch, run_frame_program

    if fhdr.width[0] != fhdr.width[1]:
        raise NotImplementedError(
            "super-resolution: ROADMAP queue 1, item 6 (config 3)")
    if (filters_mask & 4) and any(fhdr.restoration_type[p] != 0
                                  for p in range(len(bufs.planes))):
        raise NotImplementedError(
            "loop restoration: ROADMAP queue 1, item 6 (config 3)")
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
        prog.op("dbk", 0, True, sb_step4, prog.emit8(lf.edge_v_y),
                prog.emit8(lf.edge_h_y), prog.emit8(lv),
                prog.emit8(lh_), h_el, h_il)
        if (len(planes_in) > 1 and
                (fhdr.loopfilter_level_u or fhdr.loopfilter_level_v)):
            h_ev = prog.emit8(lf.edge_v_uv)
            h_eh = prog.emit8(lf.edge_h_uv)
            for pl in (0, 1):
                # chroma v/h share one level channel
                lvc = lf.lvl_uv[:, :, pl].astype(np.int8)
                h_lvc = prog.emit8(lvc)
                prog.op("dbk", 1 + pl, False, sb_step4 >> bufs.ss_ver,
                        h_ev, h_eh, h_lvc, h_lvc, h_el, h_il)

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

    prog.op("out")   # native-dtype planes for the download and the refs
    planes, _ = run_frame_program(prog, tuple(planes_in), device)
    bufs.dev_planes = list(planes)
    for i, p in enumerate(planes):
        bufs.planes[i] = p.cpu().numpy().astype(bufs.planes[i].dtype)
    return bufs
