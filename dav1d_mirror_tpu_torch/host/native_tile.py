# Copied from dav1d_mirror_tpu/host/native_tile.py.
"""Glue for the native C++ tile walk (native/tilecoder.cpp).

``code_tile_native(coder)`` runs the full tile symbol walk (partition
tree, modes, palette, MV prediction, warp derivation, tx trees and all
coefficients) in one C call and fills the TileCoder's output lists
(blocks / coefs / cdef_idx / lr_units / seg_map) exactly as the Python
walk would — bit-exact, since both share the same msac core and CDF
arrays. Falls back by raising NativeUnsupported for configurations the
C path does not cover (none currently) so callers can use the Python
walk.

Field orders (CFG / TABS / CDF_FIELDS / BLK / COEF) MUST stay in sync
with the enums in native/tilecoder.cpp.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from ..data.tables import TABLES
from . import tilecoder as tc
from .native import LIB


class NativeUnsupported(Exception):
    pass


class NativeDecodeError(Exception):
    pass


_checked = False


def available() -> bool:
    global _checked
    if LIB is None or not hasattr(LIB, "tile_decode"):
        return False
    if not _checked:
        LIB.tile_decode.restype = ct.c_int
        LIB.tile_decode.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
            ct.c_void_p, ct.c_void_p, ct.c_char_p, ct.c_size_t,
            ct.c_void_p,
        ]
        _checked = True
    return True


# CDF pointer order — mirrors the CDF_* enum in native/tilecoder.cpp
_CDF_M = [
    "partition", "skip", "skip_mode", "seg_pred", "seg_id", None,
    "delta_q", "delta_lf", "intra", "intrabc", "y_mode", "angle_delta",
    "uv_mode", "cfl_sign", "cfl_alpha", "pal_y", "pal_uv", "pal_sz",
    "color_map", "use_filter_intra", "filter_intra", "txsz", "txpart",
    "txtp_intra1", "txtp_intra2", "txtp_inter1", "txtp_inter2",
    "txtp_inter3", "comp", "comp_dir", "comp_fwd_ref", "comp_bwd_ref",
    "comp_uni_ref", "ref", "comp_inter_mode", "newmv_mode",
    "globalmv_mode", "refmv_mode", "drl_bit", "interintra",
    "interintra_mode", "interintra_wedge", "wedge_comp", "wedge_idx",
    "jnt_comp", "mask_comp", "obmc", "motion_mode", "filter",
    "restore_wiener", "restore_sgrproj", "restore_switchable",
]
_CDF_COEF = [
    "skip", "eob_bin_16", "eob_bin_32", "eob_bin_64", "eob_bin_128",
    "eob_bin_256", "eob_bin_512", "eob_bin_1024", "eob_hi_bit",
    "eob_base_tok", "base_tok", "dc_sign", "br_tok",
]
_CDF_MV = [
    "classes", "class0", "classN", "class0_fp", "classN_fp", "class0_hp",
    "classN_hp", "sign",
]

_TAB_NAMES = [
    "block_dimensions", "block_sizes", "al_part_ctx",
    "partition_type_count", "max_txfm_size_for_bs", "txfm_dimensions",
    "intra_mode_context", "ymode_size_context", "txtp_from_uvmode",
    "tx_types_per_set", "tx_type_class", "lo_ctx_offsets", "skip_ctx",
    "dq_tbl", "comp_inter_pred_modes", "filter_2d", "wedge_ctx_lut",
    "filter_mode_to_y_mode", "sgr_params",
]

# block record fields — mirrors the B_* enum
_NBLK = 59
(B_BL, B_BP, B_BS, B_BX, B_BY, B_SEG_ID, B_SKIP_MODE, B_SKIP, B_INTRA,
 B_Y_MODE, B_Y_ANGLE, B_UV_MODE, B_UV_ANGLE, B_CFL_A0, B_CFL_A1,
 B_PAL_SZ0, B_PAL_SZ1, B_TX, B_UVTX, B_MAX_YTX, B_TX_SPLIT0, B_TX_SPLIT1,
 B_INTER_MODE, B_DRL_IDX, B_REF0, B_REF1, B_MV0Y, B_MV0X, B_MV1Y, B_MV1X,
 B_COMP_TYPE, B_MOTION_MODE, B_INTERINTRA_TYPE, B_INTERINTRA_MODE,
 B_WEDGE_IDX, B_MASK_SIGN, B_FILTER2D, B_QIDX, B_EDGE_FLAGS, B_LF0, B_LF1,
 B_LF2, B_LF3, B_COEF_LO, B_COEF_HI, B_PAL_OFF, B_PALIDX_Y_OFF,
 B_PALIDX_UV_OFF, B_WARP_VALID, B_WARP_MAT0, B_WARP_MAT1, B_WARP_MAT2,
 B_WARP_MAT3, B_WARP_MAT4, B_WARP_MAT5, B_WARP_ALPHA, B_WARP_BETA,
 B_WARP_GAMMA, B_WARP_DELTA) = range(_NBLK)

_NCOEF = 8  # plane, x, y, tx, txtp, eob, cf_off, cf_len

_TAB_CACHE = None


def _addr(arr) -> int:
    return arr.ctypes.data


def _tables_array():
    """uint64 pointer table of spec tables + qm (cached; the backing
    numpy arrays are memoized inside TABLES)."""
    global _TAB_CACHE
    if _TAB_CACHE is not None:
        return _TAB_CACHE
    keep = []  # keep referenced arrays alive
    ptrs = []
    for name in _TAB_NAMES:
        a = np.ascontiguousarray(TABLES[name])
        keep.append(a)
        ptrs.append(_addr(a))
    for t in range(19):
        a = np.ascontiguousarray(TABLES[f"scan.{t}"])
        keep.append(a)
        ptrs.append(_addr(a))
    # qm pointers are per-header; filled by caller (indices 38..94)
    ptrs.extend([0] * (19 * 3))
    arr = np.array(ptrs, np.uint64)
    _TAB_CACHE = (arr, keep)
    return _TAB_CACHE


def _cdf_ptrs(cdf):
    ptrs = []
    for name in _CDF_M:
        ptrs.append(0 if name is None else _addr(cdf.m[name]))
    for name in _CDF_COEF:
        ptrs.append(_addr(cdf.coef[name]))
    for d in (cdf.mv, cdf.dmv):
        ptrs.append(_addr(d["joint"]))
        for comp in range(2):
            for name in _CDF_MV:
                ptrs.append(_addr(d[f"comp{comp}.{name}"]))
    ptrs.append(_addr(cdf.kfym))
    return np.array(ptrs, np.uint64)


def _build_cfg(coder, caps):
    seq, f = coder.seq, coder.f
    c = {}
    vals = []

    def push(*v):
        vals.extend(int(x) for x in v)

    rf = coder.rf
    push(seq.sb128, seq.layout, seq.bitdepth, seq.hbd,
         int(coder.monochrome), coder.ss_ver, coder.ss_hor,
         seq.filter_intra, seq.inter_intra, seq.masked_compound,
         seq.jnt_comp, seq.dual_filter, seq.order_hint,
         seq.order_hint_n_bits, int(coder.keyframe), coder.bw, coder.bh,
         coder.col_start, coder.col_end, coder.row_start, coder.row_end,
         coder.sb_step, f.allow_intrabc, f.allow_screen_content_tools,
         f.force_integer_mv, f.hp, f.subpel_filter_mode,
         f.switchable_motion_mode, f.use_ref_frame_mvs, f.quant_yac,
         f.quant_ydc_delta, f.quant_udc_delta, f.quant_uac_delta,
         f.quant_vdc_delta, f.quant_vac_delta, f.quant_qm,
         f.segmentation_enabled, f.segmentation_update_map,
         f.segmentation_temporal, f.seg_data.preskip,
         f.seg_data.last_active_segid)
    for i in range(8):
        d = f.seg_data.d[i]
        push(d.delta_q, d.delta_lf_y_v, d.delta_lf_y_h, d.delta_lf_u,
             d.delta_lf_v, d.ref, d.skip, d.globalmv)
    push(*f.segmentation_qidx)
    push(*f.segmentation_lossless)
    push(f.delta_q_present, f.delta_q_res_log2, f.delta_lf_present,
         f.delta_lf_res_log2, f.delta_lf_multi,
         f.loopfilter_level_y[0], f.loopfilter_level_y[1],
         f.loopfilter_level_u, f.loopfilter_level_v,
         f.loopfilter_mode_ref_delta_enabled)
    push(*f.loopfilter_mode_ref_deltas.mode_delta)
    push(*f.loopfilter_mode_ref_deltas.ref_delta)
    push(f.cdef_n_bits)
    push(*f.restoration_type)
    push(*f.restoration_unit_size)
    push(f.super_res_width_scale_denominator, f.width[0], f.width[1],
         f.height, f.txfm_mode, f.switchable_comp_refs,
         f.skip_mode_enabled, f.skip_mode_refs[0], f.skip_mode_refs[1],
         f.warp_motion, f.reduced_txtp_set, f.frame_offset)
    for i in range(7):
        gm = f.gmv[i]
        push(gm.type, *gm.matrix)
    push(*coder.ref_poc)
    push(*[int(bool(s)) for s in coder.ref_scaled])
    push(int(not coder.ec.m.allow_update_cdf))
    push(*caps)  # 7 capacities
    if rf is not None:
        push(1, rf.iw4, rf.ih4, rf.iw8, rf.ref.shape[1],
             rf.use_ref_frame_mvs)
        push(*rf.sign_bias)
        push(*rf.pocdiff)
        push(rf.w8pad)
    else:
        push(0, 0, 0, 0, 0, 0)
        push(*([0] * 7))
        push(*([0] * 7))
        push(0)
    cfg = np.array(vals, np.int32)
    want = LIB.tile_cfg_size()
    assert cfg.shape[0] == want, (cfg.shape[0], want)
    return cfg, c


def code_tile_native(coder) -> None:
    """Run the C++ walk and populate coder.{blocks,coefs,cdef_idx,
    lr_units,seg_map} + refmvs/CDF side effects in place."""
    if not available():
        raise NativeUnsupported("native tile walk not built")
    seq, f = coder.seq, coder.f
    msac = coder.ec.m
    data = msac._buf  # NativeMsac keeps the tile payload alive

    w4t = coder.col_end - coder.col_start
    h4t = coder.row_end - coder.row_start
    n_sb = ((w4t + coder.sb_step - 1) // coder.sb_step) * \
        ((h4t + coder.sb_step - 1) // coder.sb_step)
    caps = (
        w4t * h4t + 64,                    # blocks
        4 * w4t * h4t + 1024,              # coef records
        64 * w4t * h4t + 65536,            # cf ints
        w4t * h4t // 4 + 64,               # palette entries
        32 * w4t * h4t + 8192,             # palette index bytes
        3 * ((w4t // 16 + 2) * (h4t // 16 + 2)) + 64,  # lr units
        n_sb + 8,                          # cdef records
    )

    cfg, _ = _build_cfg(coder, caps)

    tabs_arr, _keep = _tables_array()
    tabs = tabs_arr
    qm_keep = []
    if f.quant_qm:
        tabs = tabs_arr.copy()
        for tx in range(19):
            for pl, qmi in enumerate((f.quant_qm_y, f.quant_qm_u,
                                      f.quant_qm_v)):
                qm = TABLES.qm(qmi, 0 if pl == 0 else 1, tx)
                if qm is not None:
                    qm = np.ascontiguousarray(qm)
                    qm_keep.append(qm)
                    tabs[19 + 19 + tx * 3 + pl] = _addr(qm)

    cdfp = _cdf_ptrs(coder.cdf)

    rf = coder.rf
    if rf is not None:
        if rf.use_ref_frame_mvs:
            # pre-project the temporal motion fields for this tile's rows
            # (dav1d decode.c:3263; independent of the spatial walk)
            for by in range(coder.row_start, coder.row_end, coder.sb_step):
                rf.load_tmvs_rows(0, rf.iw8, by >> 1,
                                  (by + coder.sb_step) >> 1)
        rfp = np.array([_addr(rf.ref), _addr(rf.mv), _addr(rf.bs),
                        _addr(rf.mf), _addr(rf.rp_proj_mv),
                        _addr(rf.rp_proj_ref)], np.uint64)
    else:
        rfp = np.zeros(6, np.uint64)

    prev_sm = coder.prev_segmap
    if prev_sm is not None:
        prev_sm = np.ascontiguousarray(prev_sm, np.uint8)
    misc = np.array([0 if prev_sm is None else _addr(prev_sm),
                     0 if coder.seg_map is None else _addr(coder.seg_map)],
                    np.uint64)

    # np.empty: the C walk fully writes every record it emits (the cf
    # and palidx regions are memset inside the walk per block)
    blk = np.empty((caps[0], _NBLK), np.int32)
    coef = np.empty((caps[1], _NCOEF), np.int32)
    cf = np.empty(caps[2], np.int32)
    pal = np.empty((caps[3], 3, 8), np.uint16)
    palidx = np.empty(caps[4], np.uint8)
    lr = np.empty((caps[5], 12), np.int32)
    cdef = np.empty((caps[6], 6), np.int32)
    counts = np.zeros(8, np.int64)
    outp = np.array([_addr(blk), _addr(coef), _addr(cf), _addr(pal),
                     _addr(palidx), _addr(lr), _addr(cdef),
                     0], np.uint64)

    rc = LIB.tile_decode(_addr(cfg), _addr(tabs), _addr(cdfp), _addr(rfp),
                         _addr(misc), _addr(outp), data, len(data),
                         _addr(counts))
    if rc == -10:
        raise ValueError("invalid intrabc mv")
    if rc == -11:
        raise ValueError("illegal partition for 4:2:2")
    if rc != 0:
        raise NativeDecodeError(f"native tile walk failed rc={rc}")

    n_blocks, n_coefs = int(counts[0]), int(counts[1])

    # retain the dense records for the native pass-2 walk
    # (host/native_recon.py) and the vectorized planner
    # (models/plan_vec.py) — no per-block Python objects on those paths
    coder.native_arrays = (blk[:n_blocks], coef[:n_coefs], pal, palidx)
    coder.cf_buf = cf

    # blocks/coefs materialize LAZILY: the vectorized planner reads the
    # dense records directly and touches Python objects only for the
    # rare special shapes (warp/OBMC/sub-8x8/compound), so eagerly
    # building O(blocks) Av1Block objects per frame was pure overhead
    # on the production path. Fallback consumers (Python recon walk,
    # intra engine, sharded decode) iterate and pay the old cost there.
    coder.coefs = _LazyCoefs(coef[:n_coefs], cf)
    coder.blocks = _LazyBlocks(coder, blk[:n_blocks], pal, palidx)
    _finish_tile_outputs(coder, cdef, lr, counts)


class _LazyCoefs:
    __slots__ = ("_coef", "_cf", "_cache")

    def __init__(self, coef, cf):
        self._coef = coef
        self._cf = cf
        self._cache = [None] * coef.shape[0]

    def __len__(self):
        return len(self._cache)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        c = self._cache[i]
        if c is None:
            c = self._cache[i] = _make_coef(self._coef[i], self._cf)
        return c

    def __iter__(self):
        for i in range(len(self._cache)):
            yield self[i]


class _LazyBlocks:
    __slots__ = ("_coder", "_blk", "_pal", "_palidx", "_cache")

    def __init__(self, coder, blk, pal, palidx):
        self._coder = coder
        self._blk = blk
        self._pal = pal
        self._palidx = palidx
        self._cache = [None] * blk.shape[0]

    def __len__(self):
        return len(self._cache)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        b = self._cache[i]
        if b is None:
            b = self._cache[i] = _make_block(
                self._coder, self._blk[i], self._pal, self._palidx)
        return b

    def __iter__(self):
        for i in range(len(self._cache)):
            yield self[i]


def _make_coef(r, cf):
    T_TXFM = TABLES["txfm_dimensions"]
    eob = int(r[5])
    if eob < 0:
        cfa = None
    else:
        td = T_TXFM[r[3]]
        sw = 4 * min(int(td[0]), 8)
        sh = 4 * min(int(td[1]), 8)
        cfa = cf[int(r[6]):int(r[6]) + sw * sh].reshape(sw, sh).T
    return tc.CoefBlock(int(r[0]), int(r[1]), int(r[2]),
                        int(r[3]), int(r[4]), eob, cfa)


def _make_block(coder, r, pal, palidx):
        T_BD = TABLES["block_dimensions"]
        b = tc.Av1Block()
        b.bl, b.bp, b.bs = int(r[B_BL]), int(r[B_BP]), int(r[B_BS])
        b.bx, b.by = int(r[B_BX]), int(r[B_BY])
        b.seg_id = int(r[B_SEG_ID])
        b.skip_mode = int(r[B_SKIP_MODE])
        b.skip = int(r[B_SKIP])
        b.intra = int(r[B_INTRA])
        b.y_mode = int(r[B_Y_MODE])
        b.y_angle = int(r[B_Y_ANGLE])
        b.uv_mode = int(r[B_UV_MODE])
        b.uv_angle = int(r[B_UV_ANGLE])
        b.cfl_alpha = [int(r[B_CFL_A0]), int(r[B_CFL_A1])]
        b.pal_sz = [int(r[B_PAL_SZ0]), int(r[B_PAL_SZ1])]
        b.tx = int(r[B_TX])
        b.uvtx = int(r[B_UVTX])
        b.max_ytx = int(r[B_MAX_YTX])
        b.tx_split0 = int(r[B_TX_SPLIT0])
        b.tx_split1 = int(r[B_TX_SPLIT1])
        b.inter_mode = int(r[B_INTER_MODE])
        b.drl_idx = int(r[B_DRL_IDX])
        b.ref = [int(r[B_REF0]), int(r[B_REF1])]
        b.mv = [(int(r[B_MV0Y]), int(r[B_MV0X])),
                (int(r[B_MV1Y]), int(r[B_MV1X]))]
        b.comp_type = int(r[B_COMP_TYPE])
        b.motion_mode = int(r[B_MOTION_MODE])
        b.interintra_type = int(r[B_INTERINTRA_TYPE])
        b.interintra_mode = int(r[B_INTERINTRA_MODE])
        b.wedge_idx = int(r[B_WEDGE_IDX])
        b.mask_sign = int(r[B_MASK_SIGN])
        b.filter2d = int(r[B_FILTER2D])
        b.qidx = int(r[B_QIDX])
        b.edge_flags = int(r[B_EDGE_FLAGS])
        b.lflvl4 = (int(r[B_LF0]), int(r[B_LF1]), int(r[B_LF2]),
                    int(r[B_LF3]))
        b.coef_lo = int(r[B_COEF_LO])
        b.coef_hi = int(r[B_COEF_HI])
        if r[B_PAL_OFF] >= 0:
            p = pal[int(r[B_PAL_OFF])]
            b.pal = [p[0].copy() if b.pal_sz[0] else None,
                     p[1].copy() if b.pal_sz[1] else None,
                     p[2].copy() if b.pal_sz[1] else None]
        bw4, bh4 = int(T_BD[b.bs][0]), int(T_BD[b.bs][1])
        if r[B_PALIDX_Y_OFF] >= 0:
            n = bw4 * 4 * bh4 * 4
            o = int(r[B_PALIDX_Y_OFF])
            b.pal_idx_y = palidx[o:o + n].reshape(bh4 * 4, bw4 * 4).copy()
        if r[B_PALIDX_UV_OFF] >= 0:
            cbw4 = (bw4 + coder.ss_hor) >> coder.ss_hor
            cbh4 = (bh4 + coder.ss_ver) >> coder.ss_ver
            n = cbw4 * 4 * cbh4 * 4
            o = int(r[B_PALIDX_UV_OFF])
            b.pal_idx_uv = palidx[o:o + n].reshape(cbh4 * 4,
                                                   cbw4 * 4).copy()
        if b.motion_mode == 2:  # MM_WARP
            from .warpmv import WarpParams
            wm = WarpParams()
            wm.type = 3 if r[B_WARP_VALID] else 0
            wm.matrix = [int(r[B_WARP_MAT0 + k]) for k in range(6)]
            wm.alpha = int(r[B_WARP_ALPHA])
            wm.beta = int(r[B_WARP_BETA])
            wm.gamma = int(r[B_WARP_GAMMA])
            wm.delta = int(r[B_WARP_DELTA])
            b.warp = wm
        return b


def _finish_tile_outputs(coder, cdef, lr, counts):
    # ---- cdef / lr ----
    coder.cdef_idx = [(int(c0), int(c1), (int(c2), int(c3), int(c4),
                                          int(c5)))
                      for c0, c1, c2, c3, c4, c5 in cdef[:int(counts[6])]]
    lr_units = {}
    for i in range(int(counts[5])):
        r = lr[i]
        lr_units[(int(r[0]), int(r[1]), int(r[2]))] = dict(
            type=int(r[3]), filter_v=[int(r[4]), int(r[5]), int(r[6])],
            filter_h=[int(r[7]), int(r[8]), int(r[9])],
            sgr_weights=[int(r[10]), int(r[11])])
    coder.lr_units = lr_units
