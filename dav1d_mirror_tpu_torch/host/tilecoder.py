# Copied from dav1d_mirror_tpu/host/tilecoder.py.
"""Tile symbol layer: mirrored decoder/encoder for AV1 block entropy coding.

One implementation of the partition walk, mode decode, and coefficient
decode serves both directions:

* decode mode — the host parse stage: consumes a tile's msac bitstream and
  emits the frame plan (per-block modes + dequantized coefficient blocks)
  for the TPU reconstruction stage.
* encode mode — the test-stream generator: a policy callback picks each
  symbol value; contexts/CDF adaptation evolve identically, so the output
  stream is conformant by construction and is cross-verified against the
  reference decoder binary.

Reference parity (behavior, not code): dav1d src/decode.c (decode_sb:2161,
decode_b:717, read_pal_indices:442), src/recon_tmpl.c (decode_coefs:321,
read_coef_blocks:825), src/env.h context derivations.

Current scope: intra frames (key/intra, no intrabc); inter joins next.
"""
from __future__ import annotations

import numpy as np

from ..data.tables import TABLES, CdfContext
from .intra_edge import (INTRA_EDGE_TREE, EDGE_ALL_TR_AND_BL,
                         EDGE_ALL_TOP_HAS_RIGHT, EDGE_ALL_LEFT_HAS_BOTTOM)
from .headers import (SequenceHeader, FrameHeader, PIXEL_LAYOUT_I400,
                      PIXEL_LAYOUT_I420, PIXEL_LAYOUT_I422,
                      PIXEL_LAYOUT_I444, TX_SWITCHABLE, TX_4X4_ONLY)

# ---- enums (dav1d src/levels.h) ----
N_INTRA_PRED_MODES = 13
(DC_PRED, VERT_PRED, HOR_PRED, DIAG_DOWN_LEFT_PRED, DIAG_DOWN_RIGHT_PRED,
 VERT_RIGHT_PRED, HOR_DOWN_PRED, HOR_UP_PRED, VERT_LEFT_PRED, SMOOTH_PRED,
 SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED) = range(13)
CFL_PRED = N_INTRA_PRED_MODES
FILTER_PRED = N_INTRA_PRED_MODES

(PARTITION_NONE, PARTITION_H, PARTITION_V, PARTITION_SPLIT,
 PARTITION_T_TOP_SPLIT, PARTITION_T_BOTTOM_SPLIT, PARTITION_T_LEFT_SPLIT,
 PARTITION_T_RIGHT_SPLIT, PARTITION_H4, PARTITION_V4) = range(10)
N_PARTITIONS = 10

BL_128X128, BL_64X64, BL_32X32, BL_16X16, BL_8X8 = range(5)
N_BS_SIZES = 22
BS_4x4 = 21

TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 = range(5)
TX_CLASS_2D, TX_CLASS_H, TX_CLASS_V = range(3)
DCT_DCT = 0
IDTX = 9
WHT_WHT = 16

_BS_LIST = [(128, 128), (128, 64), (64, 128), (64, 64), (64, 32), (64, 16),
            (32, 64), (32, 32), (32, 16), (32, 8), (16, 64), (16, 32),
            (16, 16), (16, 8), (16, 4), (8, 32), (8, 16), (8, 8), (8, 4),
            (4, 16), (4, 8), (4, 4)]
CFL_ALLOWED = {i for i, (w, h) in enumerate(_BS_LIST) if w <= 32 and h <= 32}
# dav1d src/tables.h:86,97 (BS indices: 32x32..8x8 resp. subsets)
WEDGE_ALLOWED = {7, 8, 9, 11, 12, 13, 15, 16, 17}
INTERINTRA_ALLOWED = {7, 8, 11, 12, 13, 16, 17}

# inter enums (dav1d src/levels.h:207-257)
NEARESTMV, NEARMV, GLOBALMV, NEWMV = range(4)
(NEAREST_DRL, NEARER_DRL, NEAR_DRL, NEARISH_DRL) = range(4)
(NEARESTMV_NEARESTMV, NEARMV_NEARMV, NEARESTMV_NEWMV, NEWMV_NEARESTMV,
 NEARMV_NEWMV, NEWMV_NEARMV, GLOBALMV_GLOBALMV, NEWMV_NEWMV) = range(8)
N_COMP_INTER_PRED_MODES = 8
(COMP_INTER_NONE, COMP_INTER_WEIGHTED_AVG, COMP_INTER_AVG, COMP_INTER_SEG,
 COMP_INTER_WEDGE) = range(5)
MM_TRANSLATION, MM_OBMC, MM_WARP = range(3)
INTER_INTRA_NONE, INTER_INTRA_BLEND, INTER_INTRA_WEDGE = range(3)
N_SWITCHABLE_FILTERS = 3

# ---- spec tables ----
T_BLOCK_DIM = TABLES["block_dimensions"]          # [bs][w4,h4,lw,lh]
T_BLOCK_SIZES = TABLES["block_sizes"]             # [bl][bp][2]
T_AL_PART_CTX = TABLES["al_part_ctx"]             # [2][bl][bp]
T_PART_COUNT = TABLES["partition_type_count"]     # [bl]
T_MAX_TX = TABLES["max_txfm_size_for_bs"]         # [bs][4]
T_TXFM = TABLES["txfm_dimensions"]                # [19][w,h,lw,lh,min,max,sub,ctx]
T_INTRA_MODE_CTX = TABLES["intra_mode_context"]   # [13]
T_YMODE_SIZE_CTX = TABLES["ymode_size_context"]
T_TXTP_FROM_UVMODE = TABLES["txtp_from_uvmode"]
T_TX_TYPES_PER_SET = TABLES["tx_types_per_set"]
T_TX_TYPE_CLASS = TABLES["tx_type_class"]
T_LO_CTX_OFFSETS = TABLES["lo_ctx_offsets"]       # [3][5][5]
T_SKIP_CTX = TABLES["skip_ctx"]                   # [5][5]
T_DQ = TABLES["dq_tbl"]                           # [hbd][256][2]
SCANS = [TABLES[f"scan.{t}"] for t in range(19)]
T_COMP_INTER_MODES = TABLES["comp_inter_pred_modes"]  # [8][2]
T_FILTER_2D = TABLES["filter_2d"]                 # [v][h] -> Filter2d
T_WEDGE_CTX = TABLES["wedge_ctx_lut"]             # [bs]


def iclip_u8(v):
    return max(0, min(255, v))


def iclip_u8_range(v, lo, hi):
    return max(lo, min(hi, v))


# ------------------------------------------------------------------
# EC adapters: one tile coder, two directions
# ------------------------------------------------------------------
class DecodeSide:
    is_decode = True

    def __init__(self, msac):
        self.m = msac

    @property
    def rng(self):
        return self.m.rng

    def sym(self, key, cdf, n):
        return self.m.decode_symbol_adapt(cdf, n)

    def bool_adapt(self, key, cdf):
        return self.m.decode_bool_adapt(cdf)

    def boolp(self, key, f):
        return self.m.decode_bool(f)

    def equi(self, key):
        return self.m.decode_bool_equi()

    def bools(self, key, n):
        return self.m.decode_bools(n)

    def hi_tok(self, key, cdf):
        return self.m.decode_hi_tok(cdf)

    def golomb(self, key):
        ln = 0
        while not self.m.decode_bool_equi() and ln < 32:
            ln += 1
        val = 1
        for _ in range(ln):
            val = (val << 1) + self.m.decode_bool_equi()
        return val - 1

    def subexp(self, key, ref, n, k):
        return self.m.decode_subexp(ref, n, k)

    def uniform(self, key, n):
        # dav1d_msac_decode_uniform (msac.h): ns(n) over the arithmetic coder
        assert n > 1
        ln = (n - 1).bit_length()
        m = (1 << ln) - n
        v = self.m.decode_bools(ln - 1)
        return v if v < m else (v << 1) - m + self.m.decode_bool_equi()


class EncodeSide:
    is_decode = False

    def __init__(self, enc, policy):
        self.e = enc
        self.policy = policy

    @property
    def rng(self):
        return self.e.rng

    def sym(self, key, cdf, n):
        v = self.policy(key, n)  # value in [0, n]
        self.e.put_symbol_adapt(v, cdf, n)
        return v

    def bool_adapt(self, key, cdf):
        v = self.policy(key, 1)
        self.e.put_bool_adapt(v, cdf)
        return v

    def boolp(self, key, f):
        v = self.policy(key, 1)
        self.e.put_bool(v, f)
        return v

    def equi(self, key):
        v = self.policy(key, 1)
        self.e.put_bool_equi(v)
        return v

    def bools(self, key, n):
        if n == 0:
            return 0
        v = self.policy(key, (1 << n) - 1)
        self.e.put_bools(v, n)
        return v

    def hi_tok(self, key, cdf):
        v = 3 + self.policy(key, 12)  # tok in [3, 15]
        self.e.put_hi_tok(v, cdf)
        return v

    def golomb(self, key):
        v = self.policy(key, 1 << 16)
        val = v + 1
        ln = val.bit_length() - 1
        assert ln < 32
        for _ in range(ln):
            self.e.put_bool_equi(0)
        self.e.put_bool_equi(1)
        for k in range(ln - 1, -1, -1):
            self.e.put_bool_equi((val >> k) & 1)
        return v

    def subexp(self, key, ref, n, k):
        v = self.policy(key, n - 1)
        self.e.put_subexp(v, ref, n, k)
        return v

    def uniform(self, key, n):
        assert n > 1
        v = self.policy(key, n - 1)
        ln = (n - 1).bit_length()
        m = (1 << ln) - n
        if v < m:
            self.e.put_bools(v, ln - 1)
        else:
            x = v + m
            self.e.put_bools(x >> 1, ln - 1)
            self.e.put_bool_equi(x & 1)
        return v


# ------------------------------------------------------------------
# env.h inter context derivations (dav1d src/env.h:59-438)
# ------------------------------------------------------------------
def get_intra_ctx(a, l, by4, bx4, have_top, have_left):
    if have_left:
        if have_top:
            ctx = int(l.intra[by4]) + int(a.intra[bx4])
            return ctx + (ctx == 2)
        return int(l.intra[by4]) * 2
    return int(a.intra[bx4]) * 2 if have_top else 0


def get_comp_ctx(a, l, by4, bx4, have_top, have_left):
    if have_top:
        if have_left:
            if a.comp_type[bx4]:
                if l.comp_type[by4]:
                    return 4
                return 2 + (int(l.ref[0][by4]) >= 4 or l.ref[0][by4] < 0)
            if l.comp_type[by4]:
                return 2 + (int(a.ref[0][bx4]) >= 4 or a.ref[0][bx4] < 0)
            return int(l.ref[0][by4] >= 4) ^ int(a.ref[0][bx4] >= 4)
        return 3 if a.comp_type[bx4] else int(a.ref[0][bx4] >= 4)
    if have_left:
        return 3 if l.comp_type[by4] else int(l.ref[0][by4] >= 4)
    return 1


def _has_uni_comp(edge, off):
    return (edge.ref[0][off] < 4) == (edge.ref[1][off] < 4)


def get_comp_dir_ctx(a, l, by4, bx4, have_top, have_left):
    if have_top and have_left:
        a_intra, l_intra = a.intra[bx4], l.intra[by4]
        if a_intra and l_intra:
            return 2
        if a_intra or l_intra:
            edge, off = (l, by4) if a_intra else (a, bx4)
            if edge.comp_type[off] == COMP_INTER_NONE:
                return 2
            return 1 + 2 * int(_has_uni_comp(edge, off))
        a_comp = a.comp_type[bx4] != COMP_INTER_NONE
        l_comp = l.comp_type[by4] != COMP_INTER_NONE
        a_ref0, l_ref0 = int(a.ref[0][bx4]), int(l.ref[0][by4])
        if not a_comp and not l_comp:
            return 1 + 2 * int((a_ref0 >= 4) == (l_ref0 >= 4))
        if not a_comp or not l_comp:
            edge, off = (a, bx4) if a_comp else (l, by4)
            if not _has_uni_comp(edge, off):
                return 1
            return 3 + int((a_ref0 >= 4) == (l_ref0 >= 4))
        a_uni, l_uni = _has_uni_comp(a, bx4), _has_uni_comp(l, by4)
        if not a_uni and not l_uni:
            return 0
        if not a_uni or not l_uni:
            return 2
        return 3 + int((a_ref0 == 4) == (l_ref0 == 4))
    if have_top or have_left:
        edge, off = (l, by4) if have_left else (a, bx4)
        if edge.intra[off]:
            return 2
        if edge.comp_type[off] == COMP_INTER_NONE:
            return 2
        return 4 * int(_has_uni_comp(edge, off))
    return 2


def _ref_cnts(a, l, by4, bx4, have_top, have_left):
    out = []
    if have_top and not a.intra[bx4]:
        out.append(int(a.ref[0][bx4]))
        if a.comp_type[bx4]:
            out.append(int(a.ref[1][bx4]))
    if have_left and not l.intra[by4]:
        out.append(int(l.ref[0][by4]))
        if l.comp_type[by4]:
            out.append(int(l.ref[1][by4]))
    return out


def _cnt_ctx(c0, c1):
    return 1 if c0 == c1 else (0 if c0 < c1 else 2)


def get_ref_ctx(a, l, by4, bx4, have_top, have_left):
    refs = _ref_cnts(a, l, by4, bx4, have_top, have_left)
    c = [0, 0]
    for r in refs:
        c[r >= 4] += 1
    return _cnt_ctx(c[0], c[1])


def get_fwd_ref_ctx(a, l, by4, bx4, have_top, have_left):
    refs = _ref_cnts(a, l, by4, bx4, have_top, have_left)
    c = [0, 0, 0, 0]
    for r in refs:
        if 0 <= r < 4:
            c[r] += 1
    return _cnt_ctx(c[0] + c[1], c[2] + c[3])


def get_fwd_ref_1_ctx(a, l, by4, bx4, have_top, have_left):
    refs = _ref_cnts(a, l, by4, bx4, have_top, have_left)
    c = [0, 0]
    for r in refs:
        if 0 <= r < 2:
            c[r] += 1
    return _cnt_ctx(c[0], c[1])


def get_fwd_ref_2_ctx(a, l, by4, bx4, have_top, have_left):
    refs = _ref_cnts(a, l, by4, bx4, have_top, have_left)
    c = [0, 0]
    for r in refs:
        if 2 <= r < 4:
            c[r - 2] += 1
    return _cnt_ctx(c[0], c[1])


def get_bwd_ref_ctx(a, l, by4, bx4, have_top, have_left):
    refs = _ref_cnts(a, l, by4, bx4, have_top, have_left)
    c = [0, 0, 0]
    for r in refs:
        if r >= 4:
            c[r - 4] += 1
    return _cnt_ctx(c[1] + c[0], c[2])


def get_bwd_ref_1_ctx(a, l, by4, bx4, have_top, have_left):
    refs = _ref_cnts(a, l, by4, bx4, have_top, have_left)
    c = [0, 0, 0]
    for r in refs:
        if r >= 4:
            c[r - 4] += 1
    return _cnt_ctx(c[0], c[1])


def get_uni_p1_ctx(a, l, by4, bx4, have_top, have_left):
    refs = _ref_cnts(a, l, by4, bx4, have_top, have_left)
    c = [0, 0, 0]
    for r in refs:
        if 1 <= r < 4:
            c[r - 1] += 1
    return _cnt_ctx(c[0], c[1] + c[2])


def get_jnt_comp_ctx(order_hint_n_bits, poc, ref0poc, ref1poc, a, l,
                     by4, bx4):
    def poc_diff(p0, p1):
        if not order_hint_n_bits:
            return 0
        mask = 1 << (order_hint_n_bits - 1)
        diff = p0 - p1
        return (diff & (mask - 1)) - (diff & mask)
    d0 = abs(poc_diff(ref0poc, poc))
    d1 = abs(poc_diff(poc, ref1poc))
    offset = int(d0 == d1)
    a_ctx = int(a.comp_type[bx4] >= COMP_INTER_AVG or a.ref[0][bx4] == 6)
    l_ctx = int(l.comp_type[by4] >= COMP_INTER_AVG or l.ref[0][by4] == 6)
    return 3 * offset + a_ctx + l_ctx


def get_mask_comp_ctx(a, l, by4, bx4):
    a_ctx = 1 if a.comp_type[bx4] >= COMP_INTER_SEG else \
        3 if a.ref[0][bx4] == 6 else 0
    l_ctx = 1 if l.comp_type[by4] >= COMP_INTER_SEG else \
        3 if l.ref[0][by4] == 6 else 0
    return min(a_ctx + l_ctx, 5)


def get_filter_ctx(a, l, comp, dir_, ref, by4, bx4):
    a_filter = int(a.filter[dir_][bx4]) \
        if (a.ref[0][bx4] == ref or a.ref[1][bx4] == ref) \
        else N_SWITCHABLE_FILTERS
    l_filter = int(l.filter[dir_][by4]) \
        if (l.ref[0][by4] == ref or l.ref[1][by4] == ref) \
        else N_SWITCHABLE_FILTERS
    if a_filter == l_filter:
        return comp * 4 + a_filter
    if a_filter == N_SWITCHABLE_FILTERS:
        return comp * 4 + l_filter
    if l_filter == N_SWITCHABLE_FILTERS:
        return comp * 4 + a_filter
    return comp * 4 + N_SWITCHABLE_FILTERS


def get_drl_context(stack, ref_idx):
    if stack[ref_idx][2] >= 640:
        return int(stack[ref_idx + 1][2] < 640)
    return 2 if stack[ref_idx + 1][2] < 640 else 0


def get_uv_inter_txtp(uvt_dim, ytxtp):
    """dav1d env.h get_uv_inter_txtp:120."""
    H_ADST, V_ADST, H_FLIPADST, V_FLIPADST = 12, 13, 14, 15
    if int(uvt_dim[5]) == TX_32X32:
        return IDTX if ytxtp == IDTX else DCT_DCT
    if int(uvt_dim[4]) == TX_16X16 and \
            ytxtp in (H_FLIPADST, V_FLIPADST, H_ADST, V_ADST):
        return DCT_DCT
    return ytxtp


# ------------------------------------------------------------------
# Block context (dav1d env.h BlockContext)
# ------------------------------------------------------------------
class BlockContext:
    FIELDS = dict(mode=np.uint8, lcoef=np.uint8, seg_pred=np.uint8,
                  skip=np.uint8, skip_mode=np.uint8, intra=np.uint8,
                  comp_type=np.uint8, tx_intra=np.int8, tx=np.int8,
                  tx_lpf_y=np.uint8, tx_lpf_uv=np.uint8, uvmode=np.uint8,
                  pal_sz=np.uint8)

    def __init__(self):
        for f, dt in self.FIELDS.items():
            setattr(self, f, np.zeros(32, dt))
        self.ccoef = np.zeros((2, 32), np.uint8)
        self.ref = np.full((2, 32), -1, np.int8)
        self.filter = np.zeros((2, 32), np.uint8)
        self.partition = np.zeros(16, np.uint8)

    def reset(self, keyframe: bool):
        # dav1d decode.c:2434 reset_context
        self.intra[:] = 1 if keyframe else 0
        self.uvmode[:] = DC_PRED
        if keyframe:
            self.mode[:] = DC_PRED
        else:
            self.mode[:] = 0  # NEARESTMV for inter frames
        self.partition[:] = 0
        self.skip[:] = 0
        self.skip_mode[:] = 0
        self.tx_lpf_y[:] = 2
        self.tx_lpf_uv[:] = 1
        self.tx_intra[:] = -1
        self.tx[:] = TX_64X64
        if not keyframe:
            self.ref[:] = -1
            self.comp_type[:] = 0
        self.lcoef[:] = 0x40
        self.ccoef[:] = 0x40
        self.filter[:] = 3  # DAV1D_N_SWITCHABLE_FILTERS
        self.seg_pred[:] = 0
        self.pal_sz[:] = 0


class Av1Block:
    __slots__ = ("bl", "bp", "bs", "seg_id", "skip_mode", "skip", "intra",
                 "y_mode", "y_angle", "uv_mode", "uv_angle", "cfl_alpha",
                 "pal_sz", "pal", "pal_idx_y", "pal_idx_uv", "tx", "uvtx",
                 "bx", "by", "qidx", "edge_flags", "lflvl4",
                 # inter
                 "inter_mode", "drl_idx", "ref", "mv", "comp_type",
                 "motion_mode", "interintra_type", "interintra_mode",
                 "wedge_idx", "mask_sign", "filter2d", "max_ytx",
                 "tx_split0", "tx_split1", "coef_lo", "coef_hi", "warp")

    def __init__(self):
        self.pal_sz = [0, 0]
        self.cfl_alpha = [0, 0]
        self.pal = [None, None, None]
        self.pal_idx_y = None
        self.pal_idx_uv = None
        self.intra = 1
        self.skip_mode = 0
        self.comp_type = COMP_INTER_NONE
        self.motion_mode = MM_TRANSLATION
        self.interintra_type = INTER_INTRA_NONE
        self.ref = [-1, -1]
        self.mv = [(0, 0), (0, 0)]
        self.filter2d = 0
        self.tx_split0 = 0
        self.tx_split1 = 0
        self.warp = None
        self.wedge_idx = 0
        self.mask_sign = 0
        self.interintra_mode = 0


class CoefBlock:
    __slots__ = ("plane", "x", "y", "tx", "txtp", "eob", "cf")

    def __init__(self, plane, x, y, tx, txtp, eob, cf):
        self.plane = plane
        self.x = x          # in 4px units, within frame (luma coords /plane)
        self.y = y
        self.tx = tx
        self.txtp = txtp
        self.eob = eob
        self.cf = cf        # (sh*4, sw*4)? stored flat dav1d layout


class TileCoder:
    def __init__(self, seq: SequenceHeader, fhdr: FrameHeader,
                 cdf: CdfContext, ec, tile_col: int = 0, tile_row: int = 0,
                 rf=None, prev_segmap=None, ref_poc=None, ref_scaled=None):
        self.seq = seq
        self.f = fhdr
        self.cdf = cdf
        self.ec = ec
        self.rf = rf                  # host.refmvs.RefmvsFrame (inter frames)
        self.prev_segmap = prev_segmap
        self.ref_poc = ref_poc or [0] * 7
        self.ref_scaled = ref_scaled or [False] * 7
        self.txtp_map = np.zeros((32, 32), np.uint8)
        t = fhdr.tiling
        sbsz_log2 = 6 + seq.sb128
        sb_step = 1 << (sbsz_log2 - 2)  # in 4px units
        self.sb_step = sb_step
        self.sb128 = seq.sb128
        self.root_bl = BL_128X128 if seq.sb128 else BL_64X64
        # frame dims in 4px units (dav1d: f->bw = ((w+7)>>3)<<1)
        self.bw = ((fhdr.width[0] + 7) >> 3) << 1
        self.bh = ((fhdr.height + 7) >> 3) << 1
        self.col_start = t.col_start_sb[tile_col] << (sbsz_log2 - 2)
        self.col_end = min(t.col_start_sb[tile_col + 1] << (sbsz_log2 - 2),
                           self.bw)
        self.row_start = t.row_start_sb[tile_row] << (sbsz_log2 - 2)
        self.row_end = min(t.row_start_sb[tile_row + 1] << (sbsz_log2 - 2),
                           self.bh)
        layout = seq.layout
        self.layout = layout
        self.ss_ver = 1 if layout == PIXEL_LAYOUT_I420 else 0
        self.ss_hor = 1 if layout != PIXEL_LAYOUT_I444 else 0
        self.monochrome = layout == PIXEL_LAYOUT_I400
        # contexts
        n_a = (self.col_end - self.col_start + 31) >> 5
        self.a_arr = [BlockContext() for _ in range(n_a + 1)]
        self.l = BlockContext()
        self.keyframe = fhdr.frame_type in (0, 2)  # KEY or INTRA
        for a in self.a_arr:  # dav1d resets all f->a[] at frame init
            a.reset(self.keyframe)
        # quant
        self.dq_frame = self._init_quant_tables(fhdr.quant_yac)
        self.dq = self.dq_frame
        self.last_qidx = fhdr.quant_yac
        self.last_delta_lf = [0, 0, 0, 0]
        self.qidx_map = np.zeros((self.bh, self.bw), np.uint8) \
            if fhdr.delta_q_present else None
        # qm tables
        self.qm = [[None] * 3 for _ in range(19)]
        if fhdr.quant_qm:
            for tx in range(19):
                self.qm[tx][0] = TABLES.qm(fhdr.quant_qm_y, 0, tx)
                self.qm[tx][1] = TABLES.qm(fhdr.quant_qm_u, 1, tx)
                self.qm[tx][2] = TABLES.qm(fhdr.quant_qm_v, 1, tx)
        # loop restoration state
        self.restore_planes = 0
        for pidx in range(3):
            if fhdr.restoration_type[pidx] != 0:
                self.restore_planes |= 1 << pidx
        self.lr_ref = [dict(type=0, filter_v=[3, -7, 15],
                            filter_h=[3, -7, 15], sgr_weights=[-32, 31])
                       for _ in range(3)]
        self.lr_units: dict = {}
        # outputs
        self.blocks: list[Av1Block] = []
        self.coefs: list[CoefBlock] = []
        self.cdef_idx: list[tuple] = []
        # per-sb state
        self.cur_sb_cdef_idx = [-1, -1, -1, -1]
        self.seg_map = np.zeros((self.bh, self.bw), np.uint8) \
            if fhdr.segmentation_enabled else None
        # palette above/left caches (dav1d t->al_pal / t->pal_sz_uv),
        # full-frame dense equivalents of the 32-entry rings
        self.al_pal = [np.zeros((self.bw, 3, 8), np.uint16),
                       np.zeros((self.bh, 3, 8), np.uint16)]
        self.pal_sz_uv = [np.zeros(self.bw, np.uint8),
                          np.zeros(self.bh, np.uint8)]
        self.bx = 0
        self.by = 0
        self.dbg = False

    def _init_quant_tables(self, qidx):
        f = self.f
        hbd = self.seq.hbd
        n = 8 if f.segmentation_enabled else 1
        dq = []
        for i in range(n):
            yac = iclip_u8(qidx + f.seg_data.d[i].delta_q) \
                if f.segmentation_enabled else qidx
            ydc = iclip_u8(yac + f.quant_ydc_delta)
            uac = iclip_u8(yac + f.quant_uac_delta)
            udc = iclip_u8(yac + f.quant_udc_delta)
            vac = iclip_u8(yac + f.quant_vac_delta)
            vdc = iclip_u8(yac + f.quant_vdc_delta)
            dq.append(((int(T_DQ[hbd][ydc][0]), int(T_DQ[hbd][yac][1])),
                       (int(T_DQ[hbd][udc][0]), int(T_DQ[hbd][uac][1])),
                       (int(T_DQ[hbd][vdc][0]), int(T_DQ[hbd][vac][1]))))
        while len(dq) < 8:
            dq.append(dq[0])
        return dq

    # ---- main walk ----
    def code_tile(self):
        for by in range(self.row_start, self.row_end, self.sb_step):
            self.by = by
            self.code_sbrow()

    def code_sbrow(self):
        self.l.reset(self.keyframe)
        by = self.by
        if self.rf is not None and self.rf.use_ref_frame_mvs:
            # dav1d decode.c:3263 (single-thread per-sbrow motion-field load;
            # idempotent across tile columns)
            self.rf.load_tmvs_rows(0, self.rf.iw8, by >> 1,
                                   (by + self.sb_step) >> 1)
        for bx in range(self.col_start, self.col_end, self.sb_step):
            self.bx = bx
            self.cur_sb_cdef_idx = [-1, -1, -1, -1]
            self._read_lr_for_sb(bx, by)
            self.decode_sb(self.root_bl, bx, by,
                           INTRA_EDGE_TREE[self.root_bl])
            self.cdef_idx.append((bx, by, tuple(self.cur_sb_cdef_idx)))

    def _a(self, bx4_abs):
        """above context holder for absolute 4px col (per 128px column)."""
        return self.a_arr[(bx4_abs - (self.col_start & ~31)) >> 5]

    def decode_sb(self, bl, bx, by, node):
        hsz = 16 >> bl
        have_h_split = self.bw > bx + hsz
        have_v_split = self.bh > by + hsz
        ec = self.ec

        if not have_h_split and not have_v_split:
            assert bl < BL_8X8
            return self.decode_sb(bl + 1, bx, by, node.split[0])

        bx8 = (bx & 31) >> 1
        by8 = (by & 31) >> 1
        a = self._a(bx)
        ctx = ((int(a.partition[bx8]) >> (4 - bl)) & 1) + \
              (((int(self.l.partition[by8]) >> (4 - bl)) & 1) << 1)
        pc = self.cdf.m["partition"][bl][ctx]

        illegal_422 = (PARTITION_V, PARTITION_V4, PARTITION_T_LEFT_SPLIT,
                       PARTITION_T_RIGHT_SPLIT)
        if have_h_split and have_v_split:
            if not ec.is_decode and self.layout == PIXEL_LAYOUT_I422:
                # encode: remap partitions dav1d rejects for 4:2:2
                # (decode.c:2195) to SPLIT
                bp = ec.policy("part", int(T_PART_COUNT[bl]))
                if bp in illegal_422:
                    bp = PARTITION_SPLIT
                ec.e.put_symbol_adapt(bp, pc, int(T_PART_COUNT[bl]))
            else:
                bp = ec.sym("part", pc, int(T_PART_COUNT[bl]))
            if self.dbg:
                print(f"poc=0,y={by},x={bx},bl={bl},ctx={ctx},bp={bp}: "
                      f"r={ec.rng}")
            if self.layout == PIXEL_LAYOUT_I422 and bp in illegal_422:
                raise ValueError("illegal partition for 4:2:2")
            b = T_BLOCK_SIZES[bl][bp]
            if bp == PARTITION_NONE:
                self.decode_b(bl, int(b[0]), bp, bx, by, node.o)
            elif bp == PARTITION_H:
                self.decode_b(bl, int(b[0]), bp, bx, by, node.h[0])
                self.decode_b(bl, int(b[0]), bp, bx, by + hsz, node.h[1])
            elif bp == PARTITION_V:
                self.decode_b(bl, int(b[0]), bp, bx, by, node.v[0])
                self.decode_b(bl, int(b[0]), bp, bx + hsz, by, node.v[1])
            elif bp == PARTITION_SPLIT:
                if bl == BL_8X8:
                    tip = node
                    self.decode_b(bl, BS_4x4, bp, bx, by, EDGE_ALL_TR_AND_BL)
                    self.decode_b(bl, BS_4x4, bp, bx + 1, by, tip.split[0])
                    self.decode_b(bl, BS_4x4, bp, bx, by + 1, tip.split[1])
                    self.decode_b(bl, BS_4x4, bp, bx + 1, by + 1,
                                  tip.split[2])
                else:
                    self.decode_sb(bl + 1, bx, by, node.split[0])
                    self.decode_sb(bl + 1, bx + hsz, by, node.split[1])
                    self.decode_sb(bl + 1, bx, by + hsz, node.split[2])
                    self.decode_sb(bl + 1, bx + hsz, by + hsz, node.split[3])
            elif bp == PARTITION_T_TOP_SPLIT:
                self.decode_b(bl, int(b[0]), bp, bx, by, EDGE_ALL_TR_AND_BL)
                self.decode_b(bl, int(b[0]), bp, bx + hsz, by, node.v[1])
                self.decode_b(bl, int(b[1]), bp, bx, by + hsz, node.h[1])
            elif bp == PARTITION_T_BOTTOM_SPLIT:
                self.decode_b(bl, int(b[0]), bp, bx, by, node.h[0])
                self.decode_b(bl, int(b[1]), bp, bx, by + hsz, node.v[0])
                self.decode_b(bl, int(b[1]), bp, bx + hsz, by + hsz, 0)
            elif bp == PARTITION_T_LEFT_SPLIT:
                self.decode_b(bl, int(b[0]), bp, bx, by, EDGE_ALL_TR_AND_BL)
                self.decode_b(bl, int(b[0]), bp, bx, by + hsz, node.h[1])
                self.decode_b(bl, int(b[1]), bp, bx + hsz, by, node.v[1])
            elif bp == PARTITION_T_RIGHT_SPLIT:
                self.decode_b(bl, int(b[0]), bp, bx, by, node.v[0])
                self.decode_b(bl, int(b[1]), bp, bx + hsz, by, node.h[0])
                self.decode_b(bl, int(b[1]), bp, bx + hsz, by + hsz, 0)
            elif bp == PARTITION_H4:
                q = hsz >> 1
                self.decode_b(bl, int(b[0]), bp, bx, by, node.h[0])
                self.decode_b(bl, int(b[0]), bp, bx, by + q, node.h4)
                self.decode_b(bl, int(b[0]), bp, bx, by + 2 * q,
                              EDGE_ALL_LEFT_HAS_BOTTOM)
                if by + 3 * q < self.bh:
                    self.decode_b(bl, int(b[0]), bp, bx, by + 3 * q,
                                  node.h[1])
            elif bp == PARTITION_V4:
                q = hsz >> 1
                self.decode_b(bl, int(b[0]), bp, bx, by, node.v[0])
                self.decode_b(bl, int(b[0]), bp, bx + q, by, node.v4)
                self.decode_b(bl, int(b[0]), bp, bx + 2 * q, by,
                              EDGE_ALL_TOP_HAS_RIGHT)
                if bx + 3 * q < self.bw:
                    self.decode_b(bl, int(b[0]), bp, bx + 3 * q, by,
                                  node.v[1])
            else:
                raise AssertionError(bp)
        elif have_h_split:
            is_split = ec.boolp("part_split", self._gather_top_prob(pc, bl))
            if self.dbg:
                print(f"poc=0,y={by},x={bx},bl={bl},ctx={ctx},"
                      f"bp={3 if is_split else 1}: r={ec.rng}")
            assert bl < BL_8X8
            if is_split:
                bp = PARTITION_SPLIT
                self.decode_sb(bl + 1, bx, by, node.split[0])
                self.decode_sb(bl + 1, bx + hsz, by, node.split[1])
            else:
                bp = PARTITION_H
                self.decode_b(bl, int(T_BLOCK_SIZES[bl][PARTITION_H][0]),
                              PARTITION_H, bx, by, node.h[0])
        else:
            if not ec.is_decode and self.layout == PIXEL_LAYOUT_I422:
                # vertical-only split in 4:2:2 must split (decode.c:2400)
                ec.e.put_bool(1, self._gather_left_prob(pc, bl))
                is_split = 1
            else:
                is_split = ec.boolp("part_split",
                                    self._gather_left_prob(pc, bl))
            if self.dbg:
                print(f"poc=0,y={by},x={bx},bl={bl},ctx={ctx},"
                      f"bp={3 if is_split else 2}: r={ec.rng}")
            if self.layout == PIXEL_LAYOUT_I422 and not is_split:
                raise ValueError("illegal partition for 4:2:2")
            assert bl < BL_8X8
            if is_split:
                bp = PARTITION_SPLIT
                self.decode_sb(bl + 1, bx, by, node.split[0])
                self.decode_sb(bl + 1, bx, by + hsz, node.split[2])
            else:
                bp = PARTITION_V
                self.decode_b(bl, int(T_BLOCK_SIZES[bl][PARTITION_V][0]),
                              PARTITION_V, bx, by, node.v[0])

        if bp != PARTITION_SPLIT or bl == BL_8X8:
            n = hsz
            a.partition[bx8:bx8 + n] = T_AL_PART_CTX[0][bl][bp]
            self.l.partition[by8:by8 + n] = T_AL_PART_CTX[1][bl][bp]
        return 0

    @staticmethod
    def _gather_top_prob(pc, bl):
        out = int(pc[PARTITION_V - 1]) - int(pc[PARTITION_T_TOP_SPLIT])
        out += int(pc[PARTITION_T_LEFT_SPLIT - 1])
        if bl != BL_128X128:
            out += int(pc[PARTITION_V4 - 1]) - int(pc[PARTITION_T_RIGHT_SPLIT])
        return out

    @staticmethod
    def _gather_left_prob(pc, bl):
        out = int(pc[PARTITION_H - 1]) - int(pc[PARTITION_H])
        out += int(pc[PARTITION_SPLIT - 1]) - int(pc[PARTITION_T_LEFT_SPLIT])
        if bl != BL_128X128:
            out += int(pc[PARTITION_H4 - 1]) - int(pc[PARTITION_H4])
        return out

    # ---- block ----
    def decode_b(self, bl, bs, bp, bx, by, edge_flags=0):
        ec = self.ec
        f = self.f
        cdfm = self.cdf.m
        b = Av1Block()
        b.bl, b.bp, b.bs = bl, bp, bs
        b.bx, b.by = bx, by
        b.edge_flags = edge_flags
        b_dim = T_BLOCK_DIM[bs]
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        bx4, by4 = bx & 31, by & 31
        ss_ver, ss_hor = self.ss_ver, self.ss_hor
        cbx4, cby4 = bx4 >> ss_hor, by4 >> ss_ver
        w4 = min(bw4, self.bw - bx)
        h4 = min(bh4, self.bh - by)
        cbw4 = (bw4 + ss_hor) >> ss_hor
        cbh4 = (bh4 + ss_ver) >> ss_ver
        have_left = bx > self.col_start
        have_top = by > self.row_start
        has_chroma = (not self.monochrome and
                      (bw4 > ss_hor or bx & 1) and (bh4 > ss_ver or by & 1))
        a = self._a(bx)
        l = self.l

        inter_frame = not self.keyframe

        # segment_id (dav1d decode.c:851-906)
        seg = None
        seg_pred = 0
        if f.segmentation_enabled:
            if not f.segmentation_update_map:
                b.seg_id = self._prev_seg_id(bx, by, w4, h4)
                seg = f.seg_data.d[b.seg_id]
            elif f.seg_data.preskip:
                if f.segmentation_temporal:
                    spctx = int(a.seg_pred[bx4]) + int(self.l.seg_pred[by4])
                    seg_pred = ec.bool_adapt("seg_pred",
                                             self.cdf.m["seg_pred"][spctx])
                if seg_pred:
                    b.seg_id = self._prev_seg_id(bx, by, w4, h4)
                else:
                    b.seg_id = self._read_seg_id(bx, by, w4, h4, have_top,
                                                 have_left)
                seg = f.seg_data.d[b.seg_id]
        else:
            b.seg_id = 0

        # skip_mode (dav1d decode.c:908-919)
        if (seg is None or (not seg.globalmv and seg.ref == -1 and
                            not seg.skip)) and f.skip_mode_enabled and \
                min(bw4, bh4) > 1:
            smctx = int(a.skip_mode[bx4]) + int(l.skip_mode[by4])
            b.skip_mode = ec.bool_adapt("skip_mode", cdfm["skip_mode"][smctx])
        else:
            b.skip_mode = 0

        # skip
        if b.skip_mode or (seg is not None and seg.skip):
            b.skip = 1
        else:
            sctx = int(a.skip[bx4]) + int(l.skip[by4])
            b.skip = ec.bool_adapt("skip", cdfm["skip"][sctx])
            if self.dbg:
                print(f"Post-skip[{b.skip}]: r={ec.rng}")

        # segment_id post-skip
        if f.segmentation_enabled and f.segmentation_update_map and \
                not f.seg_data.preskip:
            if not b.skip and f.segmentation_temporal:
                spctx = int(a.seg_pred[bx4]) + int(self.l.seg_pred[by4])
                seg_pred = ec.bool_adapt("seg_pred",
                                         self.cdf.m["seg_pred"][spctx])
            if not b.skip and seg_pred:
                b.seg_id = self._prev_seg_id(bx, by, w4, h4)
            else:
                seg_ctx, pred_seg_id = self._cur_seg_ctx(bx, by, have_top,
                                                         have_left)
                if b.skip:
                    b.seg_id = pred_seg_id
                else:
                    b.seg_id = self._read_seg_id(bx, by, w4, h4, have_top,
                                                 have_left)
            seg = f.seg_data.d[b.seg_id]
        elif not f.segmentation_enabled:
            b.seg_id = 0

        if self.seg_map is not None and f.segmentation_update_map:
            self.seg_map[by:by + h4, bx:bx + w4] = b.seg_id

        # cdef index (always walked; reads 0 bits when cdef.n_bits == 0)
        if not b.skip:
            idx = (((bx & 16) >> 4) + ((by & 16) >> 3)) if self.sb128 else 0
            if self.cur_sb_cdef_idx[idx] == -1:
                v = ec.bools("cdef_idx", f.cdef_n_bits)
                self.cur_sb_cdef_idx[idx] = v
                if bw4 > 16:
                    self.cur_sb_cdef_idx[idx + 1] = v
                if bh4 > 16:
                    self.cur_sb_cdef_idx[idx + 2] = v
                if bw4 == 32 and bh4 == 32:
                    self.cur_sb_cdef_idx[idx + 3] = v

        # delta q/lf
        mask = 31 >> (0 if self.sb128 else 1)
        if not (bx & mask) and not (by & mask):
            self._read_delta_q_lf(b, bs)
        b.qidx = self.last_qidx

        # intra/inter determination (dav1d decode.c:1067-1086)
        if b.skip_mode:
            b.intra = 0
        elif inter_frame:
            if seg is not None and (seg.ref >= 0 or seg.globalmv):
                b.intra = int(not seg.ref)
            else:
                ictx = get_intra_ctx(a, l, by4, bx4, have_top, have_left)
                b.intra = 1 - ec.bool_adapt("is_inter", cdfm["intra"][ictx])
                if self.dbg:
                    print(f"Post-intra[{b.intra}]: r={ec.rng}")
        elif f.allow_intrabc:
            if ec.is_decode:
                b.intra = 1 - ec.bool_adapt("intrabc", cdfm["intrabc"])
            else:
                # encode: only choose intrabc when the zero-residual
                # prediction is clippable to a valid source area
                want = ec.policy("intrabc", 1) and \
                    self._intrabc_clip(
                        self._intrabc_pred_mv(bs, bx, by, edge_flags),
                        bs, bx, by, has_chroma) is not None
                ec.e.put_bool_adapt(1 if want else 0, cdfm["intrabc"])
                b.intra = 0 if want else 1
            if self.dbg:
                print(f"Post-intrabcflag[{b.intra}]: r={ec.rng}")
        else:
            b.intra = 1

        if not b.intra:
            if self.keyframe:
                self._intrabc_block(b, bs, bx, by, w4, h4, edge_flags,
                                    seg_pred, has_chroma)
            else:
                self._inter_block(b, bl, bs, bx, by, w4, h4, edge_flags,
                                  seg, seg_pred, have_top, have_left)
            self.blocks.append(b)
            return 0

        b.lflvl4 = self._calc_lflvl(b.seg_id, 0, 0)

        # y mode
        if inter_frame:
            ymode_cdf = cdfm["y_mode"][int(T_YMODE_SIZE_CTX[bs])]
        else:
            ymode_cdf = self.cdf.kfym[
                T_INTRA_MODE_CTX[a.mode[bx4]]][T_INTRA_MODE_CTX[l.mode[by4]]]
        b.y_mode = ec.sym("ymode", ymode_cdf, N_INTRA_PRED_MODES - 1)
        if self.dbg:
            print(f"Post-ymode[{b.y_mode}]: r={ec.rng}")

        # y angle
        if int(b_dim[2]) + int(b_dim[3]) >= 2 and \
                VERT_PRED <= b.y_mode <= VERT_LEFT_PRED:
            acdf = cdfm["angle_delta"][b.y_mode - VERT_PRED]
            b.y_angle = ec.sym("yangle", acdf, 6) - 3
        else:
            b.y_angle = 0

        if has_chroma:
            lossless = f.segmentation_lossless[b.seg_id]
            cfl_allowed = (cbw4 == 1 and cbh4 == 1) if lossless else \
                bs in CFL_ALLOWED
            uvmode_cdf = cdfm["uv_mode"][int(cfl_allowed)][b.y_mode]
            # n_symbols = N_UV_INTRA_PRED_MODES-1-(not cfl_allowed)
            b.uv_mode = ec.sym("uvmode", uvmode_cdf,
                               13 if cfl_allowed else 12)
            if self.dbg:
                print(f"Post-uvmode[{b.uv_mode}]: r={ec.rng}")
            b.uv_angle = 0
            if b.uv_mode == CFL_PRED:
                sign = ec.sym("cfl_sign", cdfm["cfl_sign"], 7) + 1
                sign_u = sign * 0x56 >> 8
                sign_v = sign - sign_u * 3
                if sign_u:
                    ctx = (sign_u == 2) * 3 + sign_v
                    alpha = ec.sym("cfl_alpha",
                                   cdfm["cfl_alpha"][ctx], 15) + 1
                    b.cfl_alpha[0] = -alpha if sign_u == 1 else alpha
                else:
                    b.cfl_alpha[0] = 0
                if sign_v:
                    ctx = (sign_v == 2) * 3 + sign_u
                    alpha = ec.sym("cfl_alpha",
                                   cdfm["cfl_alpha"][ctx], 15) + 1
                    b.cfl_alpha[1] = -alpha if sign_v == 1 else alpha
                else:
                    b.cfl_alpha[1] = 0
            elif int(b_dim[2]) + int(b_dim[3]) >= 2 and \
                    VERT_PRED <= b.uv_mode <= VERT_LEFT_PRED:
                acdf = cdfm["angle_delta"][b.uv_mode - VERT_PRED]
                b.uv_angle = ec.sym("uvangle", acdf, 6) - 3
        else:
            b.uv_mode = DC_PRED
            b.uv_angle = 0

        # palette (dav1d decode.c:1155-1179)
        b.pal_sz = [0, 0]
        if f.allow_screen_content_tools and max(bw4, bh4) <= 16 and \
                bw4 + bh4 >= 4:
            sz_ctx = int(b_dim[2]) + int(b_dim[3]) - 2
            if b.y_mode == DC_PRED:
                pal_ctx = int(a.pal_sz[bx4] > 0) + int(l.pal_sz[by4] > 0)
                if ec.bool_adapt("pal_y", cdfm["pal_y"][sz_ctx][pal_ctx]):
                    self._read_pal_plane(b, 0, sz_ctx, bx, by)
                if self.dbg:
                    print(f"Post-y_pal[{int(b.pal_sz[0] > 0)}]: r={ec.rng}")
            if has_chroma and b.uv_mode == DC_PRED:
                pal_ctx = int(b.pal_sz[0] > 0)
                if ec.bool_adapt("pal_uv", cdfm["pal_uv"][pal_ctx]):
                    self._read_pal_plane(b, 1, sz_ctx, bx, by)
                    self._read_pal_v(b)
                if self.dbg:
                    print(f"Post-uv_pal[{int(b.pal_sz[1] > 0)}]: "
                          f"r={ec.rng}")

        # filter intra
        if b.y_mode == DC_PRED and not b.pal_sz[0] and \
                max(int(b_dim[2]), int(b_dim[3])) <= 3 and \
                self.seq.filter_intra:
            is_filter = ec.bool_adapt("use_filter_intra",
                                      cdfm["use_filter_intra"][bs])
            if is_filter:
                b.y_mode = FILTER_PRED
                b.y_angle = ec.sym("filter_intra_mode",
                                   cdfm["filter_intra"], 4)

        # palette index maps (dav1d decode.c:1196-1222)
        if b.pal_sz[0]:
            b.pal_idx_y = self._read_pal_indices(b, 0, w4, h4, bw4, bh4)
            if self.dbg:
                print(f"Post-y-pal-indices: r={ec.rng}")
        if has_chroma and b.pal_sz[1]:
            cw4_ = (w4 + ss_hor) >> ss_hor
            ch4_ = (h4 + ss_ver) >> ss_ver
            b.pal_idx_uv = self._read_pal_indices(b, 1, cw4_, ch4_,
                                                  cbw4, cbh4)
            if self.dbg:
                print(f"Post-uv-pal-indices: r={ec.rng}")

        # tx size
        lossless = f.segmentation_lossless[b.seg_id]
        if lossless:
            b.tx = b.uvtx = TX_4X4
            t_dim = T_TXFM[TX_4X4]
        else:
            b.tx = int(T_MAX_TX[bs][0])
            b.uvtx = int(T_MAX_TX[bs][self.layout])
            t_dim = T_TXFM[b.tx]
            if f.txfm_mode == TX_SWITCHABLE and int(t_dim[5]) > TX_4X4:
                tctx = (int(l.tx_intra[by4]) >= int(t_dim[3])) + \
                       (int(a.tx_intra[bx4]) >= int(t_dim[2]))
                tx_cdf = cdfm["txsz"][int(t_dim[5]) - 1][tctx]
                depth = ec.sym("txsz", tx_cdf, min(int(t_dim[5]), 2))
                for _ in range(depth):
                    b.tx = int(t_dim[6])  # sub
                    t_dim = T_TXFM[b.tx]
            if self.dbg:
                print(f"Post-tx[{b.tx}]: r={ec.rng}")

        # coefficient blocks (read_coef_blocks order)
        b.coef_lo = len(self.coefs)
        self._read_coef_blocks(b, bs, bx, by, w4, h4, has_chroma)
        b.coef_hi = len(self.coefs)

        # context updates
        y_mode_nofilt = DC_PRED if b.y_mode == FILTER_PRED else b.y_mode
        lw, lh = int(t_dim[2]), int(t_dim[3])
        l.tx_intra[by4:by4 + bh4] = lh
        l.tx[by4:by4 + bh4] = lh
        a.tx_intra[bx4:bx4 + bw4] = lw
        a.tx[bx4:bx4 + bw4] = lw
        l.mode[by4:by4 + bh4] = y_mode_nofilt
        a.mode[bx4:bx4 + bw4] = y_mode_nofilt
        l.pal_sz[by4:by4 + bh4] = b.pal_sz[0]
        a.pal_sz[bx4:bx4 + bw4] = b.pal_sz[0]
        self.pal_sz_uv[0][bx:bx + bw4] = b.pal_sz[1] if has_chroma else 0
        self.pal_sz_uv[1][by:by + bh4] = b.pal_sz[1] if has_chroma else 0
        if b.pal_sz[0]:
            # dav1d recon copy_pal_block_y (al_pal splat over block extent)
            self.al_pal[0][bx:bx + bw4, 0] = b.pal[0]
            self.al_pal[1][by:by + bh4, 0] = b.pal[0]
        if has_chroma and b.pal_sz[1]:
            for pl in (1, 2):
                self.al_pal[0][bx:bx + bw4, pl] = b.pal[pl]
                self.al_pal[1][by:by + bh4, pl] = b.pal[pl]
        l.seg_pred[by4:by4 + bh4] = seg_pred
        a.seg_pred[bx4:bx4 + bw4] = seg_pred
        l.skip_mode[by4:by4 + bh4] = 0
        a.skip_mode[bx4:bx4 + bw4] = 0
        l.intra[by4:by4 + bh4] = 1
        a.intra[bx4:bx4 + bw4] = 1
        l.skip[by4:by4 + bh4] = b.skip
        a.skip[bx4:bx4 + bw4] = b.skip
        if inter_frame:
            l.comp_type[by4:by4 + bh4] = COMP_INTER_NONE
            a.comp_type[bx4:bx4 + bw4] = COMP_INTER_NONE
            l.ref[0][by4:by4 + bh4] = -1
            l.ref[1][by4:by4 + bh4] = -1
            a.ref[0][bx4:bx4 + bw4] = -1
            a.ref[1][bx4:bx4 + bw4] = -1
            l.filter[0][by4:by4 + bh4] = N_SWITCHABLE_FILTERS
            l.filter[1][by4:by4 + bh4] = N_SWITCHABLE_FILTERS
            a.filter[0][bx4:bx4 + bw4] = N_SWITCHABLE_FILTERS
            a.filter[1][bx4:bx4 + bw4] = N_SWITCHABLE_FILTERS
        if has_chroma:
            l.uvmode[cby4:cby4 + cbh4] = b.uv_mode
            a.uvmode[cbx4:cbx4 + cbw4] = b.uv_mode
        if inter_frame or f.allow_intrabc:
            # dav1d decode.c splat_intraref:596
            from .refmvs import INVALID
            self.rf.splat_mv(by, bx, bw4, bh4, 0, -1,
                             (INVALID, INVALID), (INVALID, INVALID), bs, 0)

        self.blocks.append(b)
        return 0

    def _cur_seg_ctx(self, bx, by, have_top, have_left):
        sm = self.seg_map
        if have_left and have_top:
            lv = int(sm[by, bx - 1])
            av = int(sm[by - 1, bx])
            al = int(sm[by - 1, bx - 1])
            if lv == av and al == lv:
                ctx = 2
            elif lv == av or al == lv or av == al:
                ctx = 1
            else:
                ctx = 0
            return ctx, (av if av == al else lv)
        ctx = 0
        if have_left:
            return ctx, int(sm[by, bx - 1])
        if have_top:
            return ctx, int(sm[by - 1, bx])
        return ctx, 0

    def _read_seg_id(self, bx, by, w4, h4, have_top, have_left):
        ec = self.ec
        f = self.f
        seg_ctx, pred_seg_id = self._cur_seg_ctx(bx, by, have_top, have_left)
        diff = ec.sym("seg_id", self.cdf.m["seg_id"][seg_ctx], 7)
        last_active = f.seg_data.last_active_segid
        # dav1d stores into a uint8 before the range checks (decode.c:892)
        seg_id = _neg_deinterleave(diff, pred_seg_id, last_active + 1) & 0xFF
        if seg_id > last_active or seg_id >= 8:
            seg_id = 0
        return seg_id

    # ---- palette (dav1d recon_tmpl.c dav1d_read_pal_plane:2223,
    # dav1d_read_pal_uv:2329; decode.c read_pal_indices:442)
    def _read_pal_plane(self, b, pl, sz_ctx, bx, by):
        ec = self.ec
        pal_sz = ec.sym("pal_sz", self.cdf.m["pal_sz"][pl][sz_ctx], 6) + 2
        b.pal_sz[pl] = pal_sz
        bpc = self.seq.bitdepth
        l_cache = int(self.pal_sz_uv[1][by]) if pl else \
            int(self.l.pal_sz[by & 31])
        a_cache = 0
        if by & 15:
            a_cache = int(self.pal_sz_uv[0][bx]) if pl else \
                int(self._a(bx).pal_sz[bx & 31])
        lpal = self.al_pal[1][by, pl]
        apal = self.al_pal[0][bx, pl]

        cache = []
        li = ai = 0
        while l_cache and a_cache:
            lv, av = int(lpal[li]), int(apal[ai])
            if lv < av:
                if not cache or cache[-1] != lv:
                    cache.append(lv)
                li += 1
                l_cache -= 1
            else:
                if av == lv:
                    li += 1
                    l_cache -= 1
                if not cache or cache[-1] != av:
                    cache.append(av)
                ai += 1
                a_cache -= 1
        while l_cache > 0:
            v = int(lpal[li])
            li += 1
            l_cache -= 1
            if not cache or cache[-1] != v:
                cache.append(v)
        while a_cache > 0:
            v = int(apal[ai])
            ai += 1
            a_cache -= 1
            if not cache or cache[-1] != v:
                cache.append(v)

        used = []
        for v in cache:
            if len(used) >= pal_sz:
                break
            if ec.equi("pal_use_cache"):
                used.append(v)
        n_used = len(used)

        if n_used < pal_sz:
            newv = []
            prev = ec.bools("pal_color", bpc)
            newv.append(prev)
            i = n_used + 1
            if i < pal_sz:
                bits = bpc - 3 + ec.bools("pal_delta_bits", 2)
                mx = (1 << bpc) - 1
                add1 = 0 if pl else 1
                while i < pal_sz:
                    delta = ec.bools("pal_delta", bits)
                    prev = min(prev + delta + add1, mx)
                    newv.append(prev)
                    i += 1
                    if prev + add1 >= mx:
                        while i < pal_sz:
                            newv.append(mx)
                            i += 1
                        break
                    from ..utils.intops import ulog2
                    bits = min(bits, 1 + ulog2(mx - prev - add1))
            # sorted merge of reused cache entries and new entries
            out = []
            n = m = 0
            for _ in range(pal_sz):
                if n < n_used and (m >= len(newv) or used[n] <= newv[m]):
                    out.append(used[n])
                    n += 1
                else:
                    out.append(newv[m])
                    m += 1
        else:
            out = used
        pal = np.zeros(8, np.uint16)
        pal[:len(out)] = out
        b.pal[pl] = pal
        if self.dbg:
            print(f"Post-pal[pl={pl},sz={pal_sz}]: r={ec.rng}, "
                  f"pal={out}")

    def _read_pal_v(self, b):
        ec = self.ec
        bpc = self.seq.bitdepth
        pal_sz = b.pal_sz[1]
        out = []
        if ec.equi("pal_v_use_delta"):
            bits = bpc - 4 + ec.bools("pal_delta_bits", 2)
            prev = ec.bools("pal_color", bpc)
            out.append(prev)
            mx = (1 << bpc) - 1
            for _ in range(1, pal_sz):
                delta = ec.bools("pal_delta", bits)
                if delta and ec.equi("pal_v_sign"):
                    delta = -delta
                prev = (prev + delta) & mx
                out.append(prev)
        else:
            for _ in range(pal_sz):
                out.append(ec.bools("pal_color", bpc))
        pal = np.zeros(8, np.uint16)
        pal[:len(out)] = out
        b.pal[2] = pal
        if self.dbg:
            print(f"Post-pal[pl=2]: r={ec.rng} {out}")

    def _read_pal_indices(self, b, pl, w4, h4, bw4, bh4):
        ec = self.ec
        pal_sz = b.pal_sz[pl]
        tmp = np.zeros((bh4 * 4, bw4 * 4), np.uint8)
        tmp[0, 0] = ec.uniform("pal_idx0", pal_sz)
        cmap_cdf = self.cdf.m["color_map"][pl][pal_sz - 2]
        for i in range(1, 4 * (w4 + h4) - 1):
            first = min(i, w4 * 4 - 1)
            last = max(0, i - h4 * 4 + 1)
            have_top = i > first
            m = 0
            for j in range(first, last - 1, -1):
                have_left = j > 0
                y, x = i - j, j
                order = []
                mask = 0

                def add(v):
                    nonlocal mask
                    order.append(int(v))
                    mask |= 1 << int(v)

                if not have_left:
                    ctx = 0
                    add(tmp[y - 1, x])
                elif not have_top:
                    ctx = 0
                    add(tmp[y, x - 1])
                else:
                    lv = int(tmp[y, x - 1])
                    tv = int(tmp[y - 1, x])
                    tl = int(tmp[y - 1, x - 1])
                    same_t_l = tv == lv
                    same_t_tl = tv == tl
                    same_l_tl = lv == tl
                    if same_t_l and same_t_tl and same_l_tl:
                        ctx = 4
                        add(tv)
                    elif same_t_l:
                        ctx = 3
                        add(tv)
                        add(tl)
                    elif same_t_tl or same_l_tl:
                        ctx = 2
                        add(tl)
                        add(lv if same_t_tl else tv)
                    else:
                        ctx = 1
                        add(min(tv, lv))
                        add(max(tv, lv))
                        add(tl)
                for bit in range(8):
                    if not (mask & (1 << bit)):
                        order.append(bit)
                color_idx = ec.sym("color_map", cmap_cdf[ctx], pal_sz - 1)
                tmp[y, x] = order[color_idx]
                m += 1
                have_top = True
        # dav1d pal.c pal_idx_finish: replicate last col/row into padding
        if w4 < bw4:
            tmp[:, w4 * 4:] = tmp[:, w4 * 4 - 1:w4 * 4]
        if h4 < bh4:
            tmp[h4 * 4:, :] = tmp[h4 * 4 - 1:h4 * 4, :]
        return tmp

    def _prev_seg_id(self, bx, by, w4, h4):
        """dav1d decode.c get_prev_frame_segid:528 (min over the block)."""
        if self.prev_segmap is None:
            return 0
        seg_id = int(self.prev_segmap[by:by + h4, bx:bx + w4].min())
        assert seg_id < 8
        return seg_id

    # ---- inter block (dav1d decode.c:1421-1975) ----
    def _inter_block(self, b, bl, bs, bx, by, w4, h4, edge_flags, seg,
                     seg_pred, have_top, have_left):
        from .refmvs import (refmvs_find, fix_mv_precision, get_gmv_2d,
                             WM_TYPE_TRANSLATION)
        ec = self.ec
        f = self.f
        seq = self.seq
        cdfm = self.cdf.m
        a = self._a(bx)
        l = self.l
        b_dim = T_BLOCK_DIM[b.bs]
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        bx4, by4 = bx & 31, by & 31
        ss_ver, ss_hor = self.ss_ver, self.ss_hor
        cbx4, cby4 = bx4 >> ss_hor, by4 >> ss_ver
        cbw4 = (bw4 + ss_hor) >> ss_hor
        cbh4 = (bh4 + ss_ver) >> ss_ver
        has_chroma = (not self.monochrome and
                      (bw4 > ss_hor or bx & 1) and (bh4 > ss_ver or by & 1))

        if b.skip_mode:
            is_comp = 1
        elif (seg is None or (seg.ref == -1 and not seg.globalmv and
                              not seg.skip)) and f.switchable_comp_refs and \
                min(bw4, bh4) > 1:
            cctx = get_comp_ctx(a, l, by4, bx4, have_top, have_left)
            is_comp = ec.bool_adapt("comp", cdfm["comp"][cctx])
            if self.dbg:
                print(f"Post-compflag[{is_comp}]: r={ec.rng}")
        else:
            is_comp = 0

        filter01 = [0, 0]
        if b.skip_mode:
            b.ref = [f.skip_mode_refs[0], f.skip_mode_refs[1]]
            b.comp_type = COMP_INTER_AVG
            b.inter_mode = NEARESTMV_NEARESTMV
            b.drl_idx = NEAREST_DRL
            has_subpel_filter = 0
            stack, n_mvs, mctx = refmvs_find(
                self.rf, self, (b.ref[0] + 1, b.ref[1] + 1), bs, edge_flags,
                by, bx)
            b.mv = [fix_mv_precision(f, stack[0][0]),
                    fix_mv_precision(f, stack[0][1])]
        elif is_comp:
            dctx = get_comp_dir_ctx(a, l, by4, bx4, have_top, have_left)
            if ec.bool_adapt("comp_dir", cdfm["comp_dir"][dctx]):
                # bidir
                c1 = get_fwd_ref_ctx(a, l, by4, bx4, have_top, have_left)
                if ec.bool_adapt("comp_fwd0", cdfm["comp_fwd_ref"][0][c1]):
                    c2 = get_fwd_ref_2_ctx(a, l, by4, bx4, have_top,
                                           have_left)
                    b.ref[0] = 2 + ec.bool_adapt("comp_fwd2",
                                                 cdfm["comp_fwd_ref"][2][c2])
                else:
                    c2 = get_fwd_ref_1_ctx(a, l, by4, bx4, have_top,
                                           have_left)
                    b.ref[0] = ec.bool_adapt("comp_fwd1",
                                             cdfm["comp_fwd_ref"][1][c2])
                c3 = get_bwd_ref_ctx(a, l, by4, bx4, have_top, have_left)
                if ec.bool_adapt("comp_bwd0", cdfm["comp_bwd_ref"][0][c3]):
                    b.ref[1] = 6
                else:
                    c4 = get_bwd_ref_1_ctx(a, l, by4, bx4, have_top,
                                           have_left)
                    b.ref[1] = 4 + ec.bool_adapt("comp_bwd1",
                                                 cdfm["comp_bwd_ref"][1][c4])
            else:
                # unidir
                uc = get_ref_ctx(a, l, by4, bx4, have_top, have_left)
                if ec.bool_adapt("comp_uni0", cdfm["comp_uni_ref"][0][uc]):
                    b.ref = [4, 6]
                else:
                    uc1 = get_uni_p1_ctx(a, l, by4, bx4, have_top, have_left)
                    b.ref[0] = 0
                    b.ref[1] = 1 + ec.bool_adapt("comp_uni1",
                                                 cdfm["comp_uni_ref"][1][uc1])
                    if b.ref[1] == 2:
                        uc2 = get_fwd_ref_2_ctx(a, l, by4, bx4, have_top,
                                                have_left)
                        b.ref[1] += ec.bool_adapt(
                            "comp_uni2", cdfm["comp_uni_ref"][2][uc2])
            if self.dbg:
                print(f"Post-refs[{b.ref[0]}/{b.ref[1]}]: r={ec.rng}")

            stack, n_mvs, mctx = refmvs_find(
                self.rf, self, (b.ref[0] + 1, b.ref[1] + 1), bs, edge_flags,
                by, bx)
            b.inter_mode = ec.sym("comp_inter_mode",
                                  cdfm["comp_inter_mode"][mctx],
                                  N_COMP_INTER_PRED_MODES - 1)
            if self.dbg:
                print(f"Post-compintermode[{b.inter_mode},ctx={mctx},"
                      f"n_mvs={n_mvs}]: r={ec.rng}")

            im = T_COMP_INTER_MODES[b.inter_mode]
            b.drl_idx = NEAREST_DRL
            if b.inter_mode == NEWMV_NEWMV:
                if n_mvs > 1:
                    dctx1 = get_drl_context(stack, 0)
                    b.drl_idx += ec.bool_adapt("drl", cdfm["drl_bit"][dctx1])
                    if b.drl_idx == NEARER_DRL and n_mvs > 2:
                        dctx2 = get_drl_context(stack, 1)
                        b.drl_idx += ec.bool_adapt("drl",
                                                   cdfm["drl_bit"][dctx2])
            elif int(im[0]) == NEARMV or int(im[1]) == NEARMV:
                b.drl_idx = NEARER_DRL
                if n_mvs > 2:
                    dctx2 = get_drl_context(stack, 1)
                    b.drl_idx += ec.bool_adapt("drl", cdfm["drl_bit"][dctx2])
                    if b.drl_idx == NEAR_DRL and n_mvs > 3:
                        dctx3 = get_drl_context(stack, 2)
                        b.drl_idx += ec.bool_adapt("drl",
                                                   cdfm["drl_bit"][dctx3])

            has_subpel_filter = min(bw4, bh4) == 1 or \
                b.inter_mode != GLOBALMV_GLOBALMV
            mv = [None, None]
            for idx in range(2):
                m = int(im[idx])
                if m in (NEARMV, NEARESTMV):
                    mv[idx] = fix_mv_precision(f, stack[b.drl_idx][idx])
                elif m == GLOBALMV:
                    has_subpel_filter |= \
                        f.gmv[b.ref[idx]].type == WM_TYPE_TRANSLATION
                    mv[idx] = get_gmv_2d(f.gmv[b.ref[idx]], bx, by, bw4, bh4,
                                         f)
                else:  # NEWMV
                    mv[idx] = self._read_mv_residual(
                        stack[b.drl_idx][idx], self.cdf.mv,
                        not f.force_integer_mv)
            b.mv = mv
            if self.dbg:
                print(f"Post-residual_mv[1:y={b.mv[0][0]},x={b.mv[0][1]},"
                      f"2:y={b.mv[1][0]},x={b.mv[1][1]}]: r={ec.rng}")

            # jnt_comp vs. seg vs. wedge
            is_segwedge = 0
            if seq.masked_compound:
                mkctx = get_mask_comp_ctx(a, l, by4, bx4)
                is_segwedge = ec.bool_adapt("mask_comp",
                                            cdfm["mask_comp"][mkctx])
            if not is_segwedge:
                if seq.jnt_comp:
                    jctx = get_jnt_comp_ctx(
                        seq.order_hint_n_bits, f.frame_offset,
                        self.ref_poc[b.ref[0]], self.ref_poc[b.ref[1]],
                        a, l, by4, bx4)
                    b.comp_type = COMP_INTER_WEIGHTED_AVG + \
                        ec.bool_adapt("jnt_comp", cdfm["jnt_comp"][jctx])
                else:
                    b.comp_type = COMP_INTER_AVG
            else:
                if bs in WEDGE_ALLOWED:
                    wctx = int(T_WEDGE_CTX[bs])
                    b.comp_type = COMP_INTER_WEDGE - \
                        ec.bool_adapt("wedge_comp", cdfm["wedge_comp"][wctx])
                    if b.comp_type == COMP_INTER_WEDGE:
                        b.wedge_idx = ec.sym("wedge_idx",
                                             cdfm["wedge_idx"][wctx], 15)
                else:
                    b.comp_type = COMP_INTER_SEG
                b.mask_sign = ec.equi("mask_sign")
        else:
            b.comp_type = COMP_INTER_NONE
            if seg is not None and seg.ref > 0:
                b.ref[0] = seg.ref - 1
            elif seg is not None and (seg.globalmv or seg.skip):
                b.ref[0] = 0
            else:
                c1 = get_ref_ctx(a, l, by4, bx4, have_top, have_left)
                if ec.bool_adapt("ref0", cdfm["ref"][0][c1]):
                    c2 = get_bwd_ref_ctx(a, l, by4, bx4, have_top, have_left)
                    if ec.bool_adapt("ref1", cdfm["ref"][1][c2]):
                        b.ref[0] = 6
                    else:
                        c3 = get_bwd_ref_1_ctx(a, l, by4, bx4, have_top,
                                               have_left)
                        b.ref[0] = 4 + ec.bool_adapt("ref5",
                                                     cdfm["ref"][5][c3])
                else:
                    c2 = get_fwd_ref_ctx(a, l, by4, bx4, have_top, have_left)
                    if ec.bool_adapt("ref2", cdfm["ref"][2][c2]):
                        c3 = get_fwd_ref_2_ctx(a, l, by4, bx4, have_top,
                                               have_left)
                        b.ref[0] = 2 + ec.bool_adapt("ref4",
                                                     cdfm["ref"][4][c3])
                    else:
                        c3 = get_fwd_ref_1_ctx(a, l, by4, bx4, have_top,
                                               have_left)
                        b.ref[0] = ec.bool_adapt("ref3", cdfm["ref"][3][c3])
                if self.dbg:
                    print(f"Post-ref[{b.ref[0]}]: r={ec.rng}")
            b.ref[1] = -1

            stack, n_mvs, mctx = refmvs_find(
                self.rf, self, (b.ref[0] + 1, -1), bs, edge_flags, by, bx)

            seg_force = seg is not None and (seg.skip or seg.globalmv)
            if seg_force or ec.bool_adapt("newmv_mode",
                                          cdfm["newmv_mode"][mctx & 7]):
                if seg_force or not ec.bool_adapt(
                        "globalmv_mode", cdfm["globalmv_mode"][(mctx >> 3)
                                                               & 1]):
                    b.inter_mode = GLOBALMV
                    b.mv = [get_gmv_2d(f.gmv[b.ref[0]], bx, by, bw4, bh4, f),
                            (0, 0)]
                    b.drl_idx = NEAREST_DRL
                    has_subpel_filter = min(bw4, bh4) == 1 or \
                        f.gmv[b.ref[0]].type == WM_TYPE_TRANSLATION
                else:
                    has_subpel_filter = 1
                    if ec.bool_adapt("refmv_mode",
                                     cdfm["refmv_mode"][(mctx >> 4) & 15]):
                        b.inter_mode = NEARMV
                        b.drl_idx = NEARER_DRL
                        if n_mvs > 2:
                            dctx2 = get_drl_context(stack, 1)
                            b.drl_idx += ec.bool_adapt(
                                "drl", cdfm["drl_bit"][dctx2])
                            if b.drl_idx == NEAR_DRL and n_mvs > 3:
                                dctx3 = get_drl_context(stack, 2)
                                b.drl_idx += ec.bool_adapt(
                                    "drl", cdfm["drl_bit"][dctx3])
                    else:
                        b.inter_mode = NEARESTMV
                        b.drl_idx = NEAREST_DRL
                    mv0 = stack[b.drl_idx][0]
                    if b.drl_idx < NEAR_DRL:
                        mv0 = fix_mv_precision(f, mv0)
                    b.mv = [mv0, (0, 0)]
                if self.dbg:
                    print(f"Post-intermode[{b.inter_mode},drl={b.drl_idx},"
                          f"mv=y:{b.mv[0][0]},x:{b.mv[0][1]},"
                          f"n_mvs={n_mvs}]: r={ec.rng}")
            else:
                has_subpel_filter = 1
                b.inter_mode = NEWMV
                b.drl_idx = NEAREST_DRL
                if n_mvs > 1:
                    dctx1 = get_drl_context(stack, 0)
                    b.drl_idx += ec.bool_adapt("drl", cdfm["drl_bit"][dctx1])
                    if b.drl_idx == NEARER_DRL and n_mvs > 2:
                        dctx2 = get_drl_context(stack, 1)
                        b.drl_idx += ec.bool_adapt("drl",
                                                   cdfm["drl_bit"][dctx2])
                if n_mvs > 1:
                    mv0 = stack[b.drl_idx][0]
                else:
                    assert b.drl_idx == 0
                    mv0 = fix_mv_precision(f, stack[0][0])
                if self.dbg:
                    print(f"Post-intermode[{b.inter_mode},"
                          f"drl={b.drl_idx}]: r={ec.rng}")
                mv0 = self._read_mv_residual(mv0, self.cdf.mv,
                                             not f.force_integer_mv)
                b.mv = [mv0, (0, 0)]
                if self.dbg:
                    print(f"Post-residualmv[mv=y:{b.mv[0][0]},"
                          f"x:{b.mv[0][1]}]: r={ec.rng}")

            # interintra
            ii_sz_grp = int(T_YMODE_SIZE_CTX[bs])
            if seq.inter_intra and bs in INTERINTRA_ALLOWED and \
                    ec.bool_adapt("interintra", cdfm["interintra"][ii_sz_grp]):
                b.interintra_mode = ec.sym(
                    "interintra_mode", cdfm["interintra_mode"][ii_sz_grp], 3)
                wctx = int(T_WEDGE_CTX[bs])
                b.interintra_type = INTER_INTRA_BLEND + ec.bool_adapt(
                    "interintra_wedge", cdfm["interintra_wedge"][wctx])
                if b.interintra_type == INTER_INTRA_WEDGE:
                    b.wedge_idx = ec.sym("wedge_idx", cdfm["wedge_idx"][wctx],
                                         15)
            else:
                b.interintra_type = INTER_INTRA_NONE

            # motion variation (OBMC / warp)
            if f.switchable_motion_mode and \
                    b.interintra_type == INTER_INTRA_NONE and \
                    min(bw4, bh4) >= 2 and \
                    not (not f.force_integer_mv and
                         b.inter_mode == GLOBALMV and
                         f.gmv[b.ref[0]].type > WM_TYPE_TRANSLATION) and \
                    ((have_left and _findoddzero(l.intra, by4 + 1, h4 >> 1))
                     or (have_top and _findoddzero(a.intra, bx4 + 1,
                                                   w4 >> 1))):
                masks = self._find_matching_ref(edge_flags, bw4, bh4, w4, h4,
                                                have_left, have_top,
                                                b.ref[0], bx, by)
                allow_warp = (not self.ref_scaled[b.ref[0]] and
                              not f.force_integer_mv and f.warp_motion and
                              (masks[0] | masks[1]))
                if allow_warp:
                    b.motion_mode = ec.sym("motion_mode",
                                           cdfm["motion_mode"][bs], 2)
                else:
                    b.motion_mode = ec.bool_adapt("obmc", cdfm["obmc"][bs])
                if b.motion_mode == MM_WARP:
                    has_subpel_filter = 0
                    b.warp = self._derive_warpmv(bw4, bh4, masks, b.mv[0],
                                                 bx, by)
                if self.dbg:
                    print(f"Post-motionmode[{b.motion_mode}]: r={ec.rng}")
            else:
                b.motion_mode = MM_TRANSLATION

        # subpel filter (dav1d decode.c:1877-1911)
        from .headers import FILTER_SWITCHABLE, FILTER_8TAP_REGULAR
        if f.subpel_filter_mode == FILTER_SWITCHABLE:
            if has_subpel_filter:
                comp = int(b.comp_type != COMP_INTER_NONE)
                fc1 = get_filter_ctx(a, l, comp, 0, b.ref[0], by4, bx4)
                filter01[0] = ec.sym("filter", cdfm["filter"][0][fc1],
                                     N_SWITCHABLE_FILTERS - 1)
                if seq.dual_filter:
                    fc2 = get_filter_ctx(a, l, comp, 1, b.ref[0], by4, bx4)
                    filter01[1] = ec.sym("filter", cdfm["filter"][1][fc2],
                                         N_SWITCHABLE_FILTERS - 1)
                else:
                    filter01[1] = filter01[0]
                if self.dbg:
                    print(f"Post-subpel_filter[{filter01[0]},"
                          f"{filter01[1]}]: r={ec.rng}")
            else:
                filter01 = [FILTER_8TAP_REGULAR, FILTER_8TAP_REGULAR]
        else:
            filter01 = [f.subpel_filter_mode, f.subpel_filter_mode]
        b.filter2d = int(T_FILTER_2D[filter01[1]][filter01[0]])

        self._read_vartx_tree(b, bs, bx4, by4, bx, by)

        # coefficients
        b.coef_lo = len(self.coefs)
        self._read_coef_blocks(b, bs, bx, by, w4, h4, has_chroma)
        b.coef_hi = len(self.coefs)

        is_globalmv = b.inter_mode == (GLOBALMV_GLOBALMV if is_comp
                                       else GLOBALMV)
        b.lflvl4 = self._calc_lflvl(b.seg_id, b.ref[0] + 1,
                                    0 if is_globalmv else 1)

        # refmvs splat (dav1d decode.c splat_oneref_mv:548/splat_tworef:579)
        if is_comp:
            mf = int(b.inter_mode == GLOBALMV_GLOBALMV) | \
                (2 if (1 << b.inter_mode) & 0xBC else 0)
            self.rf.splat_mv(by, bx, bw4, bh4, b.ref[0] + 1, b.ref[1] + 1,
                             b.mv[0], b.mv[1], bs, mf)
        else:
            mf = int(b.inter_mode == GLOBALMV and min(bw4, bh4) >= 2) | \
                (2 if b.inter_mode == NEWMV else 0)
            self.rf.splat_mv(by, bx, bw4, bh4, b.ref[0] + 1,
                             0 if b.interintra_type else -1,
                             b.mv[0], (0, 0), bs, mf)

        # context updates (dav1d decode.c:1949-1973)
        l.seg_pred[by4:by4 + bh4] = seg_pred
        a.seg_pred[bx4:bx4 + bw4] = seg_pred
        l.skip_mode[by4:by4 + bh4] = b.skip_mode
        a.skip_mode[bx4:bx4 + bw4] = b.skip_mode
        l.intra[by4:by4 + bh4] = 0
        a.intra[bx4:bx4 + bw4] = 0
        l.skip[by4:by4 + bh4] = b.skip
        a.skip[bx4:bx4 + bw4] = b.skip
        l.pal_sz[by4:by4 + bh4] = 0
        a.pal_sz[bx4:bx4 + bw4] = 0
        self.pal_sz_uv[0][bx:bx + bw4] = 0
        self.pal_sz_uv[1][by:by + bh4] = 0
        l.tx_intra[by4:by4 + bh4] = int(b_dim[3])
        a.tx_intra[bx4:bx4 + bw4] = int(b_dim[2])
        l.comp_type[by4:by4 + bh4] = b.comp_type
        a.comp_type[bx4:bx4 + bw4] = b.comp_type
        l.filter[0][by4:by4 + bh4] = filter01[0]
        l.filter[1][by4:by4 + bh4] = filter01[1]
        a.filter[0][bx4:bx4 + bw4] = filter01[0]
        a.filter[1][bx4:bx4 + bw4] = filter01[1]
        l.mode[by4:by4 + bh4] = b.inter_mode
        a.mode[bx4:bx4 + bw4] = b.inter_mode
        l.ref[0][by4:by4 + bh4] = b.ref[0]
        a.ref[0][bx4:bx4 + bw4] = b.ref[0]
        l.ref[1][by4:by4 + bh4] = b.ref[1]
        a.ref[1][bx4:bx4 + bw4] = b.ref[1]
        if has_chroma:
            l.uvmode[cby4:cby4 + cbh4] = DC_PRED
            a.uvmode[cbx4:cbx4 + cbw4] = DC_PRED

    def _derive_warpmv(self, bw4, bh4, masks, mv_yx, bx, by):
        """dav1d decode.c derive_warpmv:292."""
        from .warpmv import WarpParams, find_affine_int, get_shear_params
        rf = self.rf
        pts = []

        def add_sample(dx, dy, sx, sy, cy, cx):
            cbs = T_BLOCK_DIM[rf.bs[cy, cx]]
            ix = 16 * (2 * dx + sx * int(cbs[0])) - 8
            iy = 16 * (2 * dy + sy * int(cbs[1])) - 8
            ox = ix + int(rf.mv[cy, cx, 0, 1])
            oy = iy + int(rf.mv[cy, cx, 0, 0])
            pts.append(((ix, iy), (ox, oy)))

        if (masks[0] & 0xFFFFFFFF) == 1 and not (masks[1] >> 32):
            off = bx & (int(T_BLOCK_DIM[rf.bs[by - 1, bx]][0]) - 1)
            add_sample(-off, 0, 1, -1, by - 1, bx)
        else:
            off = 0
            xmask = masks[0] & 0xFFFFFFFF
            while len(pts) < 8 and xmask:
                tz = (xmask & -xmask).bit_length() - 1
                off += tz
                xmask >>= tz
                add_sample(off, 0, 1, -1, by - 1, bx + off)
                xmask &= ~1
        if len(pts) < 8 and masks[1] == 1:
            off = by & (int(T_BLOCK_DIM[rf.bs[by, bx - 1]][1]) - 1)
            add_sample(0, -off, -1, 1, by - off, bx - 1)
        else:
            off = 0
            ymask = masks[1] & 0xFFFFFFFF
            while len(pts) < 8 and ymask:
                tz = (ymask & -ymask).bit_length() - 1
                off += tz
                ymask >>= tz
                add_sample(0, off, -1, 1, by + off, bx - 1)
                ymask &= ~1
        if len(pts) < 8 and (masks[1] >> 32):  # top/left
            add_sample(0, 0, -1, -1, by - 1, bx - 1)
        if len(pts) < 8 and (masks[0] >> 32):  # top/right
            add_sample(bw4, 0, 1, -1, by - 1, bx + bw4)
        assert 0 < len(pts) <= 8

        # threshold selection (decode.c:336-357); the LS sums are
        # order-independent so keeping the valid subset is equivalent to
        # dav1d's in-place compaction
        mvy, mvx = mv_yx
        thresh = 4 * iclip_u8_range(max(bw4, bh4), 4, 28)
        valid = [p for p in pts
                 if abs(p[1][0] - p[0][0] - mvx) +
                 abs(p[1][1] - p[0][1] - mvy) <= thresh]
        if not valid:
            valid = [pts[0]]
        wm = WarpParams()
        if not find_affine_int(valid, len(valid), bw4, bh4, mv_yx, wm,
                               bx, by) and not get_shear_params(wm):
            wm.type = 3  # WM_TYPE_AFFINE
        else:
            wm.type = 0  # WM_TYPE_IDENTITY
        return wm

    def _find_matching_ref(self, edge_flags, bw4, bh4, w4, h4, have_left,
                           have_top, ref, bx, by):
        """dav1d decode.c find_matching_ref:219. Returns masks[2]."""
        rf = self.rf
        masks = [0, 0]
        count = 0
        have_topleft = have_top and have_left
        have_topright = (max(bw4, bh4) < 32 and have_top and
                         bx + bw4 < self.col_end and (edge_flags & 1))

        def matches(cy, cx):
            return rf.ref[cy, cx, 0] == ref + 1 and rf.ref[cy, cx, 1] == -1

        if have_top:
            if matches(by - 1, bx):
                masks[0] |= 1
                count = 1
            aw4 = int(T_BLOCK_DIM[rf.bs[by - 1, bx]][0])
            if aw4 >= bw4:
                off = bx & (aw4 - 1)
                if off:
                    have_topleft = 0
                if aw4 - off > bw4:
                    have_topright = 0
            else:
                mask = 1 << aw4
                x = aw4
                while x < w4:
                    if matches(by - 1, bx + x):
                        masks[0] |= mask
                        count += 1
                        if count >= 8:
                            return masks
                    aw4 = int(T_BLOCK_DIM[rf.bs[by - 1, bx + x]][0])
                    mask <<= aw4
                    x += aw4
        if have_left:
            if matches(by, bx - 1):
                masks[1] |= 1
                count += 1
                if count >= 8:
                    return masks
            lh4 = int(T_BLOCK_DIM[rf.bs[by, bx - 1]][1])
            if lh4 >= bh4:
                if by & (lh4 - 1):
                    have_topleft = 0
            else:
                mask = 1 << lh4
                y = lh4
                while y < h4:
                    if matches(by + y, bx - 1):
                        masks[1] |= mask
                        count += 1
                        if count >= 8:
                            return masks
                    lh4 = int(T_BLOCK_DIM[rf.bs[by + y, bx - 1]][1])
                    mask <<= lh4
                    y += lh4
        if have_topleft and matches(by - 1, bx - 1):
            masks[1] |= 1 << 32
            count += 1
            if count >= 8:
                return masks
        if have_topright and matches(by - 1, bx + bw4):
            masks[0] |= 1 << 32
        return masks

    # ---- var-tx tree (dav1d decode.c read_vartx_tree:473/read_tx_tree:141)
    def _read_vartx_tree(self, b, bs, bx4, by4, bx, by):
        f = self.f
        b_dim = T_BLOCK_DIM[bs]
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        a = self._a(bx)
        l = self.l
        tx_split = [0, 0]
        b.max_ytx = int(T_MAX_TX[bs][0])
        lossless = f.segmentation_lossless[b.seg_id]
        if not b.skip and (lossless or b.max_ytx == TX_4X4):
            b.max_ytx = b.uvtx = TX_4X4
            if f.txfm_mode == TX_SWITCHABLE:
                l.tx[by4:by4 + bh4] = TX_4X4
                a.tx[bx4:bx4 + bw4] = TX_4X4
        elif f.txfm_mode != TX_SWITCHABLE or b.skip:
            if f.txfm_mode == TX_SWITCHABLE:
                l.tx[by4:by4 + bh4] = int(b_dim[3])
                a.tx[bx4:bx4 + bw4] = int(b_dim[2])
            b.uvtx = int(T_MAX_TX[bs][self.layout])
        else:
            assert bw4 <= 16 or bh4 <= 16 or b.max_ytx == TX_64X64
            ytx = T_TXFM[b.max_ytx]
            yw, yh = int(ytx[0]), int(ytx[1])
            y_off = 0
            yy = 0
            while yy < bh4:
                x_off = 0
                xx = 0
                while xx < bw4:
                    self._read_tx_tree(b.max_ytx, 0, tx_split, x_off, y_off,
                                       bx + xx, by + yy)
                    xx += yw
                    x_off += 1
                yy += yh
                y_off += 1
            if self.dbg:
                print(f"Post-vartxtree[{tx_split[0]:x}/{tx_split[1]:x}]: "
                      f"r={self.ec.rng}")
            b.uvtx = int(T_MAX_TX[bs][self.layout])
        b.tx = b.max_ytx
        assert not (tx_split[0] & ~0x33)
        b.tx_split0 = tx_split[0]
        b.tx_split1 = tx_split[1]

    def _read_tx_tree(self, from_tx, depth, masks, x_off, y_off, bx, by):
        t_dim = T_TXFM[from_tx]
        tw, th = int(t_dim[0]), int(t_dim[1])
        lw, lh = int(t_dim[2]), int(t_dim[3])
        bx4, by4 = bx & 31, by & 31
        a = self._a(bx)
        l = self.l
        is_split = 0
        if depth < 2 and from_tx > TX_4X4:
            cat = 2 * (TX_64X64 - int(t_dim[5])) - depth
            actx = int(int(a.tx[bx4]) < lw)
            lctx = int(int(l.tx[by4]) < lh)
            is_split = self.ec.bool_adapt(
                "txpart", self.cdf.m["txpart"][cat][actx + lctx])
            if is_split:
                masks[depth] |= 1 << (y_off * 4 + x_off)
        if is_split and int(t_dim[5]) > TX_8X8:
            sub = int(t_dim[6])
            sub_t = T_TXFM[sub]
            txsw, txsh = int(sub_t[0]), int(sub_t[1])
            self._read_tx_tree(sub, depth + 1, masks, x_off * 2, y_off * 2,
                               bx, by)
            if tw >= th and bx + txsw < self.bw:
                self._read_tx_tree(sub, depth + 1, masks, x_off * 2 + 1,
                                   y_off * 2, bx + txsw, by)
            if th >= tw and by + txsh < self.bh:
                self._read_tx_tree(sub, depth + 1, masks, x_off * 2,
                                   y_off * 2 + 1, bx, by + txsh)
                if tw >= th and bx + txsw < self.bw:
                    self._read_tx_tree(sub, depth + 1, masks, x_off * 2 + 1,
                                       y_off * 2 + 1, bx + txsw, by + txsh)
        else:
            l.tx[by4:by4 + th] = TX_4X4 if is_split else lh
            a.tx[bx4:bx4 + tw] = TX_4X4 if is_split else lw

    # ---- intra block copy (dav1d decode.c:1304-1420) ----
    def _intrabc_clip(self, mv, bs, bx, by, has_chroma):
        """Clip an intrabc MV to the decoded area; returns clipped mv or
        None if it cannot be made valid (decode error)."""
        b_dim = T_BLOCK_DIM[bs]
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        border_left = self.col_start * 4
        border_top = self.row_start * 4
        if has_chroma:
            if bw4 < 2 and self.ss_hor:
                border_left += 4
            if bh4 < 2 and self.ss_ver:
                border_top += 4
        src_left = bx * 4 + (mv[1] >> 3)
        src_top = by * 4 + (mv[0] >> 3)
        src_right = src_left + bw4 * 4
        src_bottom = src_top + bh4 * 4
        border_right = ((self.col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4
        if src_left < border_left:
            src_right += border_left - src_left
            src_left = border_left
        elif src_right > border_right:
            src_left -= src_right - border_right
            src_right = border_right
        if src_top < border_top:
            src_bottom += border_top - src_top
            src_top = border_top
        sbx = (bx >> (4 + self.sb128)) << (6 + self.sb128)
        sby = (by >> (4 + self.sb128)) << (6 + self.sb128)
        sb_size = 1 << (6 + self.sb128)
        if src_bottom > sby and src_right > sbx:
            if src_top - border_top >= src_bottom - sby:
                src_top -= src_bottom - sby
                src_bottom = sby
            elif src_left - border_left >= src_right - sbx:
                src_left -= src_right - sbx
                src_right = sbx
        if src_bottom > sby + sb_size:
            src_top -= src_bottom - (sby + sb_size)
            src_bottom = sby + sb_size
        if src_bottom > sby and src_right > sbx:
            return None
        return ((src_top - by * 4) * 8, (src_left - bx * 4) * 8)

    def _intrabc_pred_mv(self, bs, bx, by, edge_flags):
        """The intrabc prediction MV (mvstack fallback chain)."""
        from .refmvs import refmvs_find
        stack, n_mvs, _ = refmvs_find(self.rf, self, (0, -1), bs,
                                      edge_flags, by, bx)
        if stack[0][0] != (0, 0):
            return stack[0][0]
        if stack[1][0] != (0, 0):
            return stack[1][0]
        if by - (16 << self.sb128) < self.row_start:
            return (0, -(512 << self.sb128) - 2048)
        return (-(512 << self.sb128), 0)

    def _intrabc_block(self, b, bs, bx, by, w4, h4, edge_flags, seg_pred,
                       has_chroma):
        ec = self.ec
        b_dim = T_BLOCK_DIM[bs]
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        bx4, by4 = bx & 31, by & 31
        pred = self._intrabc_pred_mv(bs, bx, by, edge_flags)
        if ec.is_decode:
            mv = self._read_mv_residual(pred, self.cdf.dmv, 0)
        else:
            # pick a valid full-pel target (validity probed via the clip)
            mv = self._pick_intrabc_target(pred, bs, bx, by, has_chroma)
            self._put_mv_residual_exact(pred, mv, self.cdf.dmv, 0)
        clipped = self._intrabc_clip(mv, bs, bx, by, has_chroma)
        if clipped is None:
            raise ValueError("invalid intrabc mv")
        b.mv = [clipped, (0, 0)]
        b.ref = [-1, -1]
        b.comp_type = COMP_INTER_NONE
        b.inter_mode = 0
        b.filter2d = 9  # FILTER_2D_BILINEAR
        if self.dbg:
            print(f"Post-dmv[{b.mv[0][0]}/{b.mv[0][1]},"
                  f"ref={pred[0]}/{pred[1]}]: r={ec.rng}")
        self._read_vartx_tree(b, bs, bx4, by4, bx, by)
        b.coef_lo = len(self.coefs)
        self._read_coef_blocks(b, bs, bx, by, w4, h4, has_chroma)
        b.coef_hi = len(self.coefs)
        b.lflvl4 = self._calc_lflvl(b.seg_id, 0, 0)
        # splat_intrabc_mv (decode.c:564)
        self.rf.splat_mv(by, bx, bw4, bh4, 0, -1, b.mv[0], (0, 0), bs, 0)
        # context updates (decode.c:1401-1419)
        a = self._a(bx)
        l = self.l
        ss_ver, ss_hor = self.ss_ver, self.ss_hor
        cbx4, cby4 = bx4 >> ss_hor, by4 >> ss_ver
        cbw4 = (bw4 + ss_hor) >> ss_hor
        cbh4 = (bh4 + ss_ver) >> ss_ver
        l.tx_intra[by4:by4 + bh4] = int(b_dim[3])
        a.tx_intra[bx4:bx4 + bw4] = int(b_dim[2])
        l.mode[by4:by4 + bh4] = DC_PRED
        a.mode[bx4:bx4 + bw4] = DC_PRED
        l.pal_sz[by4:by4 + bh4] = 0
        a.pal_sz[bx4:bx4 + bw4] = 0
        self.pal_sz_uv[0][bx:bx + bw4] = 0
        self.pal_sz_uv[1][by:by + bh4] = 0
        l.seg_pred[by4:by4 + bh4] = seg_pred
        a.seg_pred[bx4:bx4 + bw4] = seg_pred
        l.skip_mode[by4:by4 + bh4] = 0
        a.skip_mode[bx4:bx4 + bw4] = 0
        l.intra[by4:by4 + bh4] = 0
        a.intra[bx4:bx4 + bw4] = 0
        l.skip[by4:by4 + bh4] = b.skip
        a.skip[bx4:bx4 + bw4] = b.skip
        if has_chroma:
            l.uvmode[cby4:cby4 + cbh4] = DC_PRED
            a.uvmode[cbx4:cbx4 + cbw4] = DC_PRED

    def _pick_intrabc_target(self, pred, bs, bx, by, has_chroma):
        """Encode-side: choose a valid full-pel intrabc MV near the
        prediction (falls back to the prediction itself)."""
        r = self.ec.policy
        dy = (r("intrabc_dy", 16) - 8) * 8
        dx = (r("intrabc_dx", 16) - 8) * 8
        from .refmvs import _s16
        cand = (_s16(pred[0] + dy), _s16(pred[1] + dx))
        if self._intrabc_clip(cand, bs, bx, by, has_chroma) is not None:
            return cand
        return pred

    def _put_mv_component_diff_exact(self, pfx, mv_cdf, diff, have_fp):
        """Encoder mirror of _read_mv_component_diff for an exact diff."""
        e = self.ec.e
        have_hp = self.f.hp
        sign = 1 if diff < 0 else 0
        a = abs(diff) - 1
        hp = a & 1
        fp = (a >> 1) & 3
        up = a >> 3
        if not have_fp:
            assert fp == 3 and hp == 1, "dmv diffs must be full-pel"
        e.put_bool_adapt(sign, mv_cdf[pfx + ".sign"])
        if up < 2:
            e.put_symbol_adapt(0, mv_cdf[pfx + ".classes"], 10)
            e.put_bool_adapt(up, mv_cdf[pfx + ".class0"])
            if have_fp:
                e.put_symbol_adapt(fp, mv_cdf[pfx + ".class0_fp"][up], 3)
                if have_hp:
                    e.put_bool_adapt(hp, mv_cdf[pfx + ".class0_hp"])
        else:
            cl = up.bit_length() - 1
            assert cl <= 10
            e.put_symbol_adapt(cl, mv_cdf[pfx + ".classes"], 10)
            for n in range(cl):
                e.put_bool_adapt((up >> n) & 1, mv_cdf[pfx + ".classN"][n])
            if have_fp:
                e.put_symbol_adapt(fp, mv_cdf[pfx + ".classN_fp"], 3)
                if have_hp:
                    e.put_bool_adapt(hp, mv_cdf[pfx + ".classN_hp"])

    def _put_mv_residual_exact(self, ref_mv, target, mv_cdf, have_fp):
        e = self.ec.e
        dy = target[0] - ref_mv[0]
        dx = target[1] - ref_mv[1]
        joint = (1 if dx else 0) | (2 if dy else 0)
        e.put_symbol_adapt(joint, self.cdf.mv["joint"], 3)
        if dy:
            self._put_mv_component_diff_exact("comp0", mv_cdf, dy, have_fp)
        if dx:
            self._put_mv_component_diff_exact("comp1", mv_cdf, dx, have_fp)

    # ---- mv residuals (dav1d decode.c read_mv_residual:120)
    def _read_mv_component_diff(self, pfx, mv_cdf, have_fp):
        ec = self.ec
        have_hp = self.f.hp
        sign = ec.bool_adapt("mv_sign", mv_cdf[pfx + ".sign"])
        cl = ec.sym("mv_class", mv_cdf[pfx + ".classes"], 10)
        if cl == 0:
            up = ec.bool_adapt("mv_class0", mv_cdf[pfx + ".class0"])
            if have_fp:
                fp = ec.sym("mv_fp", mv_cdf[pfx + ".class0_fp"][up], 3)
                hp = ec.bool_adapt("mv_hp", mv_cdf[pfx + ".class0_hp"]) \
                    if have_hp else 1
            else:
                fp, hp = 3, 1
        else:
            up = 1 << cl
            for n in range(cl):
                up |= ec.bool_adapt("mv_classN",
                                    mv_cdf[pfx + ".classN"][n]) << n
            if have_fp:
                fp = ec.sym("mv_fp", mv_cdf[pfx + ".classN_fp"], 3)
                hp = ec.bool_adapt("mv_hp", mv_cdf[pfx + ".classN_hp"]) \
                    if have_hp else 1
            else:
                fp, hp = 3, 1
        diff = ((up << 3) | (fp << 1) | hp) + 1
        return -diff if sign else diff

    def _read_mv_residual(self, ref_mv, mv_cdf, have_fp):
        from .refmvs import _s16
        ec = self.ec
        # dav1d quirk: the joint cdf always comes from cdf.mv (decode.c:123)
        j = ec.sym("mv_joint", self.cdf.mv["joint"], 3)
        y, x = ref_mv
        if j == 3:      # MV_JOINT_HV
            y = _s16(y + self._read_mv_component_diff("comp0", mv_cdf,
                                                      have_fp))
            x = _s16(x + self._read_mv_component_diff("comp1", mv_cdf,
                                                      have_fp))
        elif j == 1:    # MV_JOINT_H
            x = _s16(x + self._read_mv_component_diff("comp1", mv_cdf,
                                                      have_fp))
        elif j == 2:    # MV_JOINT_V
            y = _s16(y + self._read_mv_component_diff("comp0", mv_cdf,
                                                      have_fp))
        return (y, x)

    # ---- inter luma coefficient tree (dav1d recon_tmpl.c read_coef_tree:726)
    def _read_coef_tree(self, b, bs, ytx, depth, tx_split, x_off, y_off,
                        bx, by):
        t_dim = T_TXFM[ytx]
        tw, th = int(t_dim[0]), int(t_dim[1])
        if depth < 2 and tx_split[depth] and \
                tx_split[depth] & (1 << (y_off * 4 + x_off)):
            sub = int(t_dim[6])
            sub_t = T_TXFM[sub]
            txsw, txsh = int(sub_t[0]), int(sub_t[1])
            self._read_coef_tree(b, bs, sub, depth + 1, tx_split,
                                 x_off * 2, y_off * 2, bx, by)
            if tw >= th and bx + txsw < self.bw:
                self._read_coef_tree(b, bs, sub, depth + 1, tx_split,
                                     x_off * 2 + 1, y_off * 2, bx + txsw, by)
            if th >= tw and by + txsh < self.bh:
                self._read_coef_tree(b, bs, sub, depth + 1, tx_split,
                                     x_off * 2, y_off * 2 + 1, bx, by + txsh)
                if tw >= th and bx + txsw < self.bw:
                    self._read_coef_tree(b, bs, sub, depth + 1, tx_split,
                                         x_off * 2 + 1, y_off * 2 + 1,
                                         bx + txsw, by + txsh)
        else:
            bx4, by4 = bx & 31, by & 31
            a = self._a(bx)
            l = self.l
            cf, eob, txtp, cf_ctx = self._decode_coefs(
                b, ytx, bs, intra=0, plane=0, a_arr=a.lcoef, a_off=bx4,
                l_arr=l.lcoef, l_off=by4)
            if self.dbg:
                print(f"Post-y-cf-blk[tx={ytx},txtp={txtp},eob={eob}]: "
                      f"r={self.ec.rng}")
            self.coefs.append(CoefBlock(0, bx, by, ytx, txtp, eob, cf))
            nh = min(th, self.bh - by)
            nw = min(tw, self.bw - bx)
            l.lcoef[by4:by4 + nh] = cf_ctx
            a.lcoef[bx4:bx4 + nw] = cf_ctx
            self.txtp_map[by4:by4 + th, bx4:bx4 + tw] = txtp

    def _read_lr_for_sb(self, bx, by):
        f = self.f
        if not self.restore_planes:
            return
        for p in range(3):
            if not ((self.restore_planes >> p) & 1):
                continue
            ss_ver = 1 if (p and self.layout == PIXEL_LAYOUT_I420) else 0
            ss_hor = 1 if (p and self.layout != PIXEL_LAYOUT_I444) else 0
            us_log2 = f.restoration_unit_size[1 if p else 0]
            y = (by * 4) >> ss_ver
            hh = (f.height + ss_ver) >> ss_ver
            unit_size = 1 << us_log2
            mask_ = unit_size - 1
            if y & mask_:
                continue
            half = unit_size >> 1
            if y and y + half > hh:
                continue
            if f.width[0] != f.width[1]:
                # super-res: units live on the upscaled grid
                # (dav1d decode.c:2726-2743)
                ww = (f.width[1] + ss_hor) >> ss_hor
                n_units = max(1, (ww + half) >> us_log2)
                d = f.super_res_width_scale_denominator
                rnd = unit_size * 8 - 1
                shift = us_log2 + 3
                x0 = (((4 * bx * d) >> ss_hor) + rnd) >> shift
                x1 = ((((4 * (bx + self.sb_step)) * d) >> ss_hor) + rnd) \
                    >> shift
                for x in range(x0, min(x1, n_units)):
                    px_x = x << (us_log2 + ss_hor)
                    lr = self._read_restoration_info(
                        p, f.restoration_type[p])
                    self.lr_units[(p, (by * 4) >> 6, px_x >> 6)] = lr
                continue
            x = (4 * bx) >> ss_hor
            if x & mask_:
                continue
            ww = (f.width[0] + ss_hor) >> ss_hor
            if x and x + half > ww:
                continue
            lr = self._read_restoration_info(p, f.restoration_type[p])
            # key on 64px-luma grid (storage granularity)
            self.lr_units[(p, (by * 4) >> 6, (bx * 4) >> 6)] = lr

    def _read_restoration_info(self, p, frame_type):
        ec = self.ec
        cdfm = self.cdf.m
        ref = self.lr_ref[p]
        lr = dict(type=0, filter_v=[0, 0, 0], filter_h=[0, 0, 0],
                  sgr_weights=list(ref["sgr_weights"]))
        RESTORATION_SWITCHABLE, RESTORATION_WIENER, RESTORATION_SGRPROJ = \
            1, 2, 3
        if frame_type == RESTORATION_SWITCHABLE:
            filt = ec.sym("lr_switchable", cdfm["restore_switchable"], 2)
            lr["type"] = filt + (1 if filt else 0)  # NONE/WIENER/SGRPROJ
        else:
            cdf = cdfm["restore_wiener"] \
                if frame_type == RESTORATION_WIENER \
                else cdfm["restore_sgrproj"]
            t = ec.bool_adapt("lr_type", cdf)
            lr["type"] = frame_type if t else 0
        if lr["type"] == RESTORATION_WIENER:
            lr["filter_v"][0] = 0 if p else \
                ec.subexp("lr_wv0", ref["filter_v"][0] + 5, 16, 1) - 5
            lr["filter_v"][1] = \
                ec.subexp("lr_wv1", ref["filter_v"][1] + 23, 32, 2) - 23
            lr["filter_v"][2] = \
                ec.subexp("lr_wv2", ref["filter_v"][2] + 17, 64, 3) - 17
            lr["filter_h"][0] = 0 if p else \
                ec.subexp("lr_wh0", ref["filter_h"][0] + 5, 16, 1) - 5
            lr["filter_h"][1] = \
                ec.subexp("lr_wh1", ref["filter_h"][1] + 23, 32, 2) - 23
            lr["filter_h"][2] = \
                ec.subexp("lr_wh2", ref["filter_h"][2] + 17, 64, 3) - 17
            lr["sgr_weights"] = list(ref["sgr_weights"])
            self.lr_ref[p] = lr
        elif lr["type"] == RESTORATION_SGRPROJ:
            idx = ec.bools("lr_sgr_idx", 4)
            sgr_params = TABLES["sgr_params"][idx]
            lr["type"] += idx
            lr["sgr_weights"][0] = (
                ec.subexp("lr_sw0", ref["sgr_weights"][0] + 96, 128, 4) - 96
                if sgr_params[0] else 0)
            lr["sgr_weights"][1] = (
                ec.subexp("lr_sw1", ref["sgr_weights"][1] + 32, 128, 4) - 32
                if sgr_params[1] else 95)
            lr["filter_v"] = list(ref["filter_v"])
            lr["filter_h"] = list(ref["filter_h"])
            self.lr_ref[p] = lr
        return lr

    def _calc_lflvl(self, seg_id, ref1, mode1):
        """dav1d lf_mask.c calc_lf_value:431. ref1: 0 = intra, else ref+1;
        mode1: 0 if globalmv (inter only)."""
        f = self.f
        if not f.loopfilter_level_y[0] and not f.loopfilter_level_y[1]:
            return (0, 0, 0, 0)
        mr = f.loopfilter_mode_ref_deltas \
            if f.loopfilter_mode_ref_delta_enabled else None
        segd = f.seg_data.d[seg_id] if f.segmentation_enabled else None
        dlf = self.last_delta_lf
        multi = f.delta_lf_multi

        def calc(base_lvl, lf_delta, seg_delta):
            base = max(0, min(63, base_lvl + lf_delta))
            base = max(0, min(63, base + seg_delta))
            if mr is None:
                return base
            sh = 1 if base >= 32 else 0
            if ref1 == 0:
                delta = mr.ref_delta[0]
            else:
                delta = mr.mode_delta[mode1] + mr.ref_delta[ref1]
            return max(0, min(63, base + delta * (1 << sh)))

        def calc_c(base_lvl, lf_delta, seg_delta):
            return 0 if not base_lvl else calc(base_lvl, lf_delta, seg_delta)

        return (
            calc(f.loopfilter_level_y[0], dlf[0],
                 segd.delta_lf_y_v if segd else 0),
            calc(f.loopfilter_level_y[1], dlf[1 if multi else 0],
                 segd.delta_lf_y_h if segd else 0),
            calc_c(f.loopfilter_level_u, dlf[2 if multi else 0],
                   segd.delta_lf_u if segd else 0),
            calc_c(f.loopfilter_level_v, dlf[3 if multi else 0],
                   segd.delta_lf_v if segd else 0),
        )

    def _read_delta_q_lf(self, b, bs):
        ec = self.ec
        f = self.f
        sb_bs = 0 if self.sb128 else 3  # BS_128x128 or BS_64x64
        have_delta_q = f.delta_q_present and (bs != sb_bs or not b.skip)
        if have_delta_q:
            delta_q = ec.sym("delta_q", self.cdf.m["delta_q"], 3)
            if delta_q == 3:
                n_bits = 1 + ec.bools("delta_q_nbits", 3)
                delta_q = ec.bools("delta_q_bits", n_bits) + 1 + (1 << n_bits)
            if delta_q:
                if ec.equi("delta_q_sign"):
                    delta_q = -delta_q
                delta_q *= 1 << f.delta_q_res_log2
            self.last_qidx = max(1, min(255, self.last_qidx + delta_q))
            if f.delta_lf_present:
                n_lfs = (4 if not self.monochrome else 2) \
                    if f.delta_lf_multi else 1
                for i in range(n_lfs):
                    delta_lf = ec.sym(
                        "delta_lf",
                        self.cdf.m["delta_lf"][i + f.delta_lf_multi], 3)
                    if delta_lf == 3:
                        n_bits = 1 + ec.bools("delta_lf_nbits", 3)
                        delta_lf = ec.bools("delta_lf_bits", n_bits) + 1 + \
                            (1 << n_bits)
                    if delta_lf:
                        if ec.equi("delta_lf_sign"):
                            delta_lf = -delta_lf
                        delta_lf *= 1 << f.delta_lf_res_log2
                    self.last_delta_lf[i] = max(
                        -63, min(63, self.last_delta_lf[i] + delta_lf))
            if self.last_qidx == f.quant_yac:
                self.dq = self.dq_frame
            else:
                self.dq = self._init_quant_tables(self.last_qidx)

    # ---- coefficients ----
    def _read_coef_blocks(self, b, bs, bx, by, w4, h4, has_chroma):
        ss_ver, ss_hor = self.ss_ver, self.ss_hor
        bx4, by4 = bx & 31, by & 31
        cbx4, cby4 = bx4 >> ss_hor, by4 >> ss_ver
        b_dim = T_BLOCK_DIM[bs]
        bw4, bh4 = int(b_dim[0]), int(b_dim[1])
        cbw4 = (bw4 + ss_hor) >> ss_hor
        cbh4 = (bh4 + ss_ver) >> ss_ver
        cw4 = (w4 + ss_hor) >> ss_hor
        ch4 = (h4 + ss_ver) >> ss_ver
        a = self._a(bx)
        l = self.l

        if b.skip:
            a.lcoef[bx4:bx4 + bw4] = 0x40
            l.lcoef[by4:by4 + bh4] = 0x40
            if has_chroma:
                a.ccoef[0][cbx4:cbx4 + cbw4] = 0x40
                a.ccoef[1][cbx4:cbx4 + cbw4] = 0x40
                l.ccoef[0][cby4:cby4 + cbh4] = 0x40
                l.ccoef[1][cby4:cby4 + cbh4] = 0x40
            return

        t_dim = T_TXFM[b.tx if b.intra else b.max_ytx]
        uv_t_dim = T_TXFM[b.uvtx]
        tw, th = int(t_dim[0]), int(t_dim[1])
        ctw, cth = int(uv_t_dim[0]), int(uv_t_dim[1])
        tx_split = (b.tx_split0, b.tx_split1) if not b.intra else None

        for init_y in range(0, h4, 16):
            sub_h4 = min(h4, 16 + init_y)
            for init_x in range(0, w4, 16):
                sub_w4 = min(w4, init_x + 16)
                y = init_y
                y_off = 1 if init_y else 0
                while y < sub_h4:
                    x = init_x
                    x_off = 1 if init_x else 0
                    while x < sub_w4:
                        if not b.intra:
                            self._read_coef_tree(b, bs, b.max_ytx, 0,
                                                 tx_split, x_off, y_off,
                                                 bx + x, by + y)
                            x += tw
                            x_off += 1
                            continue
                        cf, eob, txtp, cf_ctx = self._decode_coefs(
                            b, b.tx, bs, intra=1, plane=0,
                            a_arr=a.lcoef, a_off=bx4 + x,
                            l_arr=l.lcoef, l_off=by4 + y)
                        if self.dbg:
                            print(f"Post-y-cf-blk[tx={b.tx},txtp={txtp},"
                                  f"eob={eob}]: r={self.ec.rng}")
                        self.coefs.append(CoefBlock(
                            0, bx + x, by + y, b.tx, txtp, eob, cf))
                        nh = min(th, self.bh - (by + y))
                        nw = min(tw, self.bw - (bx + x))
                        l.lcoef[by4 + y:by4 + y + nh] = cf_ctx
                        a.lcoef[bx4 + x:bx4 + x + nw] = cf_ctx
                        x += tw
                    y += th
                    y_off += 1

                if not has_chroma:
                    continue
                sub_ch4 = min(ch4, (init_y + 16) >> ss_ver)
                sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
                for pl in range(2):
                    y = init_y >> ss_ver
                    while y < sub_ch4:
                        x = init_x >> ss_hor
                        while x < sub_cw4:
                            ytxtp = 0 if b.intra else int(
                                self.txtp_map[by4 + (y << ss_ver),
                                              bx4 + (x << ss_hor)])
                            cf, eob, txtp, cf_ctx = self._decode_coefs(
                                b, b.uvtx, bs, intra=b.intra, plane=1 + pl,
                                a_arr=a.ccoef[pl], a_off=cbx4 + x,
                                l_arr=l.ccoef[pl], l_off=cby4 + y,
                                ytxtp=ytxtp)
                            if self.dbg:
                                print(f"Post-uv-cf-blk[pl={pl},tx={b.uvtx},"
                                      f"txtp={txtp},eob={eob}]: "
                                      f"r={self.ec.rng}")
                            self.coefs.append(CoefBlock(
                                1 + pl, (bx >> ss_hor) + x,
                                (by >> ss_ver) + y, b.uvtx, txtp, eob, cf))
                            # dav1d: imin(uv_t_dim->h, (f->bh - t->by + ss_ver)
                            #             >> ss_ver) with t->by in luma units
                            tby = by + (y << ss_ver)
                            tbx = bx + (x << ss_hor)
                            nh = min(cth, (self.bh - tby + ss_ver) >> ss_ver)
                            nw = min(ctw, (self.bw - tbx + ss_hor) >> ss_hor)
                            l.ccoef[pl][cby4 + y:cby4 + y + nh] = cf_ctx
                            a.ccoef[pl][cbx4 + x:cbx4 + x + nw] = cf_ctx
                            x += ctw
                        y += cth

    def _decode_coefs(self, b, tx, bs, intra, plane, a_arr, a_off,
                      l_arr, l_off, ytxtp=0):
        """Returns (cf[sh4*4 x sw4*4 flat dav1d layout], eob, txtp, cf_ctx)"""
        ec = self.ec
        f = self.f
        cdfc = self.cdf.coef
        chroma = 1 if plane else 0
        lossless = f.segmentation_lossless[b.seg_id]
        t_dim = T_TXFM[tx]
        tw, th = int(t_dim[0]), int(t_dim[1])    # in 4px units
        lw, lh = int(t_dim[2]), int(t_dim[3])
        t_min, t_max, t_ctx = int(t_dim[4]), int(t_dim[5]), int(t_dim[7])

        # skip ctx
        sctx = self._get_skip_ctx(t_dim, bs, a_arr, a_off, l_arr, l_off,
                                  chroma)
        all_skip = ec.bool_adapt("coef_skip", cdfc["skip"][t_ctx][sctx])
        if all_skip:
            txtp = WHT_WHT if lossless else DCT_DCT
            return None, -1, txtp, 0x40

        # txtp
        if lossless:
            txtp = WHT_WHT
        elif t_max + intra >= TX_64X64:
            txtp = DCT_DCT
        elif chroma:
            txtp = int(T_TXTP_FROM_UVMODE[b.uv_mode]) if intra else \
                get_uv_inter_txtp(t_dim, ytxtp)
        elif not f.segmentation_qidx[b.seg_id]:
            txtp = DCT_DCT
        else:
            if intra:
                if b.y_mode == FILTER_PRED:
                    from_filter = TABLES["filter_mode_to_y_mode"]
                    y_mode_nofilt = int(from_filter[b.y_angle])
                else:
                    y_mode_nofilt = b.y_mode
                if f.reduced_txtp_set or t_min == TX_16X16:
                    idx = ec.sym("txtp_intra2",
                                 self.cdf.m["txtp_intra2"][t_min]
                                 [y_mode_nofilt], 4)
                    txtp = int(T_TX_TYPES_PER_SET[idx + 0])
                else:
                    idx = ec.sym("txtp_intra1",
                                 self.cdf.m["txtp_intra1"][t_min]
                                 [y_mode_nofilt], 6)
                    txtp = int(T_TX_TYPES_PER_SET[idx + 5])
            else:
                # dav1d recon_tmpl.c decode_coefs:383-397
                if f.reduced_txtp_set or t_max == TX_32X32:
                    idx = ec.bool_adapt("txtp_inter3",
                                        self.cdf.m["txtp_inter3"][t_min])
                    txtp = DCT_DCT if idx else IDTX
                elif t_min == TX_16X16:
                    idx = ec.sym("txtp_inter2", self.cdf.m["txtp_inter2"],
                                 11)
                    txtp = int(T_TX_TYPES_PER_SET[idx + 12])
                else:
                    idx = ec.sym("txtp_inter1",
                                 self.cdf.m["txtp_inter1"][t_min], 15)
                    txtp = int(T_TX_TYPES_PER_SET[idx + 24])

        # eob
        tx2dszctx = min(lw, TX_32X32) + min(lh, TX_32X32)
        tx_class = int(T_TX_TYPE_CLASS[txtp])
        is_1d = int(tx_class != TX_CLASS_2D)
        eob_bin_keys = ["eob_bin_16", "eob_bin_32", "eob_bin_64",
                        "eob_bin_128", "eob_bin_256", "eob_bin_512",
                        "eob_bin_1024"]
        if tx2dszctx < 5:
            eob_bin_cdf = cdfc[eob_bin_keys[tx2dszctx]][chroma][is_1d]
        else:
            eob_bin_cdf = cdfc[eob_bin_keys[tx2dszctx]][chroma]
        eob_cdf = cdfc["eob_base_tok"][t_ctx][chroma]
        hi_cdf = cdfc["br_tok"][min(t_ctx, 3)][chroma]

        sw4 = min(tw, 8)
        sh4 = min(th, 8)

        # Native fast path: the whole eob/token/sign/dequant walk (the
        # densest symbol stream) in ONE ctypes call into native/msac.cpp
        # coef_decode_block — bit-exact with the Python code below.
        if ec.is_decode and hasattr(ec.m, "coef_decode_block"):
            if tx_class == TX_CLASS_2D:
                nonsquare_tx = int(tx >= 5)  # RTX_4X8
                n_lo_ctx = T_LO_CTX_OFFSETS[nonsquare_tx +
                                            (tx & nonsquare_tx)]
                n_scan = SCANS[tx]
            else:
                n_lo_ctx = None
                n_scan = None
            n_dq = self.dq[b.seg_id][plane]
            n_qm = self.qm[tx][plane] if txtp < IDTX else None
            n_bd = self.seq.bitdepth
            n_dc_sign_ctx = self._get_dc_sign_ctx(tx, a_arr, a_off,
                                                  l_arr, l_off)
            out, eob, cf_ctx = ec.m.coef_decode_block(
                eob_bin_cdf, 4 + tx2dszctx,
                cdfc["eob_hi_bit"][t_ctx][chroma], eob_cdf,
                cdfc["base_tok"][t_ctx][chroma], hi_cdf,
                cdfc["dc_sign"][chroma][n_dc_sign_ctx],
                tx_class, sw4, sh4, lw, lh, n_scan, n_lo_ctx,
                int(n_dq[0]), int(n_dq[1]), n_qm,
                max(0, t_ctx - 2),
                ~((~127) << (8 if n_bd == 8 else n_bd)))
            return self._cf2d(out, sw4, sh4), eob, txtp, cf_ctx

        eob_bin = ec.sym("eob_bin", eob_bin_cdf, 4 + tx2dszctx)
        if eob_bin > 1:
            eob_hi_bit = ec.bool_adapt(
                "eob_hi_bit", cdfc["eob_hi_bit"][t_ctx][chroma][eob_bin])
            eob = ((eob_hi_bit | 2) << (eob_bin - 2)) | \
                ec.bools("eob_bits", eob_bin - 2)
        else:
            eob = eob_bin

        n_coef = (4 * sw4) * (4 * sh4)
        cf = np.zeros(n_coef, np.int64)
        rc = 0
        dc_tok = 0

        if eob:
            lo_cdf = cdfc["base_tok"][t_ctx][chroma]
            if tx_class == TX_CLASS_2D:
                nonsquare_tx = int(tx >= 5)  # RTX_4X8
                lo_ctx_offsets = T_LO_CTX_OFFSETS[
                    nonsquare_tx + (tx & nonsquare_tx)]
                scan = SCANS[tx]
                stride = 4 * sh4
                shift = lh + 2 if lh < 4 else 5
                shift2 = 0
                mask = 4 * sh4 - 1
                levels = np.zeros(stride * (4 * sw4 + 2), np.int32)
            elif tx_class == TX_CLASS_H:
                lo_ctx_offsets = None
                scan = None
                stride = 16
                shift = lh + 2
                shift2 = 0
                mask = 4 * sh4 - 1
                levels = np.zeros(stride * (4 * sh4 + 2), np.int32)
            else:
                lo_ctx_offsets = None
                scan = None
                stride = 16
                shift = lw + 2
                shift2 = lh + 2
                mask = 4 * sw4 - 1
                levels = np.zeros(stride * (4 * sw4 + 2), np.int32)

            # eob position token: thresholds use px dims (sw*sh*2, sw*sh*4
            # with sw/sh in dav1d's t_dim->w/h units capped at 8)
            ctx = 1 + (eob > sw4 * sh4 * 2) + (eob > sw4 * sh4 * 4)
            eob_tok = ec.sym("eob_tok", eob_cdf[ctx], 2)
            tok = eob_tok + 1
            level_tok = tok * 0x41

            if tx_class == TX_CLASS_2D:
                rc = int(scan[eob])
                x, y = rc >> shift, rc & mask
            elif tx_class == TX_CLASS_H:
                x, y = eob & mask, eob >> shift
                rc = eob
            else:
                x, y = eob & mask, eob >> shift
                rc = (x << shift2) | y
            if eob_tok == 2:
                ctx = 14 if ((x | y) > 1 if tx_class == TX_CLASS_2D
                             else y != 0) else 7
                tok = ec.hi_tok("eob_hi_tok", hi_cdf[ctx])
                level_tok = tok + (3 << 6)
            cf[rc] = tok << 11
            levels[x * stride + y] = level_tok & 0xFF

            for i in range(eob - 1, 0, -1):
                if tx_class == TX_CLASS_2D:
                    rc_i = int(scan[i])
                    x, y = rc_i >> shift, rc_i & mask
                elif tx_class == TX_CLASS_H:
                    x, y = i & mask, i >> shift
                    rc_i = i
                else:
                    x, y = i & mask, i >> shift
                    rc_i = (x << shift2) | y
                assert x < 32 and y < 32
                loff = x * stride + y
                mag = int(levels[loff + 1]) + int(levels[loff + stride])
                if tx_class == TX_CLASS_2D:
                    mag += int(levels[loff + stride + 1])
                    hi_mag = mag
                    mag += int(levels[loff + 2]) + int(levels[loff + 2 * stride])
                    offset = int(lo_ctx_offsets[min(y, 4)][min(x, 4)])
                else:
                    mag += int(levels[loff + 2])
                    hi_mag = mag
                    mag += int(levels[loff + 3]) + int(levels[loff + 4])
                    offset = 26 + (10 if y > 1 else y * 5)
                ctx = offset + (4 if mag > 512 else (mag + 64) >> 7)
                yy = y | x if tx_class == TX_CLASS_2D else y
                tok = ec.sym("lo_tok", lo_cdf[ctx], 3)
                if tok == 3:
                    mag = hi_mag & 63
                    ctx = (14 if yy > (1 if tx_class == TX_CLASS_2D else 0)
                           else 7) + (6 if mag > 12 else (mag + 1) >> 1)
                    tok = ec.hi_tok("hi_tok", hi_cdf[ctx])
                    levels[loff] = (tok + (3 << 6)) & 0xFF
                    cf[rc_i] = (tok << 11) | rc
                    rc = rc_i
                else:
                    levels[loff] = tok * 0x41 & 0xFF
                    if tok:
                        cf[rc_i] = (tok << 11) | rc
                        rc = rc_i
                    else:
                        cf[rc_i] = 0

            # dc
            if tx_class == TX_CLASS_2D:
                ctx = 0
            else:
                mag = int(levels[1]) + int(levels[stride]) + int(levels[2])
                hi_mag = mag
                mag += int(levels[3]) + int(levels[4])
                offset = 26 + 0
                ctx = offset + (4 if mag > 512 else (mag + 64) >> 7)
            dc_tok = ec.sym("dc_lo_tok", lo_cdf[ctx], 3)
            if dc_tok == 3:
                if tx_class == TX_CLASS_2D:
                    mag = int(levels[1]) + int(levels[stride]) + \
                        int(levels[stride + 1])
                else:
                    mag = hi_mag
                mag &= 63
                ctx = 6 if mag > 12 else (mag + 1) >> 1
                dc_tok = ec.hi_tok("dc_hi_tok", hi_cdf[ctx])
        else:
            tok_br = ec.sym("dc_eob_tok", eob_cdf[0], 2)
            dc_tok = 1 + tok_br
            if tok_br == 2:
                dc_tok = ec.hi_tok("dc_hi_tok", hi_cdf[0])
            rc = 0

        # dequant
        dq_tbl = self.dq[b.seg_id][plane]
        qm_tbl = self.qm[tx][plane] if txtp < IDTX else None
        dq_shift = max(0, t_ctx - 2)
        bitdepth = self.seq.bitdepth
        # 8bpc: 0x7fff; 10bpc: 0x1ffff; 12bpc: 0x7ffff
        cf_max = ~((~127) << (8 if bitdepth == 8 else bitdepth))

        out = np.zeros(cf.shape[0], np.int32)

        if not dc_tok:
            cul_level = 0
            dc_sign_level = 1 << 6
            if rc:
                cul_level += self._ac_loop(ec, cf, out, rc, dq_tbl, qm_tbl,
                                           dq_shift, cf_max)
            cf_ctx = min(cul_level, 63) | dc_sign_level
            return self._cf2d(out, sw4, sh4), eob, txtp, cf_ctx

        dc_sign_ctx = self._get_dc_sign_ctx(tx, a_arr, a_off, l_arr, l_off)
        dc_sign = ec.bool_adapt("dc_sign",
                                cdfc["dc_sign"][chroma][dc_sign_ctx])
        dc_dq = int(dq_tbl[0])
        dc_sign_level = (dc_sign - 1) & (2 << 6)

        if qm_tbl is not None:
            dc_dq = (dc_dq * int(qm_tbl[0]) + 16) >> 5
        if dc_tok == 15:
            dc_tok = (ec.golomb("dc_golomb") + 15) & 0xFFFFF
            dc_dq = (dc_dq * dc_tok) & 0xFFFFFF
        else:
            dc_dq = dc_dq * dc_tok
        cul_level = dc_tok
        dc_dq >>= dq_shift
        dc_dq = min(dc_dq, cf_max + dc_sign)
        out[0] = -dc_dq if dc_sign else dc_dq

        if rc:
            cul_level += self._ac_loop(ec, cf, out, rc, dq_tbl, qm_tbl,
                                       dq_shift, cf_max)

        cf_ctx = min(cul_level, 63) | dc_sign_level
        return self._cf2d(out, sw4, sh4), eob, txtp, cf_ctx

    def _ac_loop(self, ec, cf, out, rc, dq_tbl, qm_tbl, dq_shift, cf_max):
        ac_dq = int(dq_tbl[1])
        cul = 0
        while rc:
            sign = ec.equi("ac_sign")
            rc_tok = int(cf[rc])
            if qm_tbl is not None:
                dq = (ac_dq * int(qm_tbl[rc]) + 16) >> 5
            else:
                dq = ac_dq
            if rc_tok >= (15 << 11):
                tok = (ec.golomb("ac_golomb") + 15) & 0xFFFFF
                dq = (dq * tok) & 0xFFFFFF
            else:
                tok = rc_tok >> 11
                dq = dq * tok
            cul += tok
            dq >>= dq_shift
            dq = min(dq, cf_max + sign)
            out[rc] = -dq if sign else dq
            rc = rc_tok & 0x3FF
        return cul

    @staticmethod
    def _cf2d(out, sw4, sh4):
        """dav1d cf layout buf[y + x*sh] -> (sh, sw) array [y][x]."""
        sh, sw = 4 * sh4, 4 * sw4
        return out[:sw * sh].reshape(sw, sh).T.copy()

    def _get_skip_ctx(self, t_dim, bs, a_arr, a_off, l_arr, l_off, chroma):
        b_dim = T_BLOCK_DIM[bs]
        lw, lh = int(t_dim[2]), int(t_dim[3])
        if chroma:
            ss_ver, ss_hor = self.ss_ver, self.ss_hor
            bl2w, bl2h = int(b_dim[2]), int(b_dim[3])
            not_one_blk = (bl2w - (1 if bl2w and ss_hor else 0) > lw or
                           bl2h - (1 if bl2h and ss_ver else 0) > lh)
            ca = int(np.any(a_arr[a_off:a_off + (1 << lw)] != 0x40))
            cl = int(np.any(l_arr[l_off:l_off + (1 << lh)] != 0x40))
            return 7 + 3 * int(not_one_blk) + ca + cl
        if int(b_dim[2]) == lw and int(b_dim[3]) == lh:
            return 0
        la = 0
        for k in range(1 << lw):
            la |= int(a_arr[a_off + k])
        ll = 0
        for k in range(1 << lh):
            ll |= int(l_arr[l_off + k])
        return int(T_SKIP_CTX[min(la & 0x3F, 4)][min(ll & 0x3F, 4)])

    def _get_dc_sign_ctx(self, tx, a_arr, a_off, l_arr, l_off):
        t_dim = T_TXFM[tx]
        tw, th = int(t_dim[0]), int(t_dim[1])
        s = 0
        n = 0
        for k in range(tw):
            s += int(a_arr[a_off + k]) >> 6
            n += 1
        for k in range(th):
            s += int(l_arr[l_off + k]) >> 6
            n += 1
        s -= n
        return (s != 0) + (s > 0)


def _findoddzero(buf, off, ln):
    """dav1d decode.c findoddzero:367 (any zero at odd offsets)."""
    for n in range(ln):
        if not buf[off + n * 2]:
            return 1
    return 0


def _neg_deinterleave(diff, ref, max_):
    if not ref:
        return diff
    if ref >= max_ - 1:
        return max_ - diff - 1
    if 2 * ref < max_:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    else:
        if diff <= 2 * (max_ - ref - 1):
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return max_ - (diff + 1)
