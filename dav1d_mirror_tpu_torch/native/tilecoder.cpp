// Copied from dav1d_mirror_tpu/native/tilecoder.cpp.
// Native host entropy stage: the full AV1 tile symbol walk in C++.
//
// This is the decode direction of host/tilecoder.py (the Python
// implementation remains the behavioral spec and the encode-side stream
// generator). One call decodes a whole tile: partition tree, block modes,
// palette, segmentation, delta-q/lf, MV prediction (refmvs), warp
// derivation, tx trees and all coefficient blocks — emitting dense
// record buffers the Python reconstruction stage consumes.
//
// Reference parity (behavior, not code): dav1d src/decode.c
// (decode_sb:2161, decode_b:717, read_pal_indices:442,
// read_mv_residual:120, read_vartx_tree:473, derive_warpmv:292,
// find_matching_ref:219), src/recon_tmpl.c (decode_coefs:321,
// read_coef_blocks:825), src/env.h context derivations, src/refmvs.c
// (dav1d_refmvs_find:348), src/warpmv.c (dav1d_find_affine_int:149,
// dav1d_get_shear_params:80), src/intra_edge.c (init_edges).
//
// CDF rows and spec tables are raw pointers into the numpy-backed
// Python state, so adaptation and downstream consumers
// (cdf_thread_update, reconstruction) are shared with the Python path.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "ec.h"

#define API extern "C" __attribute__((visibility("default")))

// coefficient block decode (msac.cpp), shared with the per-call ctypes path
extern "C" int coef_decode_block(
    ec::Msac *s, uint16_t *eob_bin_cdf, int eob_bin_count,
    uint16_t *eob_hi_bit_cdf, uint16_t *eob_base_cdf, uint16_t *base_cdf,
    uint16_t *br_cdf, uint16_t *dc_sign_cdf, int tx_class, int sw4, int sh4,
    int lw, int lh, const uint16_t *scan, const uint8_t *lo_ctx_offsets,
    int32_t dq_dc, int32_t dq_ac, const uint8_t *qm, int dq_shift,
    int32_t cf_max, int32_t *cf_out, int32_t *eob_out);

namespace {

// ---------------------------------------------------------------
// enums (mirrors host/tilecoder.py, dav1d src/levels.h)
// ---------------------------------------------------------------
enum {
    PARTITION_NONE, PARTITION_H, PARTITION_V, PARTITION_SPLIT,
    PARTITION_T_TOP_SPLIT, PARTITION_T_BOTTOM_SPLIT,
    PARTITION_T_LEFT_SPLIT, PARTITION_T_RIGHT_SPLIT,
    PARTITION_H4, PARTITION_V4,
};
enum { BL_128X128, BL_64X64, BL_32X32, BL_16X16, BL_8X8 };
enum {
    DC_PRED, VERT_PRED, HOR_PRED, DIAG_DOWN_LEFT_PRED,
    DIAG_DOWN_RIGHT_PRED, VERT_RIGHT_PRED, HOR_DOWN_PRED, HOR_UP_PRED,
    VERT_LEFT_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED,
};
constexpr int N_INTRA_PRED_MODES = 13;
constexpr int CFL_PRED = N_INTRA_PRED_MODES;
constexpr int FILTER_PRED = N_INTRA_PRED_MODES;
constexpr int BS_4x4 = 21;
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 };
enum { TX_CLASS_2D, TX_CLASS_H, TX_CLASS_V };
constexpr int DCT_DCT = 0;
constexpr int IDTX = 9;
constexpr int WHT_WHT = 16;
enum { NEARESTMV, NEARMV, GLOBALMV, NEWMV };
enum { NEAREST_DRL, NEARER_DRL, NEAR_DRL, NEARISH_DRL };
enum {
    NEARESTMV_NEARESTMV, NEARMV_NEARMV, NEARESTMV_NEWMV, NEWMV_NEARESTMV,
    NEARMV_NEWMV, NEWMV_NEARMV, GLOBALMV_GLOBALMV, NEWMV_NEWMV,
};
constexpr int N_COMP_INTER_PRED_MODES = 8;
enum {
    COMP_INTER_NONE, COMP_INTER_WEIGHTED_AVG, COMP_INTER_AVG,
    COMP_INTER_SEG, COMP_INTER_WEDGE,
};
enum { MM_TRANSLATION, MM_OBMC, MM_WARP };
enum { INTER_INTRA_NONE, INTER_INTRA_BLEND, INTER_INTRA_WEDGE };
constexpr int N_SWITCHABLE_FILTERS = 3;
enum { WM_TYPE_IDENTITY, WM_TYPE_TRANSLATION, WM_TYPE_ROT_ZOOM,
       WM_TYPE_AFFINE };
constexpr int FILTER_SWITCHABLE = 4;
constexpr int FILTER_8TAP_REGULAR = 0;
constexpr int TX_SWITCHABLE = 2;  // headers.py TX_SWITCHABLE
constexpr int16_t INVALID_MV = -32768;
// pixel layouts (host/headers.py PIXEL_LAYOUT_*)
constexpr int LAYOUT_I400 = 0, LAYOUT_I420 = 1, LAYOUT_I422 = 2,
              LAYOUT_I444 = 3;

// bitsets (host/tilecoder.py CFL_ALLOWED / WEDGE_ALLOWED /
// INTERINTRA_ALLOWED; dav1d src/tables.h:86,97)
constexpr uint32_t WEDGE_ALLOWED_MASK =
    (1u << 7) | (1u << 8) | (1u << 9) | (1u << 11) | (1u << 12) |
    (1u << 13) | (1u << 15) | (1u << 16) | (1u << 17);
constexpr uint32_t INTERINTRA_ALLOWED_MASK =
    (1u << 7) | (1u << 8) | (1u << 11) | (1u << 12) | (1u << 13) |
    (1u << 16) | (1u << 17);

// intra-edge flags (host/intra_edge.py)
constexpr int EDGE_I444_TOP_HAS_RIGHT = 1 << 0;
constexpr int EDGE_I422_TOP_HAS_RIGHT = 1 << 1;
constexpr int EDGE_I420_TOP_HAS_RIGHT = 1 << 2;
constexpr int EDGE_I444_LEFT_HAS_BOTTOM = 1 << 3;
constexpr int EDGE_I422_LEFT_HAS_BOTTOM = 1 << 4;
constexpr int EDGE_I420_LEFT_HAS_BOTTOM = 1 << 5;
constexpr int EDGE_ALL_TOP_HAS_RIGHT = 0x07;
constexpr int EDGE_ALL_LEFT_HAS_BOTTOM = 0x38;
constexpr int EDGE_ALL_TR_AND_BL = 0x3F;

// ---------------------------------------------------------------
// cfg layout — MUST match host/native_tile.py CFG fields
// ---------------------------------------------------------------
enum {
    CFG_SB128, CFG_LAYOUT, CFG_BITDEPTH, CFG_HBD, CFG_MONOCHROME,
    CFG_SS_VER, CFG_SS_HOR, CFG_FILTER_INTRA, CFG_INTER_INTRA,
    CFG_MASKED_COMPOUND, CFG_JNT_COMP, CFG_DUAL_FILTER, CFG_ORDER_HINT,
    CFG_ORDER_HINT_N_BITS, CFG_KEYFRAME, CFG_FRAME_W4, CFG_FRAME_H4,
    CFG_COL_START, CFG_COL_END, CFG_ROW_START, CFG_ROW_END, CFG_SB_STEP,
    CFG_ALLOW_INTRABC, CFG_ALLOW_SCREEN_CONTENT, CFG_FORCE_INTEGER_MV,
    CFG_HP, CFG_SUBPEL_FILTER_MODE, CFG_SWITCHABLE_MOTION_MODE,
    CFG_USE_REF_FRAME_MVS, CFG_QUANT_YAC, CFG_QUANT_YDC_DELTA,
    CFG_QUANT_UDC_DELTA, CFG_QUANT_UAC_DELTA, CFG_QUANT_VDC_DELTA,
    CFG_QUANT_VAC_DELTA, CFG_QUANT_QM, CFG_SEG_ENABLED,
    CFG_SEG_UPDATE_MAP, CFG_SEG_TEMPORAL, CFG_SEG_PRESKIP,
    CFG_SEG_LAST_ACTIVE,
    CFG_SEG_DATA,                       // 8 * 8 ints
    CFG_SEG_QIDX = CFG_SEG_DATA + 64,   // 8
    CFG_SEG_LOSSLESS = CFG_SEG_QIDX + 8,  // 8
    CFG_DELTA_Q_PRESENT = CFG_SEG_LOSSLESS + 8,
    CFG_DELTA_Q_RES_LOG2, CFG_DELTA_LF_PRESENT, CFG_DELTA_LF_RES_LOG2,
    CFG_DELTA_LF_MULTI, CFG_LF_LEVEL_Y0, CFG_LF_LEVEL_Y1, CFG_LF_LEVEL_U,
    CFG_LF_LEVEL_V, CFG_LF_MODE_REF_DELTA_ENABLED,
    CFG_LF_MODE_DELTA,                  // 2
    CFG_LF_REF_DELTA = CFG_LF_MODE_DELTA + 2,  // 8
    CFG_CDEF_N_BITS = CFG_LF_REF_DELTA + 8,
    CFG_RESTORATION_TYPE,               // 3
    CFG_RESTORATION_UNIT_SIZE = CFG_RESTORATION_TYPE + 3,  // 2
    CFG_SUPER_RES_DENOM = CFG_RESTORATION_UNIT_SIZE + 2,
    CFG_FRAME_WIDTH0, CFG_FRAME_WIDTH1, CFG_FRAME_HEIGHT,
    CFG_TXFM_MODE, CFG_SWITCHABLE_COMP_REFS, CFG_SKIP_MODE_ENABLED,
    CFG_SKIP_MODE_REFS,                 // 2
    CFG_WARP_MOTION = CFG_SKIP_MODE_REFS + 2,
    CFG_REDUCED_TXTP_SET, CFG_FRAME_OFFSET,
    CFG_GMV,                            // 7 * 7 (type + matrix[6])
    CFG_REF_POC = CFG_GMV + 49,         // 7
    CFG_REF_SCALED = CFG_REF_POC + 7,   // 7
    CFG_DISABLE_CDF_UPDATE = CFG_REF_SCALED + 7,
    CFG_BLOCKS_CAP, CFG_COEFS_CAP, CFG_CF_CAP, CFG_PAL_CAP,
    CFG_PALIDX_CAP, CFG_LR_CAP, CFG_CDEF_CAP,
    CFG_RF_PRESENT, CFG_RF_IW4, CFG_RF_IH4, CFG_RF_IW8, CFG_RF_STRIDE4,
    CFG_RF_USE_REF_FRAME_MVS,
    CFG_RF_SIGN_BIAS,                   // 7
    CFG_RF_POCDIFF = CFG_RF_SIGN_BIAS + 7,  // 7
    CFG_RP_PROJ_STRIDE8 = CFG_RF_POCDIFF + 7,
    CFG_N,
};

// table pointer indices — MUST match host/native_tile.py TABS
enum {
    TAB_BLOCK_DIM, TAB_BLOCK_SIZES, TAB_AL_PART_CTX, TAB_PART_COUNT,
    TAB_MAX_TX, TAB_TXFM, TAB_INTRA_MODE_CTX, TAB_YMODE_SIZE_CTX,
    TAB_TXTP_FROM_UVMODE, TAB_TX_TYPES_PER_SET, TAB_TX_TYPE_CLASS,
    TAB_LO_CTX_OFFSETS, TAB_SKIP_CTX, TAB_DQ, TAB_COMP_INTER_MODES,
    TAB_FILTER_2D, TAB_WEDGE_CTX, TAB_FILTER_MODE_TO_Y_MODE,
    TAB_SGR_PARAMS,
    TAB_SCAN0,                          // 19 scan tables
    TAB_QM = TAB_SCAN0 + 19,            // 19 * 3 qm pointers (or 0)
    TAB_N = TAB_QM + 57,
};

// cdf pointer indices — MUST match host/native_tile.py CDF_FIELDS
enum {
    // m dict
    CDF_PARTITION,        // [5][4][16]
    CDF_SKIP,             // [3][2]
    CDF_SKIP_MODE,        // [3][2]
    CDF_SEG_PRED,         // [3][2]
    CDF_SEG_ID,           // [3][8]
    CDF_CDEF_UNUSED,      // placeholder (cdef bits are raw)
    CDF_DELTA_Q,          // [4]
    CDF_DELTA_LF,         // [5][4]
    CDF_INTRA,            // [4][2]
    CDF_INTRABC,          // [2]
    CDF_Y_MODE,           // [4][16]
    CDF_ANGLE_DELTA,      // [8][8]
    CDF_UV_MODE,          // [2][13][16]
    CDF_CFL_SIGN,         // [8]
    CDF_CFL_ALPHA,        // [6][16]
    CDF_PAL_Y,            // [7][3][2]
    CDF_PAL_UV,           // [2][2]
    CDF_PAL_SZ,           // [2][7][8]
    CDF_COLOR_MAP,        // [2][7][5][8]
    CDF_USE_FILTER_INTRA, // [22][2]
    CDF_FILTER_INTRA,     // [8]
    CDF_TXSZ,             // [4][3][4]
    CDF_TXPART,           // [7][3][2]
    CDF_TXTP_INTRA1,      // [2][13][8]
    CDF_TXTP_INTRA2,      // [3][13][8]
    CDF_TXTP_INTER1,      // [2][16]
    CDF_TXTP_INTER2,      // [16]
    CDF_TXTP_INTER3,      // [4][2]
    CDF_COMP,             // [5][2]
    CDF_COMP_DIR,         // [5][2]
    CDF_COMP_FWD_REF,     // [3][3][2]
    CDF_COMP_BWD_REF,     // [2][3][2]
    CDF_COMP_UNI_REF,     // [3][3][2]
    CDF_REF,              // [6][3][2]
    CDF_COMP_INTER_MODE,  // [8][8]
    CDF_NEWMV_MODE,       // [6][2]
    CDF_GLOBALMV_MODE,    // [2][2]
    CDF_REFMV_MODE,       // [6][2]
    CDF_DRL_BIT,          // [3][2]
    CDF_INTERINTRA,       // [7][2]
    CDF_INTERINTRA_MODE,  // [4][4]
    CDF_INTERINTRA_WEDGE, // [7][2]
    CDF_WEDGE_COMP,       // [9][2]
    CDF_WEDGE_IDX,        // [9][16]
    CDF_JNT_COMP,         // [6][2]
    CDF_MASK_COMP,        // [6][2]
    CDF_OBMC,             // [22][2]
    CDF_MOTION_MODE,      // [22][4]
    CDF_FILTER,           // [2][8][4]
    CDF_RESTORE_WIENER,   // [2]
    CDF_RESTORE_SGRPROJ,  // [2]
    CDF_RESTORE_SWITCHABLE,  // [4]
    // coef dict
    CDF_C_SKIP,           // [5][13][2]
    CDF_C_EOB_BIN_16,     // [2][2][8]
    CDF_C_EOB_BIN_32,     // [2][2][8]
    CDF_C_EOB_BIN_64,     // [2][2][8]
    CDF_C_EOB_BIN_128,    // [2][2][8]
    CDF_C_EOB_BIN_256,    // [2][2][16]
    CDF_C_EOB_BIN_512,    // [2][16]
    CDF_C_EOB_BIN_1024,   // [2][16]
    CDF_C_EOB_HI_BIT,     // [5][2][11][2]
    CDF_C_EOB_BASE_TOK,   // [5][2][4][4]
    CDF_C_BASE_TOK,       // [5][2][41][4]
    CDF_C_DC_SIGN,        // [2][3][2]
    CDF_C_BR_TOK,         // [4][2][21][4]
    // mv (regular) — joint + comp0.* + comp1.*
    CDF_MV_JOINT,         // [4]
    CDF_MV0_CLASSES, CDF_MV0_CLASS0, CDF_MV0_CLASSN,      // [16],[2],[10][2]
    CDF_MV0_CLASS0_FP, CDF_MV0_CLASSN_FP,                 // [2][4],[4]
    CDF_MV0_CLASS0_HP, CDF_MV0_CLASSN_HP, CDF_MV0_SIGN,   // [2],[2],[2]
    CDF_MV1_CLASSES, CDF_MV1_CLASS0, CDF_MV1_CLASSN,
    CDF_MV1_CLASS0_FP, CDF_MV1_CLASSN_FP,
    CDF_MV1_CLASS0_HP, CDF_MV1_CLASSN_HP, CDF_MV1_SIGN,
    // dmv (intrabc)
    CDF_DMV_JOINT,
    CDF_DMV0_CLASSES, CDF_DMV0_CLASS0, CDF_DMV0_CLASSN,
    CDF_DMV0_CLASS0_FP, CDF_DMV0_CLASSN_FP,
    CDF_DMV0_CLASS0_HP, CDF_DMV0_CLASSN_HP, CDF_DMV0_SIGN,
    CDF_DMV1_CLASSES, CDF_DMV1_CLASS0, CDF_DMV1_CLASSN,
    CDF_DMV1_CLASS0_FP, CDF_DMV1_CLASSN_FP,
    CDF_DMV1_CLASS0_HP, CDF_DMV1_CLASSN_HP, CDF_DMV1_SIGN,
    CDF_KFYM,             // [5][5][16]
    CDF_COUNT,
};

// rf pointer indices — MUST match host/native_tile.py RF_PTRS
enum {
    RFP_REF,          // int8  [ih4][stride4][2]
    RFP_MV,           // int16 [ih4][stride4][2][2]
    RFP_BS,           // uint8 [ih4][stride4]
    RFP_MF,           // uint8 [ih4][stride4]
    RFP_RP_PROJ_MV,   // int16 [ih8][w8pad][2]
    RFP_RP_PROJ_REF,  // uint8 [ih8][w8pad]
    RFP_N,
};

// misc pointers
enum { MISC_PREV_SEGMAP, MISC_SEG_MAP, MISC_N };

// out pointers
enum {
    OUT_BLK, OUT_COEF, OUT_CF, OUT_PAL, OUT_PALIDX, OUT_LR, OUT_CDEF,
    OUT_COUNTS, OUT_N,
};

// block record fields — MUST match host/native_tile.py BLK fields
enum {
    B_BL, B_BP, B_BS, B_BX, B_BY, B_SEG_ID, B_SKIP_MODE, B_SKIP, B_INTRA,
    B_Y_MODE, B_Y_ANGLE, B_UV_MODE, B_UV_ANGLE, B_CFL_A0, B_CFL_A1,
    B_PAL_SZ0, B_PAL_SZ1, B_TX, B_UVTX, B_MAX_YTX, B_TX_SPLIT0,
    B_TX_SPLIT1, B_INTER_MODE, B_DRL_IDX, B_REF0, B_REF1, B_MV0Y, B_MV0X,
    B_MV1Y, B_MV1X, B_COMP_TYPE, B_MOTION_MODE, B_INTERINTRA_TYPE,
    B_INTERINTRA_MODE, B_WEDGE_IDX, B_MASK_SIGN, B_FILTER2D, B_QIDX,
    B_EDGE_FLAGS, B_LF0, B_LF1, B_LF2, B_LF3, B_COEF_LO, B_COEF_HI,
    B_PAL_OFF, B_PALIDX_Y_OFF, B_PALIDX_UV_OFF, B_WARP_VALID,
    B_WARP_MAT0, B_WARP_MAT1, B_WARP_MAT2, B_WARP_MAT3, B_WARP_MAT4,
    B_WARP_MAT5, B_WARP_ALPHA, B_WARP_BETA, B_WARP_GAMMA, B_WARP_DELTA,
    B_NFIELDS,
};

// coef record fields
enum {
    C_PLANE, C_X, C_Y, C_TX, C_TXTP, C_EOB, C_CF_OFF, C_CF_LEN, C_NFIELDS,
};

// lr record fields: p, row, col, type, fv0-2, fh0-2, sw0, sw1
constexpr int LR_NFIELDS = 12;
// cdef record: bx, by, idx0-3
constexpr int CDEF_NFIELDS = 6;

// ---------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------
inline int iclip(int v, int lo, int hi) {
    return v < lo ? lo : v > hi ? hi : v;
}
inline int64_t iclip64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : v > hi ? hi : v;
}
inline int iclip_u8(int v) { return iclip(v, 0, 255); }
inline int s16(int64_t v) {
    v &= 0xFFFF;
    return (int)(v >= 0x8000 ? v - 0x10000 : v);
}
inline int apply_sign(int v, int64_t s) { return s < 0 ? -v : v; }
inline int64_t apply_sign64(int64_t v, int64_t s) { return s < 0 ? -v : v; }
inline int ulog2(uint32_t v) { return 31 - __builtin_clz(v); }

struct MV {
    int y, x;
    bool operator==(const MV &o) const { return y == o.y && x == o.x; }
    bool operator!=(const MV &o) const { return !(*this == o); }
};

// ---------------------------------------------------------------
// intra-edge availability tree (host/intra_edge.py; dav1d
// src/intra_edge.c:51-146)
// ---------------------------------------------------------------
struct EdgeNode {
    int o, h[2], v[2], h4, v4;
    bool is_tip;
    int tip_split[3];        // tip: edge-flag ints
    EdgeNode *split[4];      // branch: children
};

EdgeNode *make_tip(int edge_flags) {
    EdgeNode *n = new EdgeNode();
    n->is_tip = true;
    n->o = edge_flags;
    n->h[0] = edge_flags | EDGE_ALL_LEFT_HAS_BOTTOM;
    n->h[1] = edge_flags & (EDGE_ALL_LEFT_HAS_BOTTOM |
                            EDGE_I420_TOP_HAS_RIGHT);
    n->v[0] = edge_flags | EDGE_ALL_TOP_HAS_RIGHT;
    n->v[1] = edge_flags & (EDGE_ALL_TOP_HAS_RIGHT |
                            EDGE_I420_LEFT_HAS_BOTTOM |
                            EDGE_I422_LEFT_HAS_BOTTOM);
    n->tip_split[0] = (edge_flags & EDGE_ALL_TOP_HAS_RIGHT) |
                      EDGE_I422_LEFT_HAS_BOTTOM;
    n->tip_split[1] = edge_flags | EDGE_I444_TOP_HAS_RIGHT;
    n->tip_split[2] = edge_flags & (EDGE_I420_TOP_HAS_RIGHT |
                                    EDGE_I420_LEFT_HAS_BOTTOM |
                                    EDGE_I422_LEFT_HAS_BOTTOM);
    return n;
}

EdgeNode *make_branch(int bl, int edge_flags, int top_has_right,
                      int left_has_bottom) {
    EdgeNode *n = new EdgeNode();
    n->is_tip = false;
    n->o = edge_flags;
    n->h[0] = edge_flags | EDGE_ALL_LEFT_HAS_BOTTOM;
    n->h[1] = edge_flags & EDGE_ALL_LEFT_HAS_BOTTOM;
    n->v[0] = edge_flags | EDGE_ALL_TOP_HAS_RIGHT;
    n->v[1] = edge_flags & EDGE_ALL_TOP_HAS_RIGHT;
    n->h4 = EDGE_ALL_LEFT_HAS_BOTTOM;
    n->v4 = EDGE_ALL_TOP_HAS_RIGHT;
    if (bl == BL_16X16) {
        n->h4 |= edge_flags & EDGE_I420_TOP_HAS_RIGHT;
        n->v4 |= edge_flags & (EDGE_I420_LEFT_HAS_BOTTOM |
                               EDGE_I422_LEFT_HAS_BOTTOM);
    }
    for (int i = 0; i < 4; i++) {
        const int thr = !(i == 3 || (i == 1 && !top_has_right));
        const int lhb = (i == 0) || (i == 2 && left_has_bottom);
        const int flags = (thr ? EDGE_ALL_TOP_HAS_RIGHT : 0) |
                          (lhb ? EDGE_ALL_LEFT_HAS_BOTTOM : 0);
        n->split[i] = (bl == BL_16X16) ? make_tip(flags)
                                       : make_branch(bl + 1, flags, thr, lhb);
    }
    return n;
}

const EdgeNode *edge_root(int bl) {
    static EdgeNode *root128 = nullptr, *root64 = nullptr;
    if (bl == BL_128X128) {
        if (!root128)
            root128 = make_branch(BL_128X128, EDGE_ALL_TOP_HAS_RIGHT, 1, 0);
        return root128;
    }
    if (!root64)
        root64 = make_branch(BL_64X64, EDGE_ALL_TOP_HAS_RIGHT, 1, 0);
    return root64;
}

// ---------------------------------------------------------------
// BlockContext (host/tilecoder.py BlockContext; dav1d env.h)
// ---------------------------------------------------------------
struct BlockContext {
    uint8_t mode[32], lcoef[32], seg_pred[32], skip[32], skip_mode[32],
        intra[32], comp_type[32], tx_lpf_y[32], tx_lpf_uv[32], uvmode[32],
        pal_sz[32];
    int8_t tx_intra[32], tx[32];
    uint8_t ccoef[2][32];
    int8_t ref[2][32];
    uint8_t filter[2][32];
    uint8_t partition[16];

    void reset(bool keyframe) {
        memset(intra, keyframe ? 1 : 0, 32);
        memset(uvmode, DC_PRED, 32);
        memset(mode, keyframe ? DC_PRED : 0, 32);
        memset(partition, 0, 16);
        memset(skip, 0, 32);
        memset(skip_mode, 0, 32);
        memset(tx_lpf_y, 2, 32);
        memset(tx_lpf_uv, 1, 32);
        memset(tx_intra, -1, 32);
        memset(tx, TX_64X64, 32);
        if (!keyframe) {
            memset(ref, -1, sizeof(ref));
            memset(comp_type, 0, 32);
        }
        memset(lcoef, 0x40, 32);
        memset(ccoef, 0x40, sizeof(ccoef));
        memset(filter, 3, sizeof(filter));
        memset(seg_pred, 0, 32);
        memset(pal_sz, 0, 32);
    }
};

// ---------------------------------------------------------------
// Tile decoder state
// ---------------------------------------------------------------
struct Warp {
    int valid;  // 1 => WM_TYPE_AFFINE
    int32_t mat[6];
    int alpha, beta, gamma, delta;
};

struct TileDec {
    const int32_t *cfg;
    uint64_t const *tab, *cdfp, *rfp, *misc, *outp;
    ec::Msac m;

    // frequently used cfg
    int sb128, layout, bitdepth, hbd, monochrome, ss_ver, ss_hor;
    int keyframe, bw, bh, col_start, col_end, row_start, row_end, sb_step;
    int frame_w4, frame_h4;
    int seg_enabled;

    // tables
    const uint8_t *t_blockdim;      // [22][4]
    const uint8_t *t_blocksizes;    // [5][10][2]
    const uint8_t *t_alpartctx;     // [2][5][10]
    const uint8_t *t_partcount;     // [5]
    const uint8_t *t_maxtx;         // [22][4]
    const uint8_t *t_txfm;          // [19][8]
    const uint8_t *t_intramodectx;  // [13]
    const uint8_t *t_ymodesizectx;  // [22]
    const uint8_t *t_txtpfromuv;    // [14]
    const uint8_t *t_txtypesperset; // [40]
    const uint8_t *t_txtypeclass;   // [17]
    const uint8_t *t_loctxoff;      // [3][5][5]
    const uint8_t *t_skipctx;       // [5][5]
    const uint16_t *t_dq;           // [3][256][2]
    const uint8_t *t_compintermodes;// [8][2]
    const uint8_t *t_filter2d;      // [4][4]
    const uint8_t *t_wedgectx;      // [22]
    const uint8_t *t_filt2ymode;    // [5]
    const uint16_t *t_sgrparams;    // [16][2]
    const uint16_t *t_scan[19];
    const uint8_t *t_qm[19][3];

    // contexts
    std::vector<BlockContext> a_arr;
    BlockContext l;
    BlockContext *a_cur;  // set per decode position via a_at()

    // quant state
    int32_t dq_frame[8][3][2];
    int32_t dq_cur[8][3][2];
    int last_qidx;
    int last_delta_lf[4];

    // palette above/left caches (full-frame dense)
    std::vector<uint16_t> al_pal_x;   // [bw][3][8]
    std::vector<uint16_t> al_pal_y;   // [bh][3][8]
    std::vector<uint8_t> pal_sz_uv_x; // [bw]
    std::vector<uint8_t> pal_sz_uv_y; // [bh]

    // seg map
    uint8_t *seg_map;           // [bh][bw] or null
    const uint8_t *prev_segmap; // or null

    // lr state
    int restore_planes;
    struct { int type; int fv[3], fh[3], sw[2]; } lr_ref[3];

    // per-sb state
    int cur_sb_cdef_idx[4];
    uint8_t txtp_map[32 * 32];

    // refmvs
    int rf_present, rf_iw4, rf_ih4, rf_iw8, rf_stride4, rf_use_tmvs;
    int sign_bias[7], pocdiff[7];
    int rp_stride8;
    int8_t *rf_ref;       // [ih4][stride4][2]
    int16_t *rf_mv;       // [ih4][stride4][2][2]
    uint8_t *rf_bs;       // [ih4][stride4]
    uint8_t *rf_mf;       // [ih4][stride4]
    const int16_t *rp_proj_mv;   // [ih8][w8pad][2]
    const uint8_t *rp_proj_ref;  // [ih8][w8pad]

    // outputs
    int32_t *blk;
    int32_t *coef;
    int32_t *cf;
    uint16_t *pal;
    uint8_t *palidx;
    int32_t *lr_rec;
    int32_t *cdef_rec;
    int64_t n_blocks, n_coefs, cf_used, pal_used, palidx_used, n_lr, n_cdef;
    int64_t blocks_cap, coefs_cap, cf_cap, pal_cap, palidx_cap, lr_cap,
        cdef_cap;
    int err;

    // ---- accessors ----
    const uint8_t *bdim(int bs) const { return t_blockdim + 4 * bs; }
    const uint8_t *txdim(int tx) const { return t_txfm + 8 * tx; }
    uint16_t *cdf(int idx) const { return (uint16_t *)cdfp[idx]; }
    BlockContext &a_at(int bx) {
        return a_arr[(bx - (col_start & ~31)) >> 5];
    }
    int seg_field(int seg_id, int field) const {
        return cfg[CFG_SEG_DATA + seg_id * 8 + field];
    }
    // seg fields: 0 delta_q, 1 dlf_y_v, 2 dlf_y_h, 3 dlf_u, 4 dlf_v,
    //             5 ref, 6 skip, 7 globalmv
    const int32_t *gmv(int ref) const { return cfg + CFG_GMV + 7 * ref; }

    int8_t *rf_ref_at(int y, int x) { return rf_ref + 2 * (y * rf_stride4 + x); }
    int16_t *rf_mv_at(int y, int x) { return rf_mv + 4 * (y * rf_stride4 + x); }
};

// Block record under construction
struct Blk {
    int32_t f[B_NFIELDS];
    void init() {
        memset(f, 0, sizeof(f));
        f[B_REF0] = f[B_REF1] = -1;
        f[B_INTRA] = 1;
        f[B_PAL_OFF] = f[B_PALIDX_Y_OFF] = f[B_PALIDX_UV_OFF] = -1;
    }
};

// ---------------------------------------------------------------
// env.h context derivations (host/tilecoder.py:233-437;
// dav1d src/env.h:59-438)
// ---------------------------------------------------------------
int get_intra_ctx(const BlockContext &a, const BlockContext &l, int by4,
                  int bx4, int have_top, int have_left) {
    if (have_left) {
        if (have_top) {
            const int ctx = l.intra[by4] + a.intra[bx4];
            return ctx + (ctx == 2);
        }
        return l.intra[by4] * 2;
    }
    return have_top ? a.intra[bx4] * 2 : 0;
}

int get_comp_ctx(const BlockContext &a, const BlockContext &l, int by4,
                 int bx4, int have_top, int have_left) {
    if (have_top) {
        if (have_left) {
            if (a.comp_type[bx4]) {
                if (l.comp_type[by4]) return 4;
                return 2 + (l.ref[0][by4] >= 4 || l.ref[0][by4] < 0);
            }
            if (l.comp_type[by4])
                return 2 + (a.ref[0][bx4] >= 4 || a.ref[0][bx4] < 0);
            return (l.ref[0][by4] >= 4) ^ (a.ref[0][bx4] >= 4);
        }
        return a.comp_type[bx4] ? 3 : (a.ref[0][bx4] >= 4);
    }
    if (have_left) return l.comp_type[by4] ? 3 : (l.ref[0][by4] >= 4);
    return 1;
}

inline bool has_uni_comp(const BlockContext &e, int off) {
    return (e.ref[0][off] < 4) == (e.ref[1][off] < 4);
}

int get_comp_dir_ctx(const BlockContext &a, const BlockContext &l, int by4,
                     int bx4, int have_top, int have_left) {
    if (have_top && have_left) {
        const int a_intra = a.intra[bx4], l_intra = l.intra[by4];
        if (a_intra && l_intra) return 2;
        if (a_intra || l_intra) {
            const BlockContext &e = a_intra ? l : a;
            const int off = a_intra ? by4 : bx4;
            if (e.comp_type[off] == COMP_INTER_NONE) return 2;
            return 1 + 2 * (int)has_uni_comp(e, off);
        }
        const bool a_comp = a.comp_type[bx4] != COMP_INTER_NONE;
        const bool l_comp = l.comp_type[by4] != COMP_INTER_NONE;
        const int a_ref0 = a.ref[0][bx4], l_ref0 = l.ref[0][by4];
        if (!a_comp && !l_comp)
            return 1 + 2 * (int)((a_ref0 >= 4) == (l_ref0 >= 4));
        if (!a_comp || !l_comp) {
            const BlockContext &e = a_comp ? a : l;
            const int off = a_comp ? bx4 : by4;
            if (!has_uni_comp(e, off)) return 1;
            return 3 + (int)((a_ref0 >= 4) == (l_ref0 >= 4));
        }
        const bool a_uni = has_uni_comp(a, bx4), l_uni = has_uni_comp(l, by4);
        if (!a_uni && !l_uni) return 0;
        if (!a_uni || !l_uni) return 2;
        return 3 + (int)((a_ref0 == 4) == (l_ref0 == 4));
    }
    if (have_top || have_left) {
        const BlockContext &e = have_left ? l : a;
        const int off = have_left ? by4 : bx4;
        if (e.intra[off]) return 2;
        if (e.comp_type[off] == COMP_INTER_NONE) return 2;
        return 4 * (int)has_uni_comp(e, off);
    }
    return 2;
}

struct RefCnts {
    int refs[4];
    int n;
};

RefCnts ref_cnts(const BlockContext &a, const BlockContext &l, int by4,
                 int bx4, int have_top, int have_left) {
    RefCnts rc;
    rc.n = 0;
    if (have_top && !a.intra[bx4]) {
        rc.refs[rc.n++] = a.ref[0][bx4];
        if (a.comp_type[bx4]) rc.refs[rc.n++] = a.ref[1][bx4];
    }
    if (have_left && !l.intra[by4]) {
        rc.refs[rc.n++] = l.ref[0][by4];
        if (l.comp_type[by4]) rc.refs[rc.n++] = l.ref[1][by4];
    }
    return rc;
}

inline int cnt_ctx(int c0, int c1) {
    return c0 == c1 ? 1 : (c0 < c1 ? 0 : 2);
}

int get_ref_ctx(const BlockContext &a, const BlockContext &l, int by4,
                int bx4, int have_top, int have_left) {
    RefCnts rc = ref_cnts(a, l, by4, bx4, have_top, have_left);
    int c[2] = {0, 0};
    for (int i = 0; i < rc.n; i++) c[rc.refs[i] >= 4]++;
    return cnt_ctx(c[0], c[1]);
}

int get_fwd_ref_ctx(const BlockContext &a, const BlockContext &l, int by4,
                    int bx4, int have_top, int have_left) {
    RefCnts rc = ref_cnts(a, l, by4, bx4, have_top, have_left);
    int c[4] = {0, 0, 0, 0};
    for (int i = 0; i < rc.n; i++) {
        const int r = rc.refs[i];
        if (r >= 0 && r < 4) c[r]++;
    }
    return cnt_ctx(c[0] + c[1], c[2] + c[3]);
}

int get_fwd_ref_1_ctx(const BlockContext &a, const BlockContext &l, int by4,
                      int bx4, int have_top, int have_left) {
    RefCnts rc = ref_cnts(a, l, by4, bx4, have_top, have_left);
    int c[2] = {0, 0};
    for (int i = 0; i < rc.n; i++) {
        const int r = rc.refs[i];
        if (r >= 0 && r < 2) c[r]++;
    }
    return cnt_ctx(c[0], c[1]);
}

int get_fwd_ref_2_ctx(const BlockContext &a, const BlockContext &l, int by4,
                      int bx4, int have_top, int have_left) {
    RefCnts rc = ref_cnts(a, l, by4, bx4, have_top, have_left);
    int c[2] = {0, 0};
    for (int i = 0; i < rc.n; i++) {
        const int r = rc.refs[i];
        if (r >= 2 && r < 4) c[r - 2]++;
    }
    return cnt_ctx(c[0], c[1]);
}

int get_bwd_ref_ctx(const BlockContext &a, const BlockContext &l, int by4,
                    int bx4, int have_top, int have_left) {
    RefCnts rc = ref_cnts(a, l, by4, bx4, have_top, have_left);
    int c[3] = {0, 0, 0};
    for (int i = 0; i < rc.n; i++) {
        const int r = rc.refs[i];
        if (r >= 4) c[r - 4]++;
    }
    return cnt_ctx(c[1] + c[0], c[2]);
}

int get_bwd_ref_1_ctx(const BlockContext &a, const BlockContext &l, int by4,
                      int bx4, int have_top, int have_left) {
    RefCnts rc = ref_cnts(a, l, by4, bx4, have_top, have_left);
    int c[3] = {0, 0, 0};
    for (int i = 0; i < rc.n; i++) {
        const int r = rc.refs[i];
        if (r >= 4) c[r - 4]++;
    }
    return cnt_ctx(c[0], c[1]);
}

int get_uni_p1_ctx(const BlockContext &a, const BlockContext &l, int by4,
                   int bx4, int have_top, int have_left) {
    RefCnts rc = ref_cnts(a, l, by4, bx4, have_top, have_left);
    int c[3] = {0, 0, 0};
    for (int i = 0; i < rc.n; i++) {
        const int r = rc.refs[i];
        if (r >= 1 && r < 4) c[r - 1]++;
    }
    return cnt_ctx(c[0], c[1] + c[2]);
}

int get_jnt_comp_ctx(int order_hint_n_bits, int poc, int ref0poc,
                     int ref1poc, const BlockContext &a,
                     const BlockContext &l, int by4, int bx4) {
    auto poc_diff = [&](int p0, int p1) -> int {
        if (!order_hint_n_bits) return 0;
        const int mask = 1 << (order_hint_n_bits - 1);
        const int diff = p0 - p1;
        return (diff & (mask - 1)) - (diff & mask);
    };
    const int d0 = abs(poc_diff(ref0poc, poc));
    const int d1 = abs(poc_diff(poc, ref1poc));
    const int offset = (d0 == d1);
    const int a_ctx = a.comp_type[bx4] >= COMP_INTER_AVG ||
                      a.ref[0][bx4] == 6;
    const int l_ctx = l.comp_type[by4] >= COMP_INTER_AVG ||
                      l.ref[0][by4] == 6;
    return 3 * offset + a_ctx + l_ctx;
}

int get_mask_comp_ctx(const BlockContext &a, const BlockContext &l, int by4,
                      int bx4) {
    const int a_ctx = a.comp_type[bx4] >= COMP_INTER_SEG
                          ? 1
                          : (a.ref[0][bx4] == 6 ? 3 : 0);
    const int l_ctx = l.comp_type[by4] >= COMP_INTER_SEG
                          ? 1
                          : (l.ref[0][by4] == 6 ? 3 : 0);
    const int v = a_ctx + l_ctx;
    return v < 5 ? v : 5;
}

int get_filter_ctx(const BlockContext &a, const BlockContext &l, int comp,
                   int dir, int ref, int by4, int bx4) {
    const int a_filter = (a.ref[0][bx4] == ref || a.ref[1][bx4] == ref)
                             ? a.filter[dir][bx4]
                             : N_SWITCHABLE_FILTERS;
    const int l_filter = (l.ref[0][by4] == ref || l.ref[1][by4] == ref)
                             ? l.filter[dir][by4]
                             : N_SWITCHABLE_FILTERS;
    if (a_filter == l_filter) return comp * 4 + a_filter;
    if (a_filter == N_SWITCHABLE_FILTERS) return comp * 4 + l_filter;
    if (l_filter == N_SWITCHABLE_FILTERS) return comp * 4 + a_filter;
    return comp * 4 + N_SWITCHABLE_FILTERS;
}

int get_uv_inter_txtp(const uint8_t *uvt_dim, int ytxtp) {
    // dav1d env.h get_uv_inter_txtp:120
    const int H_ADST = 12, V_ADST = 13, H_FLIPADST = 14, V_FLIPADST = 15;
    if (uvt_dim[5] == TX_32X32) return ytxtp == IDTX ? IDTX : DCT_DCT;
    if (uvt_dim[4] == TX_16X16 &&
        (ytxtp == H_FLIPADST || ytxtp == V_FLIPADST || ytxtp == H_ADST ||
         ytxtp == V_ADST))
        return DCT_DCT;
    return ytxtp;
}

int findoddzero(const uint8_t *buf, int off, int len) {
    // dav1d decode.c findoddzero:367
    for (int n = 0; n < len; n++)
        if (!buf[off + n * 2]) return 1;
    return 0;
}

int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
        if (diff <= 2 * ref)
            return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
        return diff;
    }
    if (diff <= 2 * (max - ref - 1))
        return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return max - (diff + 1);
}

// ---------------------------------------------------------------
// gmv helpers (host/refmvs.py; dav1d src/env.h:461-520)
// ---------------------------------------------------------------
MV fix_int_mv_precision(MV mv) {
    // dav1d env.h fix_int_mv_precision:461
    int y = mv.y, x = mv.x;
    x = (x - (x >> 15) + 3) & ~7;
    y = (y - (y >> 15) + 3) & ~7;
    return {s16(y), s16(x)};
}

MV fix_mv_precision(const TileDec &t, MV mv) {
    // dav1d env.h fix_mv_precision:468
    if (t.cfg[CFG_FORCE_INTEGER_MV]) return fix_int_mv_precision(mv);
    if (!t.cfg[CFG_HP])
        return {s16((mv.y - (mv.y >> 15)) & ~1),
                s16((mv.x - (mv.x >> 15)) & ~1)};
    return mv;
}

MV get_gmv_2d(const TileDec &t, const int32_t *gm, int bx4, int by4,
              int bw4, int bh4) {
    // dav1d env.h get_gmv_2d:479; gm = [type, matrix0..5]
    const int type = gm[0];
    const int32_t *mat = gm + 1;
    if (type == WM_TYPE_IDENTITY) return {0, 0};
    if (type == WM_TYPE_TRANSLATION) {
        MV res = {mat[0] >> 13, mat[1] >> 13};
        if (t.cfg[CFG_FORCE_INTEGER_MV]) res = fix_int_mv_precision(res);
        return res;
    }
    const int hp = t.cfg[CFG_HP];
    const int64_t x = bx4 * 4 + bw4 * 2 - 1;
    const int64_t y = by4 * 4 + bh4 * 2 - 1;
    const int64_t xc = ((int64_t)mat[2] - (1 << 16)) * x +
                       (int64_t)mat[3] * y + mat[0];
    const int64_t yc = ((int64_t)mat[5] - (1 << 16)) * y +
                       (int64_t)mat[4] * x + mat[1];
    const int shift = 16 - (3 - (hp ? 0 : 1));
    const int64_t rnd = (1ll << shift) >> 1;
    const int64_t ay = ((llabs(yc) + rnd) >> shift) << (hp ? 0 : 1);
    const int64_t ax = ((llabs(xc) + rnd) >> shift) << (hp ? 0 : 1);
    MV res = {s16(apply_sign64(ay, yc)), s16(apply_sign64(ax, xc))};
    if (t.cfg[CFG_FORCE_INTEGER_MV]) res = fix_int_mv_precision(res);
    return res;
}

const int DIV_MULT[32] = {
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638, 1489,
    1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819, 780, 744, 712, 682,
    655, 630, 606, 585, 564, 546, 528,
};

MV mv_projection(MV mv, int num, int den) {
    // dav1d refmvs.c mv_projection:175
    const int64_t frac = (int64_t)num * DIV_MULT[den];
    const int64_t y = mv.y * frac;
    const int64_t x = mv.x * frac;
    return {(int)iclip64((y + 8192 + (y < 0 ? -1 : 0)) >> 14, -0x3FFF,
                         0x3FFF),
            (int)iclip64((x + 8192 + (x < 0 ? -1 : 0)) >> 14, -0x3FFF,
                         0x3FFF)};
}

// ---------------------------------------------------------------
// refmvs candidate stack (host/refmvs.py refmvs_find;
// dav1d src/refmvs.c:41-520)
// ---------------------------------------------------------------
struct Cand {
    MV mv0, mv1;
    bool has1;
    int weight;
};

struct MvStack {
    Cand c[8];
    int n;
};

struct FindResult {
    // mvstack padded to >= 2 entries: (mv0, mv1, weight)
    MV mv0[8], mv1[8];
    int weight[8];
    int n_out;   // padded count (>= 2)
    int n_mvs;   // real count
    int ctx;
};

// add_spatial_candidate:41 — returns (newmv, refmv) packed
struct NmRm { int nm, rm; };

NmRm add_spatial_candidate(TileDec &t, MvStack &st, int weight, int cy,
                           int cx, const int ref[2], const MV *gmv0,
                           const MV *gmv1) {
    const int16_t *bmv = t.rf_mv_at(cy, cx);
    if (bmv[0] == INVALID_MV && bmv[1] == INVALID_MV) return {0, 0};
    const int8_t *bref = t.rf_ref_at(cy, cx);
    const int bmf = t.rf_mf[cy * t.rf_stride4 + cx];
    if (ref[1] == -1) {
        for (int n = 0; n < 2; n++) {
            if (bref[n] == ref[0]) {
                MV cand;
                if ((bmf & 1) && gmv0)
                    cand = *gmv0;
                else
                    cand = {bmv[2 * n], bmv[2 * n + 1]};
                const int newmv = bmf >> 1;
                for (int i = 0; i < st.n; i++) {
                    if (st.c[i].mv0 == cand) {
                        st.c[i].weight += weight;
                        return {newmv, 1};
                    }
                }
                if (st.n < 8) {
                    st.c[st.n] = {cand, {0, 0}, false, weight};
                    st.n++;
                }
                return {newmv, 1};
            }
        }
        return {0, 0};
    }
    if (bref[0] == ref[0] && bref[1] == ref[1]) {
        const MV c0 = ((bmf & 1) && gmv0) ? *gmv0 : MV{bmv[0], bmv[1]};
        const MV c1 = ((bmf & 1) && gmv1) ? *gmv1 : MV{bmv[2], bmv[3]};
        const int newmv = bmf >> 1;
        for (int i = 0; i < st.n; i++) {
            if (st.c[i].has1 && st.c[i].mv0 == c0 && st.c[i].mv1 == c1) {
                st.c[i].weight += weight;
                return {newmv, 1};
            }
        }
        if (st.n < 8) {
            st.c[st.n] = {c0, c1, true, weight};
            st.n++;
        }
        return {newmv, 1};
    }
    return {0, 0};
}

struct ScanRet { int n, nm, rm; };

ScanRet scan_row(TileDec &t, MvStack &st, const int ref[2], const MV *g0,
                 const MV *g1, int cy, int cx0, int bw4, int w4,
                 int max_rows, int step) {
    // dav1d refmvs.c scan_row:97
    int have_newmv = 0, have_refmv = 0;
    int cand_bw4 = t.bdim(t.rf_bs[cy * t.rf_stride4 + cx0])[0];
    int ln = step > (bw4 < cand_bw4 ? bw4 : cand_bw4)
                 ? step
                 : (bw4 < cand_bw4 ? bw4 : cand_bw4);
    if (bw4 <= cand_bw4) {
        int weight;
        if (bw4 == 1) {
            weight = 2;
        } else {
            const int h = t.bdim(t.rf_bs[cy * t.rf_stride4 + cx0])[1];
            const int w2 = 2 * max_rows < h ? 2 * max_rows : h;
            weight = 2 > w2 ? 2 : w2;
        }
        NmRm r = add_spatial_candidate(t, st, ln * weight, cy, cx0, ref,
                                       g0, g1);
        return {weight >> 1, r.nm, r.rm};
    }
    int x = 0;
    for (;;) {
        NmRm r = add_spatial_candidate(t, st, ln * 2, cy, cx0 + x, ref, g0,
                                       g1);
        have_newmv |= r.nm;
        have_refmv |= r.rm;
        x += ln;
        if (x >= w4) return {1, have_newmv, have_refmv};
        cand_bw4 = t.bdim(t.rf_bs[cy * t.rf_stride4 + cx0 + x])[0];
        ln = step > cand_bw4 ? step : cand_bw4;
    }
}

ScanRet scan_col(TileDec &t, MvStack &st, const int ref[2], const MV *g0,
                 const MV *g1, int cy0, int cx, int bh4, int h4,
                 int max_cols, int step) {
    // dav1d refmvs.c scan_col:136
    int have_newmv = 0, have_refmv = 0;
    int cand_bh4 = t.bdim(t.rf_bs[cy0 * t.rf_stride4 + cx])[1];
    int ln = step > (bh4 < cand_bh4 ? bh4 : cand_bh4)
                 ? step
                 : (bh4 < cand_bh4 ? bh4 : cand_bh4);
    if (bh4 <= cand_bh4) {
        int weight;
        if (bh4 == 1) {
            weight = 2;
        } else {
            const int w = t.bdim(t.rf_bs[cy0 * t.rf_stride4 + cx])[0];
            const int w2 = 2 * max_cols < w ? 2 * max_cols : w;
            weight = 2 > w2 ? 2 : w2;
        }
        NmRm r = add_spatial_candidate(t, st, ln * weight, cy0, cx, ref,
                                       g0, g1);
        return {weight >> 1, r.nm, r.rm};
    }
    int y = 0;
    for (;;) {
        NmRm r = add_spatial_candidate(t, st, ln * 2, cy0 + y, cx, ref, g0,
                                       g1);
        have_newmv |= r.nm;
        have_refmv |= r.rm;
        y += ln;
        if (y >= h4) return {1, have_newmv, have_refmv};
        cand_bh4 = t.bdim(t.rf_bs[(cy0 + y) * t.rf_stride4 + cx])[1];
        ln = step > cand_bh4 ? step : cand_bh4;
    }
}

// returns globalmv_ctx (0/1) or -1 if not computed
int add_temporal_candidate(TileDec &t, MvStack &st, int cy, int cx,
                           const int ref[2], const MV *tgmv,
                           bool want_gctx) {
    // dav1d refmvs.c add_temporal_candidate:193
    const int16_t *pm = t.rp_proj_mv + 2 * (cy * t.rp_stride8 + cx);
    const int my = pm[0], mx = pm[1];
    if (my == INVALID_MV && mx == INVALID_MV) return -1;
    const int bref = t.rp_proj_ref[cy * t.rp_stride8 + cx];
    MV mv0 = mv_projection({my, mx}, t.pocdiff[ref[0] - 1], bref);
    mv0 = fix_mv_precision(t, mv0);
    int gctx = -1;
    if (ref[1] == -1) {
        if (want_gctx)
            gctx = (abs(mv0.x - tgmv[0].x) | abs(mv0.y - tgmv[0].y)) >= 16;
        for (int i = 0; i < st.n; i++) {
            if (st.c[i].mv0 == mv0) {
                st.c[i].weight += 2;
                return gctx;
            }
        }
        if (st.n < 8) {
            st.c[st.n] = {mv0, {0, 0}, false, 2};
            st.n++;
        }
        return gctx;
    }
    MV mv1 = mv_projection({my, mx}, t.pocdiff[ref[1] - 1], bref);
    mv1 = fix_mv_precision(t, mv1);
    for (int i = 0; i < st.n; i++) {
        if (st.c[i].has1 && st.c[i].mv0 == mv0 && st.c[i].mv1 == mv1) {
            st.c[i].weight += 2;
            return gctx;
        }
    }
    if (st.n < 8) {
        st.c[st.n] = {mv0, mv1, true, 2};
        st.n++;
    }
    return gctx;
}

void add_single_extended(TileDec &t, MvStack &st, int cy, int cx, int sign) {
    // dav1d refmvs.c add_single_extended_candidate:296
    for (int n = 0; n < 2; n++) {
        const int cand_ref = t.rf_ref_at(cy, cx)[n];
        if (cand_ref <= 0) return;
        const int16_t *bmv = t.rf_mv_at(cy, cx);
        int my = bmv[2 * n], mx = bmv[2 * n + 1];
        if (sign ^ t.sign_bias[cand_ref - 1]) {
            my = -my;
            mx = -mx;
        }
        const MV cand = {my, mx};
        bool found = false;
        for (int i = 0; i < st.n; i++)
            if (st.c[i].mv0 == cand) { found = true; break; }
        if (!found) {
            // NOTE: python appends without the < 8 guard here (stack is
            // only extended when < 2 entries, so it cannot overflow)
            st.c[st.n] = {cand, {0, 0}, false, 2};
            st.n++;
        }
    }
}

struct CompExt {
    MV same[4][2];
    int cnt[4];
};

void add_compound_extended(TileDec &t, CompExt &ce, int cy, int cx,
                           int sign0, int sign1, const int ref[2]) {
    // dav1d refmvs.c add_compound_extended_candidate:239
    for (int n = 0; n < 2; n++) {
        const int cand_ref = t.rf_ref_at(cy, cx)[n];
        if (cand_ref <= 0) return;
        const int16_t *bmv = t.rf_mv_at(cy, cx);
        const int my = bmv[2 * n], mx = bmv[2 * n + 1];
        if (cand_ref == ref[0]) {
            if (ce.cnt[0] < 2) ce.same[0][ce.cnt[0]++] = {my, mx};
            if (ce.cnt[3] < 2) {
                if (sign1 ^ t.sign_bias[cand_ref - 1])
                    ce.same[3][ce.cnt[3]++] = {-my, -mx};
                else
                    ce.same[3][ce.cnt[3]++] = {my, mx};
            }
        } else if (cand_ref == ref[1]) {
            if (ce.cnt[1] < 2) ce.same[1][ce.cnt[1]++] = {my, mx};
            if (ce.cnt[2] < 2) {
                if (sign0 ^ t.sign_bias[cand_ref - 1])
                    ce.same[2][ce.cnt[2]++] = {-my, -mx};
                else
                    ce.same[2][ce.cnt[2]++] = {my, mx};
            }
        } else {
            if (ce.cnt[2] < 2) {
                if (sign0 ^ t.sign_bias[cand_ref - 1])
                    ce.same[2][ce.cnt[2]++] = {-my, -mx};
                else
                    ce.same[2][ce.cnt[2]++] = {my, mx};
            }
            if (ce.cnt[3] < 2) {
                if (sign1 ^ t.sign_bias[cand_ref - 1])
                    ce.same[3][ce.cnt[3]++] = {-my, -mx};
                else
                    ce.same[3][ce.cnt[3]++] = {my, mx};
            }
        }
    }
}

FindResult refmvs_find(TileDec &t, const int ref[2], int bs, int edge_flags,
                       int by4, int bx4) {
    // dav1d refmvs.c dav1d_refmvs_find:348
    const uint8_t *b_dim = t.bdim(bs);
    const int bw4 = b_dim[0], bh4 = b_dim[1];
    const int tile_col_end = t.col_end < t.rf_iw4 ? t.col_end : t.rf_iw4;
    const int tile_row_end = t.row_end < t.rf_ih4 ? t.row_end : t.rf_ih4;
    int w4 = bw4 < 16 ? bw4 : 16;
    if (w4 > tile_col_end - bx4) w4 = tile_col_end - bx4;
    int h4 = bh4 < 16 ? bh4 : 16;
    if (h4 > tile_row_end - by4) h4 = tile_row_end - by4;

    MV tg0 = {0, 0}, tg1 = {0, 0};
    MV g0s, g1s;
    const MV *g0 = nullptr, *g1 = nullptr;
    if (ref[0] > 0) {
        const int32_t *gm = t.gmv(ref[0] - 1);
        tg0 = get_gmv_2d(t, gm, bx4, by4, bw4, bh4);
        if (gm[0] > WM_TYPE_TRANSLATION) {
            g0s = tg0;
            g0 = &g0s;
        }
    }
    bool have_tg1 = false;
    if (ref[1] > 0) {
        const int32_t *gm = t.gmv(ref[1] - 1);
        tg1 = get_gmv_2d(t, gm, bx4, by4, bw4, bh4);
        have_tg1 = true;
        if (gm[0] > WM_TYPE_TRANSLATION) {
            g1s = tg1;
            g1 = &g1s;
        }
    }
    (void)have_tg1;

    MvStack st;
    st.n = 0;
    int have_newmv = 0, have_col_mvs = 0, have_row_mvs = 0;
    int max_rows = 0, n_rows = -1, b_top_y = -1;
    if (by4 > t.row_start) {
        max_rows = (by4 - t.row_start + 1) >> 1;
        if (max_rows > 2 + (bh4 > 1)) max_rows = 2 + (bh4 > 1);
        b_top_y = by4 - 1;
        ScanRet r = scan_row(t, st, ref, g0, g1, b_top_y, bx4, bw4, w4,
                             max_rows, bw4 >= 16 ? 4 : 1);
        n_rows = r.n;
        have_newmv |= r.nm;
        have_row_mvs |= r.rm;
    }

    int max_cols = 0, n_cols = -1;
    if (bx4 > t.col_start) {
        max_cols = (bx4 - t.col_start + 1) >> 1;
        if (max_cols > 2 + (bw4 > 1)) max_cols = 2 + (bw4 > 1);
        ScanRet r = scan_col(t, st, ref, g0, g1, by4, bx4 - 1, bh4, h4,
                             max_cols, bh4 >= 16 ? 4 : 1);
        n_cols = r.n;
        have_newmv |= r.nm;
        have_col_mvs |= r.rm;
    }

    // top/right
    if (n_rows != -1 && (edge_flags & EDGE_I444_TOP_HAS_RIGHT) &&
        (bw4 > bh4 ? bw4 : bh4) <= 16 && bw4 + bx4 < tile_col_end) {
        NmRm r = add_spatial_candidate(t, st, 4, b_top_y, bx4 + bw4, ref,
                                       g0, g1);
        have_newmv |= r.nm;
        have_row_mvs |= r.rm;
    }

    const int nearest_match = have_col_mvs + have_row_mvs;
    const int nearest_cnt = st.n;
    for (int i = 0; i < st.n; i++) st.c[i].weight += 640;

    // temporal candidates
    int globalmv_ctx = t.cfg[CFG_USE_REF_FRAME_MVS];
    if (t.rf_use_tmvs) {
        const int by8 = by4 >> 1, bx8 = bx4 >> 1;
        const int step_h = bw4 >= 16 ? 2 : 1;
        const int step_v = bh4 >= 16 ? 2 : 1;
        int w8 = (w4 + 1) >> 1;
        if (w8 > 8) w8 = 8;
        int h8 = (h4 + 1) >> 1;
        if (h8 > 8) h8 = 8;
        MV tgmv[2] = {tg0, tg1};
        for (int y = 0; y < h8; y += step_v) {
            for (int x = 0; x < w8; x += step_h) {
                const int g = add_temporal_candidate(t, st, by8 + y,
                                                     bx8 + x, ref, tgmv,
                                                     !(x | y));
                if (g >= 0) globalmv_ctx = g;
            }
        }
        if ((bw4 < bh4 ? bw4 : bh4) >= 2 && (bw4 > bh4 ? bw4 : bh4) < 16) {
            const int bh8 = bh4 >> 1, bw8 = bw4 >> 1;
            const int row_lim = (tile_row_end >> 1) < ((by8 & ~7) + 8)
                                    ? tile_row_end >> 1
                                    : (by8 & ~7) + 8;
            const bool has_bottom = by8 + bh8 < row_lim;
            const int col_lo = (t.col_start >> 1) > (bx8 & ~7)
                                   ? t.col_start >> 1
                                   : bx8 & ~7;
            if (has_bottom && bx8 - 1 >= col_lo)
                add_temporal_candidate(t, st, by8 + bh8, bx8 - 1, ref,
                                       nullptr, false);
            const int col_hi = (tile_col_end >> 1) < ((bx8 & ~7) + 8)
                                   ? tile_col_end >> 1
                                   : (bx8 & ~7) + 8;
            if (bx8 + bw8 < col_hi) {
                if (has_bottom)
                    add_temporal_candidate(t, st, by8 + bh8, bx8 + bw8, ref,
                                           nullptr, false);
                if (by8 + bh8 - 1 < row_lim)
                    add_temporal_candidate(t, st, by8 + bh8 - 1, bx8 + bw8,
                                           ref, nullptr, false);
            }
        }
    }

    // top/left secondary
    if (n_rows != -1 && n_cols != -1) {
        NmRm r = add_spatial_candidate(t, st, 4, b_top_y, bx4 - 1, ref, g0,
                                       g1);
        have_row_mvs |= r.rm;
    }

    // secondary top & left edges
    const int base = by4 & ~31;
    for (int n = 2; n <= 3; n++) {
        if (n_rows != -1 && n > n_rows && n <= max_rows) {
            const int cy = base + ((((by4 & 31) - 2 * n + 1)) | 1);
            ScanRet r = scan_row(t, st, ref, g0, g1, cy, bx4 | 1, bw4, w4,
                                 1 + max_rows - n, bw4 >= 16 ? 4 : 2);
            n_rows += r.n;
            have_row_mvs |= r.rm;
        }
        if (n_cols != -1 && n > n_cols && n <= max_cols) {
            const int cy = base + ((by4 & 31) | 1);
            ScanRet r = scan_col(t, st, ref, g0, g1, cy,
                                 (bx4 - n * 2 + 1) | 1, bh4, h4,
                                 1 + max_cols - n, bh4 >= 16 ? 4 : 2);
            n_cols += r.n;
            have_col_mvs |= r.rm;
        }
    }

    const int ref_match_count = have_col_mvs + have_row_mvs;

    int refmv_ctx, newmv_ctx;
    if (nearest_match == 0) {
        refmv_ctx = ref_match_count < 2 ? ref_match_count : 2;
        newmv_ctx = ref_match_count > 0 ? 1 : 0;
    } else if (nearest_match == 1) {
        refmv_ctx = ref_match_count * 3 < 4 ? ref_match_count * 3 : 4;
        newmv_ctx = 3 - have_newmv;
    } else {
        refmv_ctx = 5;
        newmv_ctx = 5 - have_newmv;
    }

    // order-preserving bubble sort by weight
    auto sort_range = [&](int lo, int hi) {
        int len = hi;
        while (len > lo) {
            int last = lo;
            for (int n = lo + 1; n < len; n++) {
                if (st.c[n - 1].weight < st.c[n].weight) {
                    Cand tmp = st.c[n - 1];
                    st.c[n - 1] = st.c[n];
                    st.c[n] = tmp;
                    last = n;
                }
            }
            len = last;
        }
    };
    sort_range(0, nearest_cnt);
    sort_range(nearest_cnt, st.n);

    FindResult out;

    if (ref[1] > 0) {
        if (st.n < 2) {
            const int sign0 = t.sign_bias[ref[0] - 1];
            const int sign1 = t.sign_bias[ref[1] - 1];
            const int sz4 = w4 < h4 ? w4 : h4;
            CompExt ce;
            memset(&ce, 0, sizeof(ce));
            if (n_rows != -1) {
                int x = 0;
                while (x < sz4) {
                    add_compound_extended(t, ce, b_top_y, bx4 + x, sign0,
                                          sign1, ref);
                    x += t.bdim(t.rf_bs[b_top_y * t.rf_stride4 + bx4 + x])[0];
                }
            }
            if (n_cols != -1) {
                int y = 0;
                while (y < sz4) {
                    add_compound_extended(t, ce, by4 + y, bx4 - 1, sign0,
                                          sign1, ref);
                    y += t.bdim(t.rf_bs[(by4 + y) * t.rf_stride4 + bx4 - 1])[1];
                }
            }
            // merge: fill each component list to 2 from diff, then tgmv
            MV comp[2][2];
            MV tgmv2[2] = {tg0, tg1};
            for (int n = 0; n < 2; n++) {
                int m = 0;
                for (int i = 0; i < ce.cnt[n] && m < 2; i++)
                    comp[n][m++] = ce.same[n][i];
                for (int i = 0; i < ce.cnt[2 + n] && m < 2; i++)
                    comp[n][m++] = ce.same[2 + n][i];
                while (m < 2) comp[n][m++] = tgmv2[n];
            }
            Cand ext[2] = {{comp[0][0], comp[1][0], true, 2},
                           {comp[0][1], comp[1][1], true, 2}};
            const int n0 = st.n;
            if (n0 == 1 && st.c[0].has1 && st.c[0].mv0 == ext[0].mv0 &&
                st.c[0].mv1 == ext[0].mv1)
                ext[0] = ext[1];
            for (int i = n0; i < 2; i++) st.c[st.n++] = ext[i - n0];
        }

        const int left = -(bx4 + bw4 + 4) * 4 * 8;
        const int right = (t.rf_iw4 - bx4 + 4) * 4 * 8;
        const int top = -(by4 + bh4 + 4) * 4 * 8;
        const int bottom = (t.rf_ih4 - by4 + 4) * 4 * 8;
        for (int i = 0; i < st.n; i++) {
            st.c[i].mv0 = {iclip(st.c[i].mv0.y, top, bottom),
                           iclip(st.c[i].mv0.x, left, right)};
            MV m1 = st.c[i].has1 ? st.c[i].mv1 : MV{0, 0};
            st.c[i].mv1 = {iclip(m1.y, top, bottom),
                           iclip(m1.x, left, right)};
            st.c[i].has1 = true;
        }

        const int r = refmv_ctx >> 1;
        int ctx;
        if (r == 0)
            ctx = newmv_ctx < 1 ? newmv_ctx : 1;
        else if (r == 1)
            ctx = 1 + (newmv_ctx < 3 ? newmv_ctx : 3);
        else
            ctx = iclip(3 + newmv_ctx, 4, 7);
        out.n_out = st.n;
        out.n_mvs = st.n;
        for (int i = 0; i < st.n; i++) {
            out.mv0[i] = st.c[i].mv0;
            out.mv1[i] = st.c[i].mv1;
            out.weight[i] = st.c[i].weight;
        }
        out.ctx = ctx;
        return out;
    }

    if (st.n < 2 && ref[0] > 0) {
        const int sign = t.sign_bias[ref[0] - 1];
        const int sz4 = w4 < h4 ? w4 : h4;
        if (n_rows != -1) {
            int x = 0;
            while (x < sz4 && st.n < 2) {
                add_single_extended(t, st, b_top_y, bx4 + x, sign);
                x += t.bdim(t.rf_bs[b_top_y * t.rf_stride4 + bx4 + x])[0];
            }
        }
        if (n_cols != -1) {
            int y = 0;
            while (y < sz4 && st.n < 2) {
                add_single_extended(t, st, by4 + y, bx4 - 1, sign);
                y += t.bdim(t.rf_bs[(by4 + y) * t.rf_stride4 + bx4 - 1])[1];
            }
        }
    }

    if (st.n) {
        const int left = -(bx4 + bw4 + 4) * 4 * 8;
        const int right = (t.rf_iw4 - bx4 + 4) * 4 * 8;
        const int top = -(by4 + bh4 + 4) * 4 * 8;
        const int bottom = (t.rf_ih4 - by4 + 4) * 4 * 8;
        for (int i = 0; i < st.n; i++)
            st.c[i].mv0 = {iclip(st.c[i].mv0.y, top, bottom),
                           iclip(st.c[i].mv0.x, left, right)};
    }

    out.n_mvs = st.n;
    int n = 0;
    for (; n < st.n; n++) {
        out.mv0[n] = st.c[n].mv0;
        out.mv1[n] = st.c[n].has1 ? st.c[n].mv1 : MV{0, 0};
        out.weight[n] = st.c[n].weight;
    }
    for (; n < 2; n++) {
        out.mv0[n] = tg0;
        out.mv1[n] = {0, 0};
        out.weight[n] = 0;
    }
    out.n_out = n;
    out.ctx = (refmv_ctx << 4) | (globalmv_ctx << 3) | newmv_ctx;
    return out;
}

void splat_mv(TileDec &t, int by4, int bx4, int bw4, int bh4, int ref0,
              int ref1, MV mv0, MV mv1, int bs, int mf) {
    // dav1d refmvs.c splat_mv_c:909 (extents clip to the frame arrays,
    // matching the numpy slice semantics of the Python spec)
    if (bh4 > t.rf_ih4 - by4) bh4 = t.rf_ih4 - by4;
    if (bw4 > t.rf_iw4 - bx4) bw4 = t.rf_iw4 - bx4;
    for (int y = by4; y < by4 + bh4; y++) {
        int8_t *rr = t.rf_ref_at(y, bx4);
        int16_t *rm = t.rf_mv_at(y, bx4);
        uint8_t *rb = t.rf_bs + y * t.rf_stride4 + bx4;
        uint8_t *rf = t.rf_mf + y * t.rf_stride4 + bx4;
        for (int x = 0; x < bw4; x++) {
            rr[2 * x] = (int8_t)ref0;
            rr[2 * x + 1] = (int8_t)ref1;
            rm[4 * x] = (int16_t)mv0.y;
            rm[4 * x + 1] = (int16_t)mv0.x;
            rm[4 * x + 2] = (int16_t)mv1.y;
            rm[4 * x + 3] = (int16_t)mv1.x;
            rb[x] = (uint8_t)bs;
            rf[x] = (uint8_t)mf;
        }
    }
}

int get_drl_context(const FindResult &fr, int ref_idx) {
    if (fr.weight[ref_idx] >= 640) return fr.weight[ref_idx + 1] < 640;
    return fr.weight[ref_idx + 1] < 640 ? 2 : 0;
}

// ---------------------------------------------------------------
// warped-motion parameter derivation (host/warpmv.py; dav1d
// src/warpmv.c:80,149 + decode.c derive_warpmv:292,
// find_matching_ref:219)
// ---------------------------------------------------------------
const uint16_t DIV_LUT[257] = {
    16384, 16320, 16257, 16194, 16132, 16070, 16009, 15948, 15888, 15828,
    15768, 15709, 15650, 15592, 15534, 15477, 15420, 15364, 15308, 15252,
    15197, 15142, 15087, 15033, 14980, 14926, 14873, 14821, 14769, 14717,
    14665, 14614, 14564, 14513, 14463, 14413, 14364, 14315, 14266, 14218,
    14170, 14122, 14075, 14028, 13981, 13935, 13888, 13843, 13797, 13752,
    13707, 13662, 13618, 13574, 13530, 13487, 13443, 13400, 13358, 13315,
    13273, 13231, 13190, 13148, 13107, 13066, 13026, 12985, 12945, 12906,
    12866, 12827, 12788, 12749, 12710, 12672, 12633, 12596, 12558, 12520,
    12483, 12446, 12409, 12373, 12336, 12300, 12264, 12228, 12193, 12157,
    12122, 12087, 12053, 12018, 11984, 11950, 11916, 11882, 11848, 11815,
    11782, 11749, 11716, 11683, 11651, 11619, 11586, 11555, 11523, 11491,
    11460, 11429, 11398, 11367, 11336, 11305, 11275, 11245, 11215, 11185,
    11155, 11125, 11096, 11067, 11038, 11009, 10980, 10951, 10923, 10894,
    10866, 10838, 10810, 10782, 10755, 10727, 10700, 10673, 10645, 10618,
    10592, 10565, 10538, 10512, 10486, 10460, 10434, 10408, 10382, 10356,
    10331, 10305, 10280, 10255, 10230, 10205, 10180, 10156, 10131, 10107,
    10082, 10058, 10034, 10010, 9986, 9963, 9939, 9916, 9892, 9869, 9846,
    9823, 9800, 9777, 9754, 9732, 9709, 9687, 9664, 9642, 9620, 9598,
    9576, 9554, 9533, 9511, 9489, 9468, 9447, 9425, 9404, 9383, 9362,
    9341, 9321, 9300, 9279, 9259, 9239, 9218, 9198, 9178, 9158, 9138,
    9118, 9098, 9079, 9059, 9039, 9020, 9001, 8981, 8962, 8943, 8924,
    8905, 8886, 8867, 8849, 8830, 8812, 8793, 8775, 8756, 8738, 8720,
    8702, 8684, 8666, 8648, 8630, 8613, 8595, 8577, 8560, 8542, 8525,
    8508, 8490, 8473, 8456, 8439, 8422, 8405, 8389, 8372, 8355, 8339,
    8322, 8306, 8289, 8273, 8257, 8240, 8224, 8208, 8192,
};

inline int bitlen64(uint64_t v) { return 64 - __builtin_clzll(v); }

inline int iclip_wmp(int64_t v) {
    const int64_t cv = iclip64(v, -0x8000, 0x7FFF);
    return apply_sign((int)((llabs(cv) + 32) >> 6), cv) * 64;
}

void resolve_divisor(uint64_t d, int *mult, int *shift) {
    const int sh = bitlen64(d) - 1;
    const int64_t e = (int64_t)d - (1ll << sh);
    const int64_t f = sh > 8 ? (e + (1ll << (sh - 9))) >> (sh - 8)
                             : e << (8 - sh);
    *mult = DIV_LUT[f];
    *shift = sh + 14;
}

int get_shear_params(Warp *wm) {
    // dav1d warpmv.c:80 — returns nonzero if params invalid
    const int32_t *mat = wm->mat;
    if (mat[2] <= 0) return 1;
    wm->alpha = iclip_wmp((int64_t)mat[2] - 0x10000);
    wm->beta = iclip_wmp(mat[3]);
    int mult, shift;
    resolve_divisor((uint64_t)llabs(mat[2]), &mult, &shift);
    const int64_t y = apply_sign64(mult, mat[2]);
    const int64_t v1 = ((int64_t)mat[4] * 0x10000) * y;
    const int64_t rnd = (1ll << shift) >> 1;
    wm->gamma = iclip_wmp(apply_sign64((llabs(v1) + rnd) >> shift, v1));
    const int64_t v2 = ((int64_t)mat[3] * mat[4]) * y;
    wm->delta = iclip_wmp((int64_t)mat[5] -
                          apply_sign64((llabs(v2) + rnd) >> shift, v2) -
                          0x10000);
    return (4 * abs(wm->alpha) + 7 * abs(wm->beta) >= 0x10000) ||
           (4 * abs(wm->gamma) + 4 * abs(wm->delta) >= 0x10000);
}

inline int mult_shift_ndiag(int64_t px, int64_t idet, int shift) {
    const int64_t v1 = px * idet;
    const int64_t v2 = apply_sign64((llabs(v1) + ((1ll << shift) >> 1))
                                    >> shift, v1);
    return (int)iclip64(v2, -0x1FFF, 0x1FFF);
}

inline int mult_shift_diag(int64_t px, int64_t idet, int shift) {
    const int64_t v1 = px * idet;
    const int64_t v2 = apply_sign64((llabs(v1) + ((1ll << shift) >> 1))
                                    >> shift, v1);
    return (int)iclip64(v2, 0xE001, 0x11FFF);
}

struct WarpPt {
    int in_x, in_y, out_x, out_y;
};

int find_affine_int(const WarpPt *pts, int np, int bw4, int bh4, MV mv,
                    Warp *wm, int bx4, int by4) {
    // dav1d warpmv.c:149 — returns nonzero on failure
    int32_t *mat = wm->mat;
    int64_t a[2][2] = {{0, 0}, {0, 0}};
    int64_t bxv[2] = {0, 0}, byv[2] = {0, 0};
    const int rsuy = 2 * bh4 - 1;
    const int rsux = 2 * bw4 - 1;
    const int suy = rsuy * 8;
    const int sux = rsux * 8;
    const int duy = suy + mv.y;
    const int dux = sux + mv.x;
    const int isuy = by4 * 4 + rsuy;
    const int isux = bx4 * 4 + rsux;

    for (int i = 0; i < np; i++) {
        const int dx = pts[i].out_x - dux;
        const int dy = pts[i].out_y - duy;
        const int sx = pts[i].in_x - sux;
        const int sy = pts[i].in_y - suy;
        if (abs(sx - dx) < 256 && abs(sy - dy) < 256) {
            a[0][0] += ((sx * sx) >> 2) + sx * 2 + 8;
            a[0][1] += ((sx * sy) >> 2) + sx + sy + 4;
            a[1][1] += ((sy * sy) >> 2) + sy * 2 + 8;
            bxv[0] += ((sx * dx) >> 2) + sx + dx + 8;
            bxv[1] += ((sy * dx) >> 2) + sy + dx + 4;
            byv[0] += ((sx * dy) >> 2) + sx + dy + 4;
            byv[1] += ((sy * dy) >> 2) + sy + dy + 8;
        }
    }

    const int64_t det = a[0][0] * a[1][1] - a[0][1] * a[0][1];
    if (det == 0) return 1;
    int mult, shift;
    resolve_divisor((uint64_t)llabs(det), &mult, &shift);
    int64_t idet = apply_sign64(mult, det);
    shift -= 16;
    if (shift < 0) {
        idet <<= -shift;
        shift = 0;
    }

    mat[2] = mult_shift_diag(a[1][1] * bxv[0] - a[0][1] * bxv[1], idet,
                             shift);
    mat[3] = mult_shift_ndiag(a[0][0] * bxv[1] - a[0][1] * bxv[0], idet,
                              shift);
    mat[4] = mult_shift_ndiag(a[1][1] * byv[0] - a[0][1] * byv[1], idet,
                              shift);
    mat[5] = mult_shift_diag(a[0][0] * byv[1] - a[0][1] * byv[0], idet,
                             shift);

    mat[0] = (int32_t)iclip64((int64_t)mv.x * 0x2000 -
                              ((int64_t)isux * (mat[2] - 0x10000) +
                               (int64_t)isuy * mat[3]),
                              -0x800000, 0x7FFFFF);
    mat[1] = (int32_t)iclip64((int64_t)mv.y * 0x2000 -
                              ((int64_t)isux * mat[4] +
                               (int64_t)isuy * (mat[5] - 0x10000)),
                              -0x800000, 0x7FFFFF);
    return 0;
}

void derive_warpmv(TileDec &t, int bw4, int bh4, const uint64_t masks[2],
                   MV mv, int bx, int by, Warp *wm) {
    // dav1d decode.c derive_warpmv:292
    WarpPt pts[8];
    int np = 0;
    auto add_sample = [&](int dx, int dy, int sx, int sy, int cy, int cx) {
        const uint8_t *cbs = t.bdim(t.rf_bs[cy * t.rf_stride4 + cx]);
        const int ix = 16 * (2 * dx + sx * cbs[0]) - 8;
        const int iy = 16 * (2 * dy + sy * cbs[1]) - 8;
        const int16_t *cmv = t.rf_mv_at(cy, cx);
        pts[np].in_x = ix;
        pts[np].in_y = iy;
        pts[np].out_x = ix + cmv[1];
        pts[np].out_y = iy + cmv[0];
        np++;
    };

    if ((masks[0] & 0xFFFFFFFFull) == 1 && !(masks[1] >> 32)) {
        const int off = bx & (t.bdim(t.rf_bs[(by - 1) * t.rf_stride4 + bx])[0]
                              - 1);
        add_sample(-off, 0, 1, -1, by - 1, bx);
    } else {
        int off = 0;
        uint64_t xmask = masks[0] & 0xFFFFFFFFull;
        while (np < 8 && xmask) {
            const int tz = __builtin_ctzll(xmask);
            off += tz;
            xmask >>= tz;
            add_sample(off, 0, 1, -1, by - 1, bx + off);
            xmask &= ~1ull;
        }
    }
    if (np < 8 && masks[1] == 1) {
        const int off = by & (t.bdim(t.rf_bs[by * t.rf_stride4 + bx - 1])[1]
                              - 1);
        add_sample(0, -off, -1, 1, by - off, bx - 1);
    } else {
        int off = 0;
        uint64_t ymask = masks[1] & 0xFFFFFFFFull;
        while (np < 8 && ymask) {
            const int tz = __builtin_ctzll(ymask);
            off += tz;
            ymask >>= tz;
            add_sample(0, off, -1, 1, by + off, bx - 1);
            ymask &= ~1ull;
        }
    }
    if (np < 8 && (masks[1] >> 32)) add_sample(0, 0, -1, -1, by - 1, bx - 1);
    if (np < 8 && (masks[0] >> 32))
        add_sample(bw4, 0, 1, -1, by - 1, bx + bw4);

    // threshold selection (decode.c:336-357)
    const int mxd = bw4 > bh4 ? bw4 : bh4;
    const int thresh = 4 * iclip(mxd, 4, 28);
    WarpPt valid[8];
    int nv = 0;
    for (int i = 0; i < np; i++) {
        if (abs(pts[i].out_x - pts[i].in_x - mv.x) +
                abs(pts[i].out_y - pts[i].in_y - mv.y) <=
            thresh)
            valid[nv++] = pts[i];
    }
    if (!nv) {
        valid[0] = pts[0];
        nv = 1;
    }
    wm->mat[0] = 0;
    wm->mat[1] = 0;
    wm->mat[2] = 0x10000;
    wm->mat[3] = 0;
    wm->mat[4] = 0;
    wm->mat[5] = 0x10000;
    wm->alpha = wm->beta = wm->gamma = wm->delta = 0;
    if (!find_affine_int(valid, nv, bw4, bh4, mv, wm, bx, by) &&
        !get_shear_params(wm))
        wm->valid = 1;  // WM_TYPE_AFFINE
    else
        wm->valid = 0;  // WM_TYPE_IDENTITY
}

void find_matching_ref(TileDec &t, int edge_flags, int bw4, int bh4, int w4,
                       int h4, int have_left, int have_top, int ref, int bx,
                       int by, uint64_t masks[2]) {
    // dav1d decode.c find_matching_ref:219
    masks[0] = masks[1] = 0;
    int count = 0;
    int have_topleft = have_top && have_left;
    int have_topright = (bw4 > bh4 ? bw4 : bh4) < 32 && have_top &&
                        bx + bw4 < t.col_end &&
                        (edge_flags & EDGE_I444_TOP_HAS_RIGHT);

    auto matches = [&](int cy, int cx) {
        const int8_t *rr = t.rf_ref_at(cy, cx);
        return rr[0] == ref + 1 && rr[1] == -1;
    };

    if (have_top) {
        if (matches(by - 1, bx)) {
            masks[0] |= 1;
            count = 1;
        }
        int aw4 = t.bdim(t.rf_bs[(by - 1) * t.rf_stride4 + bx])[0];
        if (aw4 >= bw4) {
            const int off = bx & (aw4 - 1);
            if (off) have_topleft = 0;
            if (aw4 - off > bw4) have_topright = 0;
        } else {
            uint64_t mask = 1ull << aw4;
            for (int x = aw4; x < w4;) {
                if (matches(by - 1, bx + x)) {
                    masks[0] |= mask;
                    count++;
                    if (count >= 8) return;
                }
                aw4 = t.bdim(t.rf_bs[(by - 1) * t.rf_stride4 + bx + x])[0];
                mask <<= aw4;
                x += aw4;
            }
        }
    }
    if (have_left) {
        if (matches(by, bx - 1)) {
            masks[1] |= 1;
            count++;
            if (count >= 8) return;
        }
        int lh4 = t.bdim(t.rf_bs[by * t.rf_stride4 + bx - 1])[1];
        if (lh4 >= bh4) {
            if (by & (lh4 - 1)) have_topleft = 0;
        } else {
            uint64_t mask = 1ull << lh4;
            for (int y = lh4; y < h4;) {
                if (matches(by + y, bx - 1)) {
                    masks[1] |= mask;
                    count++;
                    if (count >= 8) return;
                }
                lh4 = t.bdim(t.rf_bs[(by + y) * t.rf_stride4 + bx - 1])[1];
                mask <<= lh4;
                y += lh4;
            }
        }
    }
    if (have_topleft && matches(by - 1, bx - 1)) {
        masks[1] |= 1ull << 32;
        count++;
        if (count >= 8) return;
    }
    if (have_topright && matches(by - 1, bx + bw4)) masks[0] |= 1ull << 32;
}

// ---------------------------------------------------------------
// quant tables (host/tilecoder.py _init_quant_tables)
// ---------------------------------------------------------------
void init_quant_tables(TileDec &t, int qidx, int32_t dq[8][3][2]) {
    const int n = t.seg_enabled ? 8 : 1;
    for (int i = 0; i < n; i++) {
        const int yac = t.seg_enabled
                            ? iclip_u8(qidx + t.seg_field(i, 0))
                            : qidx;
        const int ydc = iclip_u8(yac + t.cfg[CFG_QUANT_YDC_DELTA]);
        const int uac = iclip_u8(yac + t.cfg[CFG_QUANT_UAC_DELTA]);
        const int udc = iclip_u8(yac + t.cfg[CFG_QUANT_UDC_DELTA]);
        const int vac = iclip_u8(yac + t.cfg[CFG_QUANT_VAC_DELTA]);
        const int vdc = iclip_u8(yac + t.cfg[CFG_QUANT_VDC_DELTA]);
        const uint16_t *d = t.t_dq + t.hbd * 256 * 2;
        dq[i][0][0] = d[ydc * 2];
        dq[i][0][1] = d[yac * 2 + 1];
        dq[i][1][0] = d[udc * 2];
        dq[i][1][1] = d[uac * 2 + 1];
        dq[i][2][0] = d[vdc * 2];
        dq[i][2][1] = d[vac * 2 + 1];
    }
    for (int i = n; i < 8; i++) memcpy(dq[i], dq[0], sizeof(dq[0]));
}

// ---------------------------------------------------------------
// loopfilter level (host/tilecoder.py _calc_lflvl; dav1d lf_mask.c:431)
// ---------------------------------------------------------------
void calc_lflvl(TileDec &t, int seg_id, int ref1, int mode1, int32_t out[4]) {
    const int32_t *c = t.cfg;
    if (!c[CFG_LF_LEVEL_Y0] && !c[CFG_LF_LEVEL_Y1]) {
        out[0] = out[1] = out[2] = out[3] = 0;
        return;
    }
    const bool mr = c[CFG_LF_MODE_REF_DELTA_ENABLED];
    const bool has_seg = t.seg_enabled;
    const int *dlf = t.last_delta_lf;
    const bool multi = c[CFG_DELTA_LF_MULTI];

    auto calc = [&](int base_lvl, int lf_delta, int seg_delta) {
        int base = iclip(base_lvl + lf_delta, 0, 63);
        base = iclip(base + seg_delta, 0, 63);
        if (!mr) return base;
        const int sh = base >= 32;
        int delta;
        if (ref1 == 0)
            delta = c[CFG_LF_REF_DELTA + 0];
        else
            delta = c[CFG_LF_MODE_DELTA + mode1] + c[CFG_LF_REF_DELTA + ref1];
        return iclip(base + delta * (1 << sh), 0, 63);
    };
    auto calc_c = [&](int base_lvl, int lf_delta, int seg_delta) {
        return base_lvl ? calc(base_lvl, lf_delta, seg_delta) : 0;
    };

    const int sd_yv = has_seg ? t.seg_field(seg_id, 1) : 0;
    const int sd_yh = has_seg ? t.seg_field(seg_id, 2) : 0;
    const int sd_u = has_seg ? t.seg_field(seg_id, 3) : 0;
    const int sd_v = has_seg ? t.seg_field(seg_id, 4) : 0;
    out[0] = calc(c[CFG_LF_LEVEL_Y0], dlf[0], sd_yv);
    out[1] = calc(c[CFG_LF_LEVEL_Y1], dlf[multi ? 1 : 0], sd_yh);
    out[2] = calc_c(c[CFG_LF_LEVEL_U], dlf[multi ? 2 : 0], sd_u);
    out[3] = calc_c(c[CFG_LF_LEVEL_V], dlf[multi ? 3 : 0], sd_v);
}

// ---------------------------------------------------------------
// delta q/lf (host/tilecoder.py _read_delta_q_lf)
// ---------------------------------------------------------------
void read_delta_q_lf(TileDec &t, int skip, int bs) {
    ec::Msac *m = &t.m;
    const int32_t *c = t.cfg;
    const int sb_bs = t.sb128 ? 0 : 3;  // BS_128x128 / BS_64x64
    const bool have_delta_q = c[CFG_DELTA_Q_PRESENT] &&
                              (bs != sb_bs || !skip);
    if (!have_delta_q) return;
    int delta_q = ec::symbol_adapt(m, t.cdf(CDF_DELTA_Q), 3);
    if (delta_q == 3) {
        const int n_bits = 1 + ec::bools(m, 3);
        delta_q = ec::bools(m, n_bits) + 1 + (1 << n_bits);
    }
    if (delta_q) {
        if (ec::bool_equi(m)) delta_q = -delta_q;
        delta_q *= 1 << c[CFG_DELTA_Q_RES_LOG2];
    }
    t.last_qidx = iclip(t.last_qidx + delta_q, 1, 255);
    if (c[CFG_DELTA_LF_PRESENT]) {
        const int n_lfs = c[CFG_DELTA_LF_MULTI]
                              ? (t.monochrome ? 2 : 4)
                              : 1;
        for (int i = 0; i < n_lfs; i++) {
            int delta_lf = ec::symbol_adapt(
                m, t.cdf(CDF_DELTA_LF) + 4 * (i + c[CFG_DELTA_LF_MULTI]),
                3);
            if (delta_lf == 3) {
                const int n_bits = 1 + ec::bools(m, 3);
                delta_lf = ec::bools(m, n_bits) + 1 + (1 << n_bits);
            }
            if (delta_lf) {
                if (ec::bool_equi(m)) delta_lf = -delta_lf;
                delta_lf *= 1 << c[CFG_DELTA_LF_RES_LOG2];
            }
            t.last_delta_lf[i] = iclip(t.last_delta_lf[i] + delta_lf, -63,
                                       63);
        }
    }
    if (t.last_qidx == c[CFG_QUANT_YAC])
        memcpy(t.dq_cur, t.dq_frame, sizeof(t.dq_cur));
    else
        init_quant_tables(t, t.last_qidx, t.dq_cur);
}

// ---------------------------------------------------------------
// segmentation (host/tilecoder.py _cur_seg_ctx/_read_seg_id/_prev_seg_id)
// ---------------------------------------------------------------
int prev_seg_id(TileDec &t, int bx, int by, int w4, int h4) {
    // dav1d decode.c get_prev_frame_segid:528
    if (!t.prev_segmap) return 0;
    int seg_id = 8;
    for (int y = by; y < by + h4; y++)
        for (int x = bx; x < bx + w4; x++) {
            const int v = t.prev_segmap[y * t.bw + x];
            if (v < seg_id) seg_id = v;
        }
    return seg_id;
}

void cur_seg_ctx(TileDec &t, int bx, int by, int have_top, int have_left,
                 int *ctx, int *pred_seg_id) {
    const uint8_t *sm = t.seg_map;
    if (have_left && have_top) {
        const int lv = sm[by * t.bw + bx - 1];
        const int av = sm[(by - 1) * t.bw + bx];
        const int al = sm[(by - 1) * t.bw + bx - 1];
        if (lv == av && al == lv)
            *ctx = 2;
        else if (lv == av || al == lv || av == al)
            *ctx = 1;
        else
            *ctx = 0;
        *pred_seg_id = av == al ? av : lv;
        return;
    }
    *ctx = 0;
    if (have_left)
        *pred_seg_id = sm[by * t.bw + bx - 1];
    else if (have_top)
        *pred_seg_id = sm[(by - 1) * t.bw + bx];
    else
        *pred_seg_id = 0;
}

int read_seg_id(TileDec &t, int bx, int by, int w4, int h4, int have_top,
                int have_left) {
    int seg_ctx, pred;
    cur_seg_ctx(t, bx, by, have_top, have_left, &seg_ctx, &pred);
    const int diff = ec::symbol_adapt(&t.m, t.cdf(CDF_SEG_ID) + 8 * seg_ctx,
                                      7);
    const int last_active = t.cfg[CFG_SEG_LAST_ACTIVE];
    // dav1d stores into a uint8 before the range checks (decode.c:892)
    int seg_id = neg_deinterleave(diff, pred, last_active + 1) & 0xFF;
    if (seg_id > last_active || seg_id >= 8) seg_id = 0;
    return seg_id;
}

// ---------------------------------------------------------------
// palette (host/tilecoder.py _read_pal_plane/_read_pal_v/
// _read_pal_indices; dav1d recon_tmpl.c:2223,2329, decode.c:442)
// ---------------------------------------------------------------
void read_pal_plane(TileDec &t, Blk &b, int pl, int sz_ctx, int bx, int by,
                    uint16_t *pal_out) {
    ec::Msac *m = &t.m;
    const int pal_sz =
        ec::symbol_adapt(m, t.cdf(CDF_PAL_SZ) + (pl * 7 + sz_ctx) * 8, 6) +
        2;
    b.f[pl ? B_PAL_SZ1 : B_PAL_SZ0] = pal_sz;
    const int bpc = t.bitdepth;
    int l_cache = pl ? t.pal_sz_uv_y[by] : t.l.pal_sz[by & 31];
    int a_cache = 0;
    if (by & 15)
        a_cache = pl ? t.pal_sz_uv_x[bx] : t.a_at(bx).pal_sz[bx & 31];
    const uint16_t *lpal = &t.al_pal_y[(by * 3 + pl) * 8];
    const uint16_t *apal = &t.al_pal_x[(bx * 3 + pl) * 8];

    int cache[16], n_cache = 0;
    int li = 0, ai = 0;
    while (l_cache && a_cache) {
        const int lv = lpal[li], av = apal[ai];
        if (lv < av) {
            if (!n_cache || cache[n_cache - 1] != lv) cache[n_cache++] = lv;
            li++;
            l_cache--;
        } else {
            if (av == lv) {
                li++;
                l_cache--;
            }
            if (!n_cache || cache[n_cache - 1] != av) cache[n_cache++] = av;
            ai++;
            a_cache--;
        }
    }
    while (l_cache > 0) {
        const int v = lpal[li++];
        l_cache--;
        if (!n_cache || cache[n_cache - 1] != v) cache[n_cache++] = v;
    }
    while (a_cache > 0) {
        const int v = apal[ai++];
        a_cache--;
        if (!n_cache || cache[n_cache - 1] != v) cache[n_cache++] = v;
    }

    int used[8], n_used = 0;
    for (int i = 0; i < n_cache; i++) {
        if (n_used >= pal_sz) break;
        if (ec::bool_equi(m)) used[n_used++] = cache[i];
    }

    int out[8];
    if (n_used < pal_sz) {
        int newv[8], n_new = 0;
        int prev = ec::bools(m, bpc);
        newv[n_new++] = prev;
        int i = n_used + 1;
        if (i < pal_sz) {
            int bits = bpc - 3 + ec::bools(m, 2);
            const int mx = (1 << bpc) - 1;
            const int add1 = pl ? 0 : 1;
            while (i < pal_sz) {
                const int delta = ec::bools(m, bits);
                prev = prev + delta + add1;
                if (prev > mx) prev = mx;
                newv[n_new++] = prev;
                i++;
                if (prev + add1 >= mx) {
                    while (i < pal_sz) {
                        newv[n_new++] = mx;
                        i++;
                    }
                    break;
                }
                const int b2 = 1 + ulog2(mx - prev - add1);
                if (b2 < bits) bits = b2;
            }
        }
        // sorted merge of reused cache entries and new entries
        int n = 0, mm = 0;
        for (int k = 0; k < pal_sz; k++) {
            if (n < n_used && (mm >= n_new || used[n] <= newv[mm]))
                out[k] = used[n++];
            else
                out[k] = newv[mm++];
        }
    } else {
        for (int k = 0; k < pal_sz; k++) out[k] = used[k];
    }
    for (int k = 0; k < 8; k++) pal_out[k] = k < pal_sz ? out[k] : 0;
}

void read_pal_v(TileDec &t, Blk &b, uint16_t *pal_out) {
    ec::Msac *m = &t.m;
    const int bpc = t.bitdepth;
    const int pal_sz = b.f[B_PAL_SZ1];
    int out[8];
    if (ec::bool_equi(m)) {
        const int bits = bpc - 4 + ec::bools(m, 2);
        int prev = ec::bools(m, bpc);
        out[0] = prev;
        const int mx = (1 << bpc) - 1;
        for (int i = 1; i < pal_sz; i++) {
            int delta = ec::bools(m, bits);
            if (delta && ec::bool_equi(m)) delta = -delta;
            prev = (prev + delta) & mx;
            out[i] = prev;
        }
    } else {
        for (int i = 0; i < pal_sz; i++) out[i] = ec::bools(m, bpc);
    }
    for (int k = 0; k < 8; k++) pal_out[k] = k < pal_sz ? out[k] : 0;
}

// returns offset into palidx buffer; writes (bh4*4) x (bw4*4) u8
int64_t read_pal_indices(TileDec &t, Blk &b, int pl, int w4, int h4,
                         int bw4, int bh4) {
    ec::Msac *m = &t.m;
    const int pal_sz = b.f[pl ? B_PAL_SZ1 : B_PAL_SZ0];
    const int W = bw4 * 4, H = bh4 * 4;
    const int64_t off = t.palidx_used;
    if (off + (int64_t)W * H > t.palidx_cap) {
        t.err = -3;
        return -1;
    }
    t.palidx_used += (int64_t)W * H;
    uint8_t *tmp = t.palidx + off;  // row-major [H][W]
    memset(tmp, 0, (size_t)W * H);
    tmp[0] = ec::uniform(m, pal_sz);
    uint16_t *cmap_cdf = t.cdf(CDF_COLOR_MAP) +
                         ((pl * 7 + (pal_sz - 2)) * 5) * 8;
    for (int i = 1; i < 4 * (w4 + h4) - 1; i++) {
        const int first = i < w4 * 4 - 1 ? i : w4 * 4 - 1;
        const int last = i - h4 * 4 + 1 > 0 ? i - h4 * 4 + 1 : 0;
        bool have_top = i > first;
        for (int j = first; j >= last; j--) {
            const bool have_left = j > 0;
            const int y = i - j, x = j;
            int order[8], n_ord = 0;
            unsigned mask = 0;
            auto add = [&](int v) {
                order[n_ord++] = v;
                mask |= 1u << v;
            };
            int ctx;
            if (!have_left) {
                ctx = 0;
                add(tmp[(y - 1) * W + x]);
            } else if (!have_top) {
                ctx = 0;
                add(tmp[y * W + x - 1]);
            } else {
                const int lv = tmp[y * W + x - 1];
                const int tv = tmp[(y - 1) * W + x];
                const int tl = tmp[(y - 1) * W + x - 1];
                const bool same_t_l = tv == lv;
                const bool same_t_tl = tv == tl;
                const bool same_l_tl = lv == tl;
                if (same_t_l && same_t_tl && same_l_tl) {
                    ctx = 4;
                    add(tv);
                } else if (same_t_l) {
                    ctx = 3;
                    add(tv);
                    add(tl);
                } else if (same_t_tl || same_l_tl) {
                    ctx = 2;
                    add(tl);
                    add(same_t_tl ? lv : tv);
                } else {
                    ctx = 1;
                    add(tv < lv ? tv : lv);
                    add(tv > lv ? tv : lv);
                    add(tl);
                }
            }
            for (int bit = 0; bit < 8; bit++)
                if (!(mask & (1u << bit))) order[n_ord++] = bit;
            const int color_idx = ec::symbol_adapt(m, cmap_cdf + 8 * ctx,
                                                   pal_sz - 1);
            tmp[y * W + x] = (uint8_t)order[color_idx];
            have_top = true;
        }
    }
    // dav1d pal.c pal_idx_finish: replicate last col/row into padding
    if (w4 < bw4)
        for (int y = 0; y < H; y++)
            for (int x = w4 * 4; x < W; x++)
                tmp[y * W + x] = tmp[y * W + w4 * 4 - 1];
    if (h4 < bh4)
        for (int y = h4 * 4; y < H; y++)
            memcpy(tmp + y * W, tmp + (h4 * 4 - 1) * W, W);
    return off;
}

// ---------------------------------------------------------------
// loop restoration info (host/tilecoder.py _read_lr_for_sb/
// _read_restoration_info; dav1d decode.c:2555,2707-2757)
// ---------------------------------------------------------------
void read_restoration_info(TileDec &t, int p, int frame_type, int row,
                           int col) {
    ec::Msac *m = &t.m;
    auto &ref = t.lr_ref[p];
    int type = 0;
    int fv[3] = {0, 0, 0}, fh[3] = {0, 0, 0};
    int sw[2] = {ref.sw[0], ref.sw[1]};
    const int RESTORATION_SWITCHABLE = 1, RESTORATION_WIENER = 2,
              RESTORATION_SGRPROJ = 3;
    if (frame_type == RESTORATION_SWITCHABLE) {
        const int filt = ec::symbol_adapt(m, t.cdf(CDF_RESTORE_SWITCHABLE),
                                          2);
        type = filt + (filt ? 1 : 0);
    } else {
        uint16_t *cdf = frame_type == RESTORATION_WIENER
                            ? t.cdf(CDF_RESTORE_WIENER)
                            : t.cdf(CDF_RESTORE_SGRPROJ);
        const int tt = ec::bool_adapt(m, cdf);
        type = tt ? frame_type : 0;
    }
    if (type == RESTORATION_WIENER) {
        fv[0] = p ? 0 : ec::subexp(m, ref.fv[0] + 5, 16, 1) - 5;
        fv[1] = ec::subexp(m, ref.fv[1] + 23, 32, 2) - 23;
        fv[2] = ec::subexp(m, ref.fv[2] + 17, 64, 3) - 17;
        fh[0] = p ? 0 : ec::subexp(m, ref.fh[0] + 5, 16, 1) - 5;
        fh[1] = ec::subexp(m, ref.fh[1] + 23, 32, 2) - 23;
        fh[2] = ec::subexp(m, ref.fh[2] + 17, 64, 3) - 17;
        sw[0] = ref.sw[0];
        sw[1] = ref.sw[1];
        ref.type = type;
        memcpy(ref.fv, fv, sizeof(fv));
        memcpy(ref.fh, fh, sizeof(fh));
        ref.sw[0] = sw[0];
        ref.sw[1] = sw[1];
    } else if (type == RESTORATION_SGRPROJ) {
        const int idx = ec::bools(m, 4);
        const uint16_t *sgr = t.t_sgrparams + 2 * idx;
        type += idx;
        sw[0] = sgr[0] ? ec::subexp(m, ref.sw[0] + 96, 128, 4) - 96 : 0;
        sw[1] = sgr[1] ? ec::subexp(m, ref.sw[1] + 32, 128, 4) - 32 : 95;
        memcpy(fv, ref.fv, sizeof(fv));
        memcpy(fh, ref.fh, sizeof(fh));
        ref.type = type;
        ref.sw[0] = sw[0];
        ref.sw[1] = sw[1];
        memcpy(ref.fv, fv, sizeof(fv));
        memcpy(ref.fh, fh, sizeof(fh));
    }
    if (t.n_lr >= t.lr_cap) {
        t.err = -4;
        return;
    }
    int32_t *r = t.lr_rec + t.n_lr * LR_NFIELDS;
    r[0] = p;
    r[1] = row;
    r[2] = col;
    r[3] = type;
    r[4] = fv[0];
    r[5] = fv[1];
    r[6] = fv[2];
    r[7] = fh[0];
    r[8] = fh[1];
    r[9] = fh[2];
    r[10] = sw[0];
    r[11] = sw[1];
    t.n_lr++;
}

void read_lr_for_sb(TileDec &t, int bx, int by) {
    if (!t.restore_planes) return;
    const int32_t *c = t.cfg;
    for (int p = 0; p < 3; p++) {
        if (!((t.restore_planes >> p) & 1)) continue;
        const int ss_ver = (p && t.layout == LAYOUT_I420) ? 1 : 0;
        const int ss_hor = (p && t.layout != LAYOUT_I444) ? 1 : 0;
        const int us_log2 = c[CFG_RESTORATION_UNIT_SIZE + (p ? 1 : 0)];
        const int y = (by * 4) >> ss_ver;
        const int hh = (c[CFG_FRAME_HEIGHT] + ss_ver) >> ss_ver;
        const int unit_size = 1 << us_log2;
        const int mask = unit_size - 1;
        if (y & mask) continue;
        const int half = unit_size >> 1;
        if (y && y + half > hh) continue;
        if (c[CFG_FRAME_WIDTH0] != c[CFG_FRAME_WIDTH1]) {
            // super-res: units live on the upscaled grid
            // (dav1d decode.c:2726-2743)
            const int ww = (c[CFG_FRAME_WIDTH1] + ss_hor) >> ss_hor;
            int n_units = (ww + half) >> us_log2;
            if (n_units < 1) n_units = 1;
            const int d = c[CFG_SUPER_RES_DENOM];
            const int rnd = unit_size * 8 - 1;
            const int shift = us_log2 + 3;
            const int x0 = (((4 * bx * d) >> ss_hor) + rnd) >> shift;
            const int x1 =
                ((((4 * (bx + t.sb_step)) * d) >> ss_hor) + rnd) >> shift;
            const int xe = x1 < n_units ? x1 : n_units;
            for (int x = x0; x < xe; x++) {
                const int px_x = x << (us_log2 + ss_hor);
                read_restoration_info(t, p, c[CFG_RESTORATION_TYPE + p],
                                      (by * 4) >> 6, px_x >> 6);
            }
            continue;
        }
        const int x = (4 * bx) >> ss_hor;
        if (x & mask) continue;
        const int ww = (c[CFG_FRAME_WIDTH0] + ss_hor) >> ss_hor;
        if (x && x + half > ww) continue;
        read_restoration_info(t, p, c[CFG_RESTORATION_TYPE + p],
                              (by * 4) >> 6, (bx * 4) >> 6);
    }
}

// ---------------------------------------------------------------
// coefficients (host/tilecoder.py _read_coef_blocks/_read_coef_tree/
// _decode_coefs; dav1d recon_tmpl.c decode_coefs:321,
// read_coef_blocks:825, read_coef_tree:726)
// ---------------------------------------------------------------
int get_skip_ctx(TileDec &t, const uint8_t *t_dim, int bs,
                 const uint8_t *a_arr, int a_off, const uint8_t *l_arr,
                 int l_off, int chroma) {
    const uint8_t *b_dim = t.bdim(bs);
    const int lw = t_dim[2], lh = t_dim[3];
    if (chroma) {
        const int ss_ver = t.ss_ver, ss_hor = t.ss_hor;
        const int bl2w = b_dim[2], bl2h = b_dim[3];
        const bool not_one_blk =
            (bl2w - ((bl2w && ss_hor) ? 1 : 0) > lw ||
             bl2h - ((bl2h && ss_ver) ? 1 : 0) > lh);
        int ca = 0, cl = 0;
        for (int k = 0; k < (1 << lw); k++)
            if (a_arr[a_off + k] != 0x40) { ca = 1; break; }
        for (int k = 0; k < (1 << lh); k++)
            if (l_arr[l_off + k] != 0x40) { cl = 1; break; }
        return 7 + 3 * (int)not_one_blk + ca + cl;
    }
    if (b_dim[2] == lw && b_dim[3] == lh) return 0;
    int la = 0, ll = 0;
    for (int k = 0; k < (1 << lw); k++) la |= a_arr[a_off + k];
    for (int k = 0; k < (1 << lh); k++) ll |= l_arr[l_off + k];
    la &= 0x3F;
    ll &= 0x3F;
    return t.t_skipctx[(la < 4 ? la : 4) * 5 + (ll < 4 ? ll : 4)];
}

int get_dc_sign_ctx(TileDec &t, int tx, const uint8_t *a_arr, int a_off,
                    const uint8_t *l_arr, int l_off) {
    const uint8_t *t_dim = t.txdim(tx);
    const int tw = t_dim[0], th = t_dim[1];
    int s = 0;
    for (int k = 0; k < tw; k++) s += a_arr[a_off + k] >> 6;
    for (int k = 0; k < th; k++) s += l_arr[l_off + k] >> 6;
    s -= tw + th;
    return (s != 0) + (s > 0);
}

// Result of one transform-block decode.
struct CoefRes {
    int eob, txtp, cf_ctx;
};

CoefRes decode_coefs(TileDec &t, const Blk &b, int tx, int bs, int intra,
                     int plane, uint8_t *a_arr, int a_off, uint8_t *l_arr,
                     int l_off, int ytxtp, int cbx, int cby) {
    ec::Msac *m = &t.m;
    const int chroma = plane ? 1 : 0;
    const int seg_id = b.f[B_SEG_ID];
    const bool lossless = t.cfg[CFG_SEG_LOSSLESS + seg_id];
    const uint8_t *t_dim = t.txdim(tx);
    const int tw = t_dim[0], th = t_dim[1];
    const int lw = t_dim[2], lh = t_dim[3];
    const int t_min = t_dim[4], t_max = t_dim[5], t_ctx = t_dim[7];

    // skip
    const int sctx = get_skip_ctx(t, t_dim, bs, a_arr, a_off, l_arr, l_off,
                                  chroma);
    const int all_skip = ec::bool_adapt(
        m, t.cdf(CDF_C_SKIP) + (t_ctx * 13 + sctx) * 2);
    if (all_skip)
        return {-1, lossless ? WHT_WHT : DCT_DCT, 0x40};

    // txtp
    int txtp;
    if (lossless) {
        txtp = WHT_WHT;
    } else if (t_max + intra >= TX_64X64) {
        txtp = DCT_DCT;
    } else if (chroma) {
        txtp = intra ? t.t_txtpfromuv[b.f[B_UV_MODE]]
                     : get_uv_inter_txtp(t_dim, ytxtp);
    } else if (!t.cfg[CFG_SEG_QIDX + seg_id]) {
        txtp = DCT_DCT;
    } else if (intra) {
        int y_mode_nofilt;
        if (b.f[B_Y_MODE] == FILTER_PRED)
            y_mode_nofilt = t.t_filt2ymode[b.f[B_Y_ANGLE]];
        else
            y_mode_nofilt = b.f[B_Y_MODE];
        if (t.cfg[CFG_REDUCED_TXTP_SET] || t_min == TX_16X16) {
            const int idx = ec::symbol_adapt(
                m,
                t.cdf(CDF_TXTP_INTRA2) + (t_min * 13 + y_mode_nofilt) * 8,
                4);
            txtp = t.t_txtypesperset[idx + 0];
        } else {
            const int idx = ec::symbol_adapt(
                m,
                t.cdf(CDF_TXTP_INTRA1) + (t_min * 13 + y_mode_nofilt) * 8,
                6);
            txtp = t.t_txtypesperset[idx + 5];
        }
    } else {
        // dav1d recon_tmpl.c decode_coefs:383-397
        if (t.cfg[CFG_REDUCED_TXTP_SET] || t_max == TX_32X32) {
            const int idx =
                ec::bool_adapt(m, t.cdf(CDF_TXTP_INTER3) + t_min * 2);
            txtp = idx ? DCT_DCT : IDTX;
        } else if (t_min == TX_16X16) {
            const int idx = ec::symbol_adapt(m, t.cdf(CDF_TXTP_INTER2), 11);
            txtp = t.t_txtypesperset[idx + 12];
        } else {
            const int idx = ec::symbol_adapt(
                m, t.cdf(CDF_TXTP_INTER1) + t_min * 16, 15);
            txtp = t.t_txtypesperset[idx + 24];
        }
    }

    // eob cdf selection
    const int lw32 = lw < TX_32X32 ? lw : TX_32X32;
    const int lh32 = lh < TX_32X32 ? lh : TX_32X32;
    const int tx2dszctx = lw32 + lh32;
    const int tx_class = t.t_txtypeclass[txtp];
    const int is_1d = tx_class != TX_CLASS_2D;
    uint16_t *eob_bin_cdf;
    switch (tx2dszctx) {
    case 0:
        eob_bin_cdf = t.cdf(CDF_C_EOB_BIN_16) + (chroma * 2 + is_1d) * 8;
        break;
    case 1:
        eob_bin_cdf = t.cdf(CDF_C_EOB_BIN_32) + (chroma * 2 + is_1d) * 8;
        break;
    case 2:
        eob_bin_cdf = t.cdf(CDF_C_EOB_BIN_64) + (chroma * 2 + is_1d) * 8;
        break;
    case 3:
        eob_bin_cdf = t.cdf(CDF_C_EOB_BIN_128) + (chroma * 2 + is_1d) * 8;
        break;
    case 4:
        eob_bin_cdf = t.cdf(CDF_C_EOB_BIN_256) + (chroma * 2 + is_1d) * 16;
        break;
    case 5:
        eob_bin_cdf = t.cdf(CDF_C_EOB_BIN_512) + chroma * 16;
        break;
    default:
        eob_bin_cdf = t.cdf(CDF_C_EOB_BIN_1024) + chroma * 16;
        break;
    }
    uint16_t *eob_hi_cdf =
        t.cdf(CDF_C_EOB_HI_BIT) + (t_ctx * 2 + chroma) * 11 * 2;
    uint16_t *eob_base_cdf =
        t.cdf(CDF_C_EOB_BASE_TOK) + (t_ctx * 2 + chroma) * 4 * 4;
    uint16_t *base_cdf =
        t.cdf(CDF_C_BASE_TOK) + (t_ctx * 2 + chroma) * 41 * 4;
    const int br_ctx = t_ctx < 3 ? t_ctx : 3;
    uint16_t *br_cdf = t.cdf(CDF_C_BR_TOK) + (br_ctx * 2 + chroma) * 21 * 4;
    const int dc_sign_ctx =
        get_dc_sign_ctx(t, tx, a_arr, a_off, l_arr, l_off);
    uint16_t *dc_sign_cdf =
        t.cdf(CDF_C_DC_SIGN) + (chroma * 3 + dc_sign_ctx) * 2;

    const int sw4 = tw < 8 ? tw : 8;
    const int sh4 = th < 8 ? th : 8;

    const uint16_t *scan = nullptr;
    const uint8_t *lo_ctx = nullptr;
    if (tx_class == TX_CLASS_2D) {
        const int nonsquare_tx = tx >= 5;  // RTX_4X8
        lo_ctx = t.t_loctxoff + (nonsquare_tx + (tx & nonsquare_tx)) * 25;
        scan = t.t_scan[tx];
    }
    const int32_t *dq = t.dq_cur[seg_id][plane];
    const uint8_t *qm = txtp < IDTX ? t.t_qm[tx][plane] : nullptr;
    const int dq_shift = t_ctx - 2 > 0 ? t_ctx - 2 : 0;
    const int32_t cf_max =
        ~((~127) << (t.bitdepth == 8 ? 8 : t.bitdepth));

    const int n_coef = 4 * sw4 * 4 * sh4;
    if (t.cf_used + n_coef > t.cf_cap || t.n_coefs >= t.coefs_cap) {
        t.err = -2;
        return {-1, DCT_DCT, 0x40};
    }
    int32_t *cf_out = t.cf + t.cf_used;
    memset(cf_out, 0, sizeof(int32_t) * n_coef);
    int32_t eob;
    const int cf_ctx = coef_decode_block(
        m, eob_bin_cdf, 4 + tx2dszctx, eob_hi_cdf, eob_base_cdf, base_cdf,
        br_cdf, dc_sign_cdf, tx_class, sw4, sh4, lw, lh, scan, lo_ctx,
        dq[0], dq[1], qm, dq_shift, cf_max, cf_out, &eob);

    // emit record
    int32_t *r = t.coef + t.n_coefs * C_NFIELDS;
    r[C_PLANE] = plane;
    r[C_X] = cbx;
    r[C_Y] = cby;
    r[C_TX] = tx;
    r[C_TXTP] = txtp;
    r[C_EOB] = eob;
    r[C_CF_OFF] = (int32_t)t.cf_used;
    r[C_CF_LEN] = n_coef;
    t.n_coefs++;
    t.cf_used += n_coef;
    return {eob, txtp, cf_ctx};
}

// emits a coef record with no data (all-skip) — mirrors the Python path
// where CoefBlock.cf is None
void emit_skip_coef(TileDec &t, int plane, int cbx, int cby, int tx,
                    int txtp) {
    if (t.n_coefs >= t.coefs_cap) {
        t.err = -2;
        return;
    }
    int32_t *r = t.coef + t.n_coefs * C_NFIELDS;
    r[C_PLANE] = plane;
    r[C_X] = cbx;
    r[C_Y] = cby;
    r[C_TX] = tx;
    r[C_TXTP] = txtp;
    r[C_EOB] = -1;
    r[C_CF_OFF] = -1;
    r[C_CF_LEN] = 0;
    t.n_coefs++;
}

void ctx_fill(uint8_t *arr, int off, int len, uint8_t v) {
    memset(arr + off, v, len);
}

void read_coef_tree(TileDec &t, Blk &b, int bs, int ytx, int depth,
                    const int tx_split[2], int x_off, int y_off, int bx,
                    int by) {
    // dav1d recon_tmpl.c read_coef_tree:726
    const uint8_t *t_dim = t.txdim(ytx);
    const int tw = t_dim[0], th = t_dim[1];
    if (depth < 2 && tx_split[depth] &&
        (tx_split[depth] & (1 << (y_off * 4 + x_off)))) {
        const int sub = t_dim[6];
        const uint8_t *sub_t = t.txdim(sub);
        const int txsw = sub_t[0], txsh = sub_t[1];
        read_coef_tree(t, b, bs, sub, depth + 1, tx_split, x_off * 2,
                       y_off * 2, bx, by);
        if (tw >= th && bx + txsw < t.bw)
            read_coef_tree(t, b, bs, sub, depth + 1, tx_split,
                           x_off * 2 + 1, y_off * 2, bx + txsw, by);
        if (th >= tw && by + txsh < t.bh) {
            read_coef_tree(t, b, bs, sub, depth + 1, tx_split, x_off * 2,
                           y_off * 2 + 1, bx, by + txsh);
            if (tw >= th && bx + txsw < t.bw)
                read_coef_tree(t, b, bs, sub, depth + 1, tx_split,
                               x_off * 2 + 1, y_off * 2 + 1, bx + txsw,
                               by + txsh);
        }
    } else {
        const int bx4 = bx & 31, by4 = by & 31;
        BlockContext &a = t.a_at(bx);
        BlockContext &l = t.l;
        CoefRes cr = decode_coefs(t, b, ytx, bs, 0, 0, a.lcoef, bx4,
                                  l.lcoef, by4, 0, bx, by);
        if (t.err) return;
        if (cr.eob < 0) emit_skip_coef(t, 0, bx, by, ytx, cr.txtp);
        const int nh = th < t.bh - by ? th : t.bh - by;
        const int nw = tw < t.bw - bx ? tw : t.bw - bx;
        ctx_fill(l.lcoef, by4, nh, (uint8_t)cr.cf_ctx);
        ctx_fill(a.lcoef, bx4, nw, (uint8_t)cr.cf_ctx);
        for (int y = 0; y < th; y++)
            memset(t.txtp_map + (by4 + y) * 32 + bx4, cr.txtp, tw);
    }
}

void read_coef_blocks(TileDec &t, Blk &b, int bs, int bx, int by, int w4,
                      int h4, bool has_chroma) {
    const int ss_ver = t.ss_ver, ss_hor = t.ss_hor;
    const int bx4 = bx & 31, by4 = by & 31;
    const int cbx4 = bx4 >> ss_hor, cby4 = by4 >> ss_ver;
    const uint8_t *b_dim = t.bdim(bs);
    const int bw4 = b_dim[0], bh4 = b_dim[1];
    const int cbw4 = (bw4 + ss_hor) >> ss_hor;
    const int cbh4 = (bh4 + ss_ver) >> ss_ver;
    const int cw4 = (w4 + ss_hor) >> ss_hor;
    const int ch4 = (h4 + ss_ver) >> ss_ver;
    BlockContext &l = t.l;

    if (b.f[B_SKIP]) {
        BlockContext &a = t.a_at(bx);
        ctx_fill(a.lcoef, bx4, bw4, 0x40);
        ctx_fill(l.lcoef, by4, bh4, 0x40);
        if (has_chroma) {
            ctx_fill(a.ccoef[0], cbx4, cbw4, 0x40);
            ctx_fill(a.ccoef[1], cbx4, cbw4, 0x40);
            ctx_fill(l.ccoef[0], cby4, cbh4, 0x40);
            ctx_fill(l.ccoef[1], cby4, cbh4, 0x40);
        }
        return;
    }

    const int intra = b.f[B_INTRA];
    const uint8_t *t_dim = t.txdim(intra ? b.f[B_TX] : b.f[B_MAX_YTX]);
    const uint8_t *uv_t_dim = t.txdim(b.f[B_UVTX]);
    const int tw = t_dim[0], th = t_dim[1];
    const int ctw = uv_t_dim[0], cth = uv_t_dim[1];
    const int tx_split[2] = {b.f[B_TX_SPLIT0], b.f[B_TX_SPLIT1]};

    for (int init_y = 0; init_y < h4; init_y += 16) {
        const int sub_h4 = h4 < 16 + init_y ? h4 : 16 + init_y;
        for (int init_x = 0; init_x < w4; init_x += 16) {
            const int sub_w4 = w4 < init_x + 16 ? w4 : init_x + 16;
            int y_off = init_y ? 1 : 0;
            for (int y = init_y; y < sub_h4; y += th, y_off++) {
                int x_off = init_x ? 1 : 0;
                for (int x = init_x; x < sub_w4;) {
                    if (!intra) {
                        read_coef_tree(t, b, bs, b.f[B_MAX_YTX], 0,
                                       tx_split, x_off, y_off, bx + x,
                                       by + y);
                        if (t.err) return;
                        x += tw;
                        x_off++;
                        continue;
                    }
                    BlockContext &a = t.a_at(bx);
                    CoefRes cr = decode_coefs(t, b, b.f[B_TX], bs, 1, 0,
                                              a.lcoef, bx4 + x, l.lcoef,
                                              by4 + y, 0, bx + x, by + y);
                    if (t.err) return;
                    if (cr.eob < 0)
                        emit_skip_coef(t, 0, bx + x, by + y, b.f[B_TX],
                                       cr.txtp);
                    const int nh =
                        th < t.bh - (by + y) ? th : t.bh - (by + y);
                    const int nw =
                        tw < t.bw - (bx + x) ? tw : t.bw - (bx + x);
                    ctx_fill(l.lcoef, by4 + y, nh, (uint8_t)cr.cf_ctx);
                    ctx_fill(a.lcoef, bx4 + x, nw, (uint8_t)cr.cf_ctx);
                    x += tw;
                }
            }

            if (!has_chroma) continue;
            const int sub_ch4 =
                ch4 < ((init_y + 16) >> ss_ver) ? ch4
                                                : (init_y + 16) >> ss_ver;
            const int sub_cw4 =
                cw4 < ((init_x + 16) >> ss_hor) ? cw4
                                                : (init_x + 16) >> ss_hor;
            for (int pl = 0; pl < 2; pl++) {
                for (int y = init_y >> ss_ver; y < sub_ch4; y += cth) {
                    for (int x = init_x >> ss_hor; x < sub_cw4; x += ctw) {
                        const int ytxtp =
                            intra ? 0
                                  : t.txtp_map[(by4 + (y << ss_ver)) * 32 +
                                               bx4 + (x << ss_hor)];
                        BlockContext &a = t.a_at(bx);
                        CoefRes cr = decode_coefs(
                            t, b, b.f[B_UVTX], bs, intra, 1 + pl,
                            a.ccoef[pl], cbx4 + x, l.ccoef[pl], cby4 + y,
                            ytxtp, (bx >> ss_hor) + x, (by >> ss_ver) + y);
                        if (t.err) return;
                        if (cr.eob < 0)
                            emit_skip_coef(t, 1 + pl, (bx >> ss_hor) + x,
                                           (by >> ss_ver) + y, b.f[B_UVTX],
                                           cr.txtp);
                        // dav1d: imin(uv_t_dim->h, (f->bh - t->by + ss_ver)
                        //             >> ss_ver), t->by in luma units
                        const int tby = by + (y << ss_ver);
                        const int tbx = bx + (x << ss_hor);
                        int nh = (t.bh - tby + ss_ver) >> ss_ver;
                        if (cth < nh) nh = cth;
                        int nw = (t.bw - tbx + ss_hor) >> ss_hor;
                        if (ctw < nw) nw = ctw;
                        ctx_fill(l.ccoef[pl], cby4 + y, nh,
                                 (uint8_t)cr.cf_ctx);
                        ctx_fill(a.ccoef[pl], cbx4 + x, nw,
                                 (uint8_t)cr.cf_ctx);
                    }
                }
            }
        }
    }
}

// ---------------------------------------------------------------
// mv residuals (host/tilecoder.py _read_mv_component_diff/
// _read_mv_residual; dav1d decode.c read_mv_residual:120)
// ---------------------------------------------------------------
int read_mv_component_diff(TileDec &t, int comp_base, int have_fp) {
    // comp_base = CDF_MV0_CLASSES or CDF_DMV0_CLASSES (+8 for comp1)
    ec::Msac *m = &t.m;
    const int have_hp = t.cfg[CFG_HP];
    enum { O_CLASSES, O_CLASS0, O_CLASSN, O_CLASS0_FP, O_CLASSN_FP,
           O_CLASS0_HP, O_CLASSN_HP, O_SIGN };
    const int sign = ec::bool_adapt(m, t.cdf(comp_base + O_SIGN));
    const int cl = ec::symbol_adapt(m, t.cdf(comp_base + O_CLASSES), 10);
    int up, fp, hp;
    if (cl == 0) {
        up = ec::bool_adapt(m, t.cdf(comp_base + O_CLASS0));
        if (have_fp) {
            fp = ec::symbol_adapt(m, t.cdf(comp_base + O_CLASS0_FP) + 4 * up,
                                  3);
            hp = have_hp ? ec::bool_adapt(m, t.cdf(comp_base + O_CLASS0_HP))
                         : 1;
        } else {
            fp = 3;
            hp = 1;
        }
    } else {
        up = 1 << cl;
        for (int n = 0; n < cl; n++)
            up |= ec::bool_adapt(m, t.cdf(comp_base + O_CLASSN) + 2 * n)
                  << n;
        if (have_fp) {
            fp = ec::symbol_adapt(m, t.cdf(comp_base + O_CLASSN_FP), 3);
            hp = have_hp ? ec::bool_adapt(m, t.cdf(comp_base + O_CLASSN_HP))
                         : 1;
        } else {
            fp = 3;
            hp = 1;
        }
    }
    const int diff = ((up << 3) | (fp << 1) | hp) + 1;
    return sign ? -diff : diff;
}

MV read_mv_residual(TileDec &t, MV ref_mv, bool dmv, int have_fp) {
    // dav1d quirk: the joint cdf always comes from cdf.mv (decode.c:123)
    ec::Msac *m = &t.m;
    const int j = ec::symbol_adapt(m, t.cdf(CDF_MV_JOINT), 3);
    const int base0 = dmv ? CDF_DMV0_CLASSES : CDF_MV0_CLASSES;
    const int base1 = dmv ? CDF_DMV1_CLASSES : CDF_MV1_CLASSES;
    int y = ref_mv.y, x = ref_mv.x;
    if (j == 3) {
        y = s16(y + read_mv_component_diff(t, base0, have_fp));
        x = s16(x + read_mv_component_diff(t, base1, have_fp));
    } else if (j == 1) {
        x = s16(x + read_mv_component_diff(t, base1, have_fp));
    } else if (j == 2) {
        y = s16(y + read_mv_component_diff(t, base0, have_fp));
    }
    return {y, x};
}

// ---------------------------------------------------------------
// var-tx tree (host/tilecoder.py _read_vartx_tree/_read_tx_tree;
// dav1d decode.c read_vartx_tree:473/read_tx_tree:141)
// ---------------------------------------------------------------
void read_tx_tree(TileDec &t, int from_tx, int depth, int masks[2],
                  int x_off, int y_off, int bx, int by) {
    const uint8_t *t_dim = t.txdim(from_tx);
    const int tw = t_dim[0], th = t_dim[1];
    const int lw = t_dim[2], lh = t_dim[3];
    const int bx4 = bx & 31, by4 = by & 31;
    BlockContext &a = t.a_at(bx);
    BlockContext &l = t.l;
    int is_split = 0;
    if (depth < 2 && from_tx > TX_4X4) {
        const int cat = 2 * (TX_64X64 - t_dim[5]) - depth;
        const int actx = a.tx[bx4] < lw;
        const int lctx = l.tx[by4] < lh;
        is_split = ec::bool_adapt(
            &t.m, t.cdf(CDF_TXPART) + (cat * 3 + actx + lctx) * 2);
        if (is_split) masks[depth] |= 1 << (y_off * 4 + x_off);
    }
    if (is_split && t_dim[5] > TX_8X8) {
        const int sub = t_dim[6];
        const uint8_t *sub_t = t.txdim(sub);
        const int txsw = sub_t[0], txsh = sub_t[1];
        read_tx_tree(t, sub, depth + 1, masks, x_off * 2, y_off * 2, bx,
                     by);
        if (tw >= th && bx + txsw < t.bw)
            read_tx_tree(t, sub, depth + 1, masks, x_off * 2 + 1, y_off * 2,
                         bx + txsw, by);
        if (th >= tw && by + txsh < t.bh) {
            read_tx_tree(t, sub, depth + 1, masks, x_off * 2, y_off * 2 + 1,
                         bx, by + txsh);
            if (tw >= th && bx + txsw < t.bw)
                read_tx_tree(t, sub, depth + 1, masks, x_off * 2 + 1,
                             y_off * 2 + 1, bx + txsw, by + txsh);
        }
    } else {
        for (int i = 0; i < th; i++)
            l.tx[by4 + i] = is_split ? TX_4X4 : lh;
        for (int i = 0; i < tw; i++)
            a.tx[bx4 + i] = is_split ? TX_4X4 : lw;
    }
}

void read_vartx_tree(TileDec &t, Blk &b, int bs, int bx4, int by4, int bx,
                     int by) {
    const uint8_t *b_dim = t.bdim(bs);
    const int bw4 = b_dim[0], bh4 = b_dim[1];
    BlockContext &a = t.a_at(bx);
    BlockContext &l = t.l;
    int tx_split[2] = {0, 0};
    b.f[B_MAX_YTX] = t.t_maxtx[4 * bs + 0];
    const int seg_id = b.f[B_SEG_ID];
    const bool lossless = t.cfg[CFG_SEG_LOSSLESS + seg_id];
    const int txfm_mode = t.cfg[CFG_TXFM_MODE];
    if (!b.f[B_SKIP] && (lossless || b.f[B_MAX_YTX] == TX_4X4)) {
        b.f[B_MAX_YTX] = b.f[B_UVTX] = TX_4X4;
        if (txfm_mode == TX_SWITCHABLE) {
            for (int i = 0; i < bh4; i++) l.tx[by4 + i] = TX_4X4;
            for (int i = 0; i < bw4; i++) a.tx[bx4 + i] = TX_4X4;
        }
    } else if (txfm_mode != TX_SWITCHABLE || b.f[B_SKIP]) {
        if (txfm_mode == TX_SWITCHABLE) {
            for (int i = 0; i < bh4; i++) l.tx[by4 + i] = (int8_t)b_dim[3];
            for (int i = 0; i < bw4; i++) a.tx[bx4 + i] = (int8_t)b_dim[2];
        }
        b.f[B_UVTX] = t.t_maxtx[4 * bs + t.layout];
    } else {
        const uint8_t *ytx = t.txdim(b.f[B_MAX_YTX]);
        const int yw = ytx[0], yh = ytx[1];
        int y_off = 0;
        for (int yy = 0; yy < bh4; yy += yh, y_off++) {
            int x_off = 0;
            for (int xx = 0; xx < bw4; xx += yw, x_off++)
                read_tx_tree(t, b.f[B_MAX_YTX], 0, tx_split, x_off, y_off,
                             bx + xx, by + yy);
        }
        b.f[B_UVTX] = t.t_maxtx[4 * bs + t.layout];
    }
    b.f[B_TX] = b.f[B_MAX_YTX];
    b.f[B_TX_SPLIT0] = tx_split[0];
    b.f[B_TX_SPLIT1] = tx_split[1];
}

// ---------------------------------------------------------------
// intra block copy (host/tilecoder.py _intrabc_*; dav1d
// decode.c:1304-1420)
// ---------------------------------------------------------------
// returns false if mv cannot be made valid (decode error)
bool intrabc_clip(TileDec &t, MV mv, int bs, int bx, int by,
                  bool has_chroma, MV *out) {
    const uint8_t *b_dim = t.bdim(bs);
    const int bw4 = b_dim[0], bh4 = b_dim[1];
    int border_left = t.col_start * 4;
    int border_top = t.row_start * 4;
    if (has_chroma) {
        if (bw4 < 2 && t.ss_hor) border_left += 4;
        if (bh4 < 2 && t.ss_ver) border_top += 4;
    }
    int src_left = bx * 4 + (mv.x >> 3);
    int src_top = by * 4 + (mv.y >> 3);
    int src_right = src_left + bw4 * 4;
    int src_bottom = src_top + bh4 * 4;
    const int border_right = ((t.col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4;
    if (src_left < border_left) {
        src_right += border_left - src_left;
        src_left = border_left;
    } else if (src_right > border_right) {
        src_left -= src_right - border_right;
        src_right = border_right;
    }
    if (src_top < border_top) {
        src_bottom += border_top - src_top;
        src_top = border_top;
    }
    const int sbx = (bx >> (4 + t.sb128)) << (6 + t.sb128);
    const int sby = (by >> (4 + t.sb128)) << (6 + t.sb128);
    const int sb_size = 1 << (6 + t.sb128);
    if (src_bottom > sby && src_right > sbx) {
        if (src_top - border_top >= src_bottom - sby) {
            src_top -= src_bottom - sby;
            src_bottom = sby;
        } else if (src_left - border_left >= src_right - sbx) {
            src_left -= src_right - sbx;
            src_right = sbx;
        }
    }
    if (src_bottom > sby + sb_size) {
        src_top -= src_bottom - (sby + sb_size);
        src_bottom = sby + sb_size;
    }
    if (src_bottom > sby && src_right > sbx) return false;
    *out = {(src_top - by * 4) * 8, (src_left - bx * 4) * 8};
    return true;
}

MV intrabc_pred_mv(TileDec &t, int bs, int bx, int by, int edge_flags) {
    const int ref[2] = {0, -1};
    FindResult fr = refmvs_find(t, ref, bs, edge_flags, by, bx);
    if (fr.mv0[0].y != 0 || fr.mv0[0].x != 0) return fr.mv0[0];
    if (fr.mv0[1].y != 0 || fr.mv0[1].x != 0) return fr.mv0[1];
    if (by - (16 << t.sb128) < t.row_start)
        return {0, -(512 << t.sb128) - 2048};
    return {-(512 << t.sb128), 0};
}

void splat_intraref(TileDec &t, int by, int bx, int bw4, int bh4, int bs) {
    // dav1d decode.c splat_intraref:596
    splat_mv(t, by, bx, bw4, bh4, 0, -1, {INVALID_MV, INVALID_MV},
             {INVALID_MV, INVALID_MV}, bs, 0);
}

bool intrabc_block(TileDec &t, Blk &b, int bs, int bx, int by, int w4,
                   int h4, int edge_flags, int seg_pred, bool has_chroma) {
    const uint8_t *b_dim = t.bdim(bs);
    const int bw4 = b_dim[0], bh4 = b_dim[1];
    const int bx4 = bx & 31, by4 = by & 31;
    const MV pred = intrabc_pred_mv(t, bs, bx, by, edge_flags);
    const MV mv = read_mv_residual(t, pred, /*dmv=*/true, 0);
    MV clipped;
    if (!intrabc_clip(t, mv, bs, bx, by, has_chroma, &clipped))
        return false;  // invalid intrabc mv
    b.f[B_MV0Y] = clipped.y;
    b.f[B_MV0X] = clipped.x;
    b.f[B_REF0] = b.f[B_REF1] = -1;
    b.f[B_COMP_TYPE] = COMP_INTER_NONE;
    b.f[B_INTER_MODE] = 0;
    b.f[B_FILTER2D] = 9;  // FILTER_2D_BILINEAR
    read_vartx_tree(t, b, bs, bx4, by4, bx, by);
    b.f[B_COEF_LO] = (int32_t)t.n_coefs;
    read_coef_blocks(t, b, bs, bx, by, w4, h4, has_chroma);
    b.f[B_COEF_HI] = (int32_t)t.n_coefs;
    calc_lflvl(t, b.f[B_SEG_ID], 0, 0, &b.f[B_LF0]);
    // splat_intrabc_mv (decode.c:564)
    splat_mv(t, by, bx, bw4, bh4, 0, -1, clipped, {0, 0}, bs, 0);
    // context updates (decode.c:1401-1419)
    BlockContext &a = t.a_at(bx);
    BlockContext &l = t.l;
    const int ss_ver = t.ss_ver, ss_hor = t.ss_hor;
    const int cbx4 = bx4 >> ss_hor, cby4 = by4 >> ss_ver;
    const int cbw4 = (bw4 + ss_hor) >> ss_hor;
    const int cbh4 = (bh4 + ss_ver) >> ss_ver;
    ctx_fill((uint8_t *)l.tx_intra, by4, bh4, b_dim[3]);
    ctx_fill((uint8_t *)a.tx_intra, bx4, bw4, b_dim[2]);
    ctx_fill(l.mode, by4, bh4, DC_PRED);
    ctx_fill(a.mode, bx4, bw4, DC_PRED);
    ctx_fill(l.pal_sz, by4, bh4, 0);
    ctx_fill(a.pal_sz, bx4, bw4, 0);
    memset(&t.pal_sz_uv_x[bx], 0, bw4 < t.bw - bx ? bw4 : t.bw - bx);
    memset(&t.pal_sz_uv_y[by], 0, bh4 < t.bh - by ? bh4 : t.bh - by);
    ctx_fill(l.seg_pred, by4, bh4, seg_pred);
    ctx_fill(a.seg_pred, bx4, bw4, seg_pred);
    ctx_fill(l.skip_mode, by4, bh4, 0);
    ctx_fill(a.skip_mode, bx4, bw4, 0);
    ctx_fill(l.intra, by4, bh4, 0);
    ctx_fill(a.intra, bx4, bw4, 0);
    ctx_fill(l.skip, by4, bh4, b.f[B_SKIP]);
    ctx_fill(a.skip, bx4, bw4, b.f[B_SKIP]);
    if (has_chroma) {
        ctx_fill(l.uvmode, cby4, cbh4, DC_PRED);
        ctx_fill(a.uvmode, cbx4, cbw4, DC_PRED);
    }
    return true;
}

// ---------------------------------------------------------------
// inter block (host/tilecoder.py _inter_block; dav1d
// decode.c:1421-1975)
// ---------------------------------------------------------------
void inter_block(TileDec &t, Blk &b, int bl, int bs, int bx, int by, int w4,
                 int h4, int edge_flags, int seg_id_valid, int seg_pred,
                 int have_top, int have_left) {
    ec::Msac *m = &t.m;
    const int32_t *c = t.cfg;
    BlockContext &a = t.a_at(bx);
    BlockContext &l = t.l;
    const uint8_t *b_dim = t.bdim(bs);
    const int bw4 = b_dim[0], bh4 = b_dim[1];
    const int bx4 = bx & 31, by4 = by & 31;
    const int ss_ver = t.ss_ver, ss_hor = t.ss_hor;
    const int cbx4 = bx4 >> ss_hor, cby4 = by4 >> ss_ver;
    const int cbw4 = (bw4 + ss_hor) >> ss_hor;
    const int cbh4 = (bh4 + ss_ver) >> ss_ver;
    const bool has_chroma = !t.monochrome &&
                            (bw4 > ss_hor || (bx & 1)) &&
                            (bh4 > ss_ver || (by & 1));
    const int seg_id = b.f[B_SEG_ID];
    const bool has_seg = seg_id_valid;
    const int seg_ref = has_seg ? t.seg_field(seg_id, 5) : -1;
    const int seg_skip = has_seg ? t.seg_field(seg_id, 6) : 0;
    const int seg_gmv = has_seg ? t.seg_field(seg_id, 7) : 0;

    int is_comp;
    if (b.f[B_SKIP_MODE]) {
        is_comp = 1;
    } else if ((!has_seg || (seg_ref == -1 && !seg_gmv && !seg_skip)) &&
               c[CFG_SWITCHABLE_COMP_REFS] && (bw4 < bh4 ? bw4 : bh4) > 1) {
        const int cctx = get_comp_ctx(a, l, by4, bx4, have_top, have_left);
        is_comp = ec::bool_adapt(m, t.cdf(CDF_COMP) + 2 * cctx);
    } else {
        is_comp = 0;
    }

    int filter01[2] = {0, 0};
    int has_subpel_filter = 0;
    FindResult fr;
    MV bmv[2] = {{0, 0}, {0, 0}};

    if (b.f[B_SKIP_MODE]) {
        b.f[B_REF0] = c[CFG_SKIP_MODE_REFS];
        b.f[B_REF1] = c[CFG_SKIP_MODE_REFS + 1];
        b.f[B_COMP_TYPE] = COMP_INTER_AVG;
        b.f[B_INTER_MODE] = NEARESTMV_NEARESTMV;
        b.f[B_DRL_IDX] = NEAREST_DRL;
        has_subpel_filter = 0;
        const int ref[2] = {b.f[B_REF0] + 1, b.f[B_REF1] + 1};
        fr = refmvs_find(t, ref, bs, edge_flags, by, bx);
        bmv[0] = fix_mv_precision(t, fr.mv0[0]);
        bmv[1] = fix_mv_precision(t, fr.mv1[0]);
    } else if (is_comp) {
        const int dctx = get_comp_dir_ctx(a, l, by4, bx4, have_top,
                                          have_left);
        if (ec::bool_adapt(m, t.cdf(CDF_COMP_DIR) + 2 * dctx)) {
            // bidir
            const int c1 = get_fwd_ref_ctx(a, l, by4, bx4, have_top,
                                           have_left);
            if (ec::bool_adapt(m, t.cdf(CDF_COMP_FWD_REF) + (0 * 3 + c1) * 2)) {
                const int c2 = get_fwd_ref_2_ctx(a, l, by4, bx4, have_top,
                                                 have_left);
                b.f[B_REF0] = 2 + ec::bool_adapt(
                                      m,
                                      t.cdf(CDF_COMP_FWD_REF) +
                                          (2 * 3 + c2) * 2);
            } else {
                const int c2 = get_fwd_ref_1_ctx(a, l, by4, bx4, have_top,
                                                 have_left);
                b.f[B_REF0] = ec::bool_adapt(
                    m, t.cdf(CDF_COMP_FWD_REF) + (1 * 3 + c2) * 2);
            }
            const int c3 = get_bwd_ref_ctx(a, l, by4, bx4, have_top,
                                           have_left);
            if (ec::bool_adapt(m, t.cdf(CDF_COMP_BWD_REF) + (0 * 3 + c3) * 2)) {
                b.f[B_REF1] = 6;
            } else {
                const int c4 = get_bwd_ref_1_ctx(a, l, by4, bx4, have_top,
                                                 have_left);
                b.f[B_REF1] = 4 + ec::bool_adapt(
                                      m,
                                      t.cdf(CDF_COMP_BWD_REF) +
                                          (1 * 3 + c4) * 2);
            }
        } else {
            // unidir
            const int uc = get_ref_ctx(a, l, by4, bx4, have_top, have_left);
            if (ec::bool_adapt(m, t.cdf(CDF_COMP_UNI_REF) + (0 * 3 + uc) * 2)) {
                b.f[B_REF0] = 4;
                b.f[B_REF1] = 6;
            } else {
                const int uc1 = get_uni_p1_ctx(a, l, by4, bx4, have_top,
                                               have_left);
                b.f[B_REF0] = 0;
                b.f[B_REF1] = 1 + ec::bool_adapt(
                                      m,
                                      t.cdf(CDF_COMP_UNI_REF) +
                                          (1 * 3 + uc1) * 2);
                if (b.f[B_REF1] == 2) {
                    const int uc2 = get_fwd_ref_2_ctx(a, l, by4, bx4,
                                                      have_top, have_left);
                    b.f[B_REF1] += ec::bool_adapt(
                        m, t.cdf(CDF_COMP_UNI_REF) + (2 * 3 + uc2) * 2);
                }
            }
        }

        const int ref[2] = {b.f[B_REF0] + 1, b.f[B_REF1] + 1};
        fr = refmvs_find(t, ref, bs, edge_flags, by, bx);
        b.f[B_INTER_MODE] = ec::symbol_adapt(
            m, t.cdf(CDF_COMP_INTER_MODE) + 8 * fr.ctx,
            N_COMP_INTER_PRED_MODES - 1);

        const uint8_t *im = t.t_compintermodes + 2 * b.f[B_INTER_MODE];
        b.f[B_DRL_IDX] = NEAREST_DRL;
        if (b.f[B_INTER_MODE] == NEWMV_NEWMV) {
            if (fr.n_mvs > 1) {
                const int dctx1 = get_drl_context(fr, 0);
                b.f[B_DRL_IDX] += ec::bool_adapt(
                    m, t.cdf(CDF_DRL_BIT) + 2 * dctx1);
                if (b.f[B_DRL_IDX] == NEARER_DRL && fr.n_mvs > 2) {
                    const int dctx2 = get_drl_context(fr, 1);
                    b.f[B_DRL_IDX] += ec::bool_adapt(
                        m, t.cdf(CDF_DRL_BIT) + 2 * dctx2);
                }
            }
        } else if (im[0] == NEARMV || im[1] == NEARMV) {
            b.f[B_DRL_IDX] = NEARER_DRL;
            if (fr.n_mvs > 2) {
                const int dctx2 = get_drl_context(fr, 1);
                b.f[B_DRL_IDX] += ec::bool_adapt(
                    m, t.cdf(CDF_DRL_BIT) + 2 * dctx2);
                if (b.f[B_DRL_IDX] == NEAR_DRL && fr.n_mvs > 3) {
                    const int dctx3 = get_drl_context(fr, 2);
                    b.f[B_DRL_IDX] += ec::bool_adapt(
                        m, t.cdf(CDF_DRL_BIT) + 2 * dctx3);
                }
            }
        }

        has_subpel_filter = (bw4 < bh4 ? bw4 : bh4) == 1 ||
                            b.f[B_INTER_MODE] != GLOBALMV_GLOBALMV;
        for (int idx = 0; idx < 2; idx++) {
            const int mode = im[idx];
            const int drl = b.f[B_DRL_IDX];
            if (mode == NEARMV || mode == NEARESTMV) {
                bmv[idx] = fix_mv_precision(
                    t, idx ? fr.mv1[drl] : fr.mv0[drl]);
            } else if (mode == GLOBALMV) {
                const int32_t *gm = t.gmv(b.f[idx ? B_REF1 : B_REF0]);
                has_subpel_filter |= gm[0] == WM_TYPE_TRANSLATION;
                bmv[idx] = get_gmv_2d(t, gm, bx, by, bw4, bh4);
            } else {  // NEWMV
                bmv[idx] = read_mv_residual(
                    t, idx ? fr.mv1[drl] : fr.mv0[drl], /*dmv=*/false,
                    !c[CFG_FORCE_INTEGER_MV]);
            }
        }

        // jnt_comp vs. seg vs. wedge
        int is_segwedge = 0;
        if (c[CFG_MASKED_COMPOUND]) {
            const int mkctx = get_mask_comp_ctx(a, l, by4, bx4);
            is_segwedge = ec::bool_adapt(m, t.cdf(CDF_MASK_COMP) + 2 * mkctx);
        }
        if (!is_segwedge) {
            if (c[CFG_JNT_COMP]) {
                const int jctx = get_jnt_comp_ctx(
                    c[CFG_ORDER_HINT_N_BITS], c[CFG_FRAME_OFFSET],
                    c[CFG_REF_POC + b.f[B_REF0]],
                    c[CFG_REF_POC + b.f[B_REF1]], a, l, by4, bx4);
                b.f[B_COMP_TYPE] =
                    COMP_INTER_WEIGHTED_AVG +
                    ec::bool_adapt(m, t.cdf(CDF_JNT_COMP) + 2 * jctx);
            } else {
                b.f[B_COMP_TYPE] = COMP_INTER_AVG;
            }
        } else {
            if ((WEDGE_ALLOWED_MASK >> bs) & 1) {
                const int wctx = t.t_wedgectx[bs];
                b.f[B_COMP_TYPE] =
                    COMP_INTER_WEDGE -
                    ec::bool_adapt(m, t.cdf(CDF_WEDGE_COMP) + 2 * wctx);
                if (b.f[B_COMP_TYPE] == COMP_INTER_WEDGE)
                    b.f[B_WEDGE_IDX] = ec::symbol_adapt(
                        m, t.cdf(CDF_WEDGE_IDX) + 16 * wctx, 15);
            } else {
                b.f[B_COMP_TYPE] = COMP_INTER_SEG;
            }
            b.f[B_MASK_SIGN] = ec::bool_equi(m);
        }
    } else {
        b.f[B_COMP_TYPE] = COMP_INTER_NONE;
        if (has_seg && seg_ref > 0) {
            b.f[B_REF0] = seg_ref - 1;
        } else if (has_seg && (seg_gmv || seg_skip)) {
            b.f[B_REF0] = 0;
        } else {
            const int c1 = get_ref_ctx(a, l, by4, bx4, have_top, have_left);
            if (ec::bool_adapt(m, t.cdf(CDF_REF) + (0 * 3 + c1) * 2)) {
                const int c2 = get_bwd_ref_ctx(a, l, by4, bx4, have_top,
                                               have_left);
                if (ec::bool_adapt(m, t.cdf(CDF_REF) + (1 * 3 + c2) * 2)) {
                    b.f[B_REF0] = 6;
                } else {
                    const int c3 = get_bwd_ref_1_ctx(a, l, by4, bx4,
                                                     have_top, have_left);
                    b.f[B_REF0] =
                        4 +
                        ec::bool_adapt(m, t.cdf(CDF_REF) + (5 * 3 + c3) * 2);
                }
            } else {
                const int c2 = get_fwd_ref_ctx(a, l, by4, bx4, have_top,
                                               have_left);
                if (ec::bool_adapt(m, t.cdf(CDF_REF) + (2 * 3 + c2) * 2)) {
                    const int c3 = get_fwd_ref_2_ctx(a, l, by4, bx4,
                                                     have_top, have_left);
                    b.f[B_REF0] =
                        2 +
                        ec::bool_adapt(m, t.cdf(CDF_REF) + (4 * 3 + c3) * 2);
                } else {
                    const int c3 = get_fwd_ref_1_ctx(a, l, by4, bx4,
                                                     have_top, have_left);
                    b.f[B_REF0] = ec::bool_adapt(
                        m, t.cdf(CDF_REF) + (3 * 3 + c3) * 2);
                }
            }
        }
        b.f[B_REF1] = -1;

        const int ref[2] = {b.f[B_REF0] + 1, -1};
        fr = refmvs_find(t, ref, bs, edge_flags, by, bx);

        const bool seg_force = has_seg && (seg_skip || seg_gmv);
        if (seg_force ||
            ec::bool_adapt(m, t.cdf(CDF_NEWMV_MODE) + 2 * (fr.ctx & 7))) {
            if (seg_force ||
                !ec::bool_adapt(m, t.cdf(CDF_GLOBALMV_MODE) +
                                       2 * ((fr.ctx >> 3) & 1))) {
                b.f[B_INTER_MODE] = GLOBALMV;
                bmv[0] = get_gmv_2d(t, t.gmv(b.f[B_REF0]), bx, by, bw4,
                                    bh4);
                b.f[B_DRL_IDX] = NEAREST_DRL;
                has_subpel_filter =
                    (bw4 < bh4 ? bw4 : bh4) == 1 ||
                    t.gmv(b.f[B_REF0])[0] == WM_TYPE_TRANSLATION;
            } else {
                has_subpel_filter = 1;
                if (ec::bool_adapt(m, t.cdf(CDF_REFMV_MODE) +
                                          2 * ((fr.ctx >> 4) & 15))) {
                    b.f[B_INTER_MODE] = NEARMV;
                    b.f[B_DRL_IDX] = NEARER_DRL;
                    if (fr.n_mvs > 2) {
                        const int dctx2 = get_drl_context(fr, 1);
                        b.f[B_DRL_IDX] += ec::bool_adapt(
                            m, t.cdf(CDF_DRL_BIT) + 2 * dctx2);
                        if (b.f[B_DRL_IDX] == NEAR_DRL && fr.n_mvs > 3) {
                            const int dctx3 = get_drl_context(fr, 2);
                            b.f[B_DRL_IDX] += ec::bool_adapt(
                                m, t.cdf(CDF_DRL_BIT) + 2 * dctx3);
                        }
                    }
                } else {
                    b.f[B_INTER_MODE] = NEARESTMV;
                    b.f[B_DRL_IDX] = NEAREST_DRL;
                }
                MV mv0 = fr.mv0[b.f[B_DRL_IDX]];
                if (b.f[B_DRL_IDX] < NEAR_DRL)
                    mv0 = fix_mv_precision(t, mv0);
                bmv[0] = mv0;
            }
        } else {
            has_subpel_filter = 1;
            b.f[B_INTER_MODE] = NEWMV;
            b.f[B_DRL_IDX] = NEAREST_DRL;
            if (fr.n_mvs > 1) {
                const int dctx1 = get_drl_context(fr, 0);
                b.f[B_DRL_IDX] += ec::bool_adapt(
                    m, t.cdf(CDF_DRL_BIT) + 2 * dctx1);
                if (b.f[B_DRL_IDX] == NEARER_DRL && fr.n_mvs > 2) {
                    const int dctx2 = get_drl_context(fr, 1);
                    b.f[B_DRL_IDX] += ec::bool_adapt(
                        m, t.cdf(CDF_DRL_BIT) + 2 * dctx2);
                }
            }
            MV mv0;
            if (fr.n_mvs > 1)
                mv0 = fr.mv0[b.f[B_DRL_IDX]];
            else
                mv0 = fix_mv_precision(t, fr.mv0[0]);
            bmv[0] = read_mv_residual(t, mv0, /*dmv=*/false,
                                      !c[CFG_FORCE_INTEGER_MV]);
        }

        // interintra
        const int ii_sz_grp = t.t_ymodesizectx[bs];
        if (c[CFG_INTER_INTRA] && ((INTERINTRA_ALLOWED_MASK >> bs) & 1) &&
            ec::bool_adapt(m, t.cdf(CDF_INTERINTRA) + 2 * ii_sz_grp)) {
            b.f[B_INTERINTRA_MODE] = ec::symbol_adapt(
                m, t.cdf(CDF_INTERINTRA_MODE) + 4 * ii_sz_grp, 3);
            const int wctx = t.t_wedgectx[bs];
            b.f[B_INTERINTRA_TYPE] =
                INTER_INTRA_BLEND +
                ec::bool_adapt(m, t.cdf(CDF_INTERINTRA_WEDGE) + 2 * wctx);
            if (b.f[B_INTERINTRA_TYPE] == INTER_INTRA_WEDGE)
                b.f[B_WEDGE_IDX] = ec::symbol_adapt(
                    m, t.cdf(CDF_WEDGE_IDX) + 16 * wctx, 15);
        } else {
            b.f[B_INTERINTRA_TYPE] = INTER_INTRA_NONE;
        }

        // motion variation (OBMC / warp)
        if (c[CFG_SWITCHABLE_MOTION_MODE] &&
            b.f[B_INTERINTRA_TYPE] == INTER_INTRA_NONE &&
            (bw4 < bh4 ? bw4 : bh4) >= 2 &&
            !(!c[CFG_FORCE_INTEGER_MV] && b.f[B_INTER_MODE] == GLOBALMV &&
              t.gmv(b.f[B_REF0])[0] > WM_TYPE_TRANSLATION) &&
            ((have_left && findoddzero(l.intra, by4 + 1, h4 >> 1)) ||
             (have_top && findoddzero(a.intra, bx4 + 1, w4 >> 1)))) {
            uint64_t masks[2];
            find_matching_ref(t, edge_flags, bw4, bh4, w4, h4, have_left,
                              have_top, b.f[B_REF0], bx, by, masks);
            const bool allow_warp = !c[CFG_REF_SCALED + b.f[B_REF0]] &&
                                    !c[CFG_FORCE_INTEGER_MV] &&
                                    c[CFG_WARP_MOTION] &&
                                    (masks[0] | masks[1]);
            if (allow_warp)
                b.f[B_MOTION_MODE] = ec::symbol_adapt(
                    m, t.cdf(CDF_MOTION_MODE) + 4 * bs, 2);
            else
                b.f[B_MOTION_MODE] =
                    ec::bool_adapt(m, t.cdf(CDF_OBMC) + 2 * bs);
            if (b.f[B_MOTION_MODE] == MM_WARP) {
                has_subpel_filter = 0;
                Warp wm;
                derive_warpmv(t, bw4, bh4, masks, bmv[0], bx, by, &wm);
                b.f[B_WARP_VALID] = wm.valid;
                for (int i = 0; i < 6; i++) b.f[B_WARP_MAT0 + i] = wm.mat[i];
                b.f[B_WARP_ALPHA] = wm.alpha;
                b.f[B_WARP_BETA] = wm.beta;
                b.f[B_WARP_GAMMA] = wm.gamma;
                b.f[B_WARP_DELTA] = wm.delta;
            }
        } else {
            b.f[B_MOTION_MODE] = MM_TRANSLATION;
        }
    }

    // subpel filter (dav1d decode.c:1877-1911)
    if (c[CFG_SUBPEL_FILTER_MODE] == FILTER_SWITCHABLE) {
        if (has_subpel_filter) {
            const int comp = b.f[B_COMP_TYPE] != COMP_INTER_NONE;
            const int fc1 = get_filter_ctx(a, l, comp, 0, b.f[B_REF0], by4,
                                           bx4);
            filter01[0] = ec::symbol_adapt(
                m, t.cdf(CDF_FILTER) + (0 * 8 + fc1) * 4,
                N_SWITCHABLE_FILTERS - 1);
            if (c[CFG_DUAL_FILTER]) {
                const int fc2 = get_filter_ctx(a, l, comp, 1, b.f[B_REF0],
                                               by4, bx4);
                filter01[1] = ec::symbol_adapt(
                    m, t.cdf(CDF_FILTER) + (1 * 8 + fc2) * 4,
                    N_SWITCHABLE_FILTERS - 1);
            } else {
                filter01[1] = filter01[0];
            }
        } else {
            filter01[0] = filter01[1] = FILTER_8TAP_REGULAR;
        }
    } else {
        filter01[0] = filter01[1] = c[CFG_SUBPEL_FILTER_MODE];
    }
    b.f[B_FILTER2D] = t.t_filter2d[filter01[1] * 4 + filter01[0]];

    b.f[B_MV0Y] = bmv[0].y;
    b.f[B_MV0X] = bmv[0].x;
    b.f[B_MV1Y] = bmv[1].y;
    b.f[B_MV1X] = bmv[1].x;

    read_vartx_tree(t, b, bs, bx4, by4, bx, by);

    b.f[B_COEF_LO] = (int32_t)t.n_coefs;
    read_coef_blocks(t, b, bs, bx, by, w4, h4, has_chroma);
    b.f[B_COEF_HI] = (int32_t)t.n_coefs;
    if (t.err) return;

    const bool is_globalmv =
        b.f[B_INTER_MODE] == (is_comp ? GLOBALMV_GLOBALMV : GLOBALMV);
    calc_lflvl(t, seg_id, b.f[B_REF0] + 1, is_globalmv ? 0 : 1,
               &b.f[B_LF0]);

    // refmvs splat (dav1d decode.c splat_oneref_mv:548/splat_tworef:579)
    if (is_comp) {
        const int mf = (b.f[B_INTER_MODE] == GLOBALMV_GLOBALMV ? 1 : 0) |
                       (((1 << b.f[B_INTER_MODE]) & 0xBC) ? 2 : 0);
        splat_mv(t, by, bx, bw4, bh4, b.f[B_REF0] + 1, b.f[B_REF1] + 1,
                 bmv[0], bmv[1], bs, mf);
    } else {
        const int mf = ((b.f[B_INTER_MODE] == GLOBALMV &&
                         (bw4 < bh4 ? bw4 : bh4) >= 2)
                            ? 1
                            : 0) |
                       (b.f[B_INTER_MODE] == NEWMV ? 2 : 0);
        splat_mv(t, by, bx, bw4, bh4, b.f[B_REF0] + 1,
                 b.f[B_INTERINTRA_TYPE] ? 0 : -1, bmv[0], {0, 0}, bs, mf);
    }

    // context updates (dav1d decode.c:1949-1973)
    ctx_fill(l.seg_pred, by4, bh4, seg_pred);
    ctx_fill(a.seg_pred, bx4, bw4, seg_pred);
    ctx_fill(l.skip_mode, by4, bh4, b.f[B_SKIP_MODE]);
    ctx_fill(a.skip_mode, bx4, bw4, b.f[B_SKIP_MODE]);
    ctx_fill(l.intra, by4, bh4, 0);
    ctx_fill(a.intra, bx4, bw4, 0);
    ctx_fill(l.skip, by4, bh4, b.f[B_SKIP]);
    ctx_fill(a.skip, bx4, bw4, b.f[B_SKIP]);
    ctx_fill(l.pal_sz, by4, bh4, 0);
    ctx_fill(a.pal_sz, bx4, bw4, 0);
    memset(&t.pal_sz_uv_x[bx], 0, bw4 < t.bw - bx ? bw4 : t.bw - bx);
    memset(&t.pal_sz_uv_y[by], 0, bh4 < t.bh - by ? bh4 : t.bh - by);
    ctx_fill((uint8_t *)l.tx_intra, by4, bh4, b_dim[3]);
    ctx_fill((uint8_t *)a.tx_intra, bx4, bw4, b_dim[2]);
    ctx_fill(l.comp_type, by4, bh4, b.f[B_COMP_TYPE]);
    ctx_fill(a.comp_type, bx4, bw4, b.f[B_COMP_TYPE]);
    ctx_fill(l.filter[0], by4, bh4, filter01[0]);
    ctx_fill(l.filter[1], by4, bh4, filter01[1]);
    ctx_fill(a.filter[0], bx4, bw4, filter01[0]);
    ctx_fill(a.filter[1], bx4, bw4, filter01[1]);
    ctx_fill(l.mode, by4, bh4, b.f[B_INTER_MODE]);
    ctx_fill(a.mode, bx4, bw4, b.f[B_INTER_MODE]);
    ctx_fill((uint8_t *)l.ref[0], by4, bh4, b.f[B_REF0]);
    ctx_fill((uint8_t *)a.ref[0], bx4, bw4, b.f[B_REF0]);
    ctx_fill((uint8_t *)l.ref[1], by4, bh4, b.f[B_REF1]);
    ctx_fill((uint8_t *)a.ref[1], bx4, bw4, b.f[B_REF1]);
    if (has_chroma) {
        ctx_fill(l.uvmode, cby4, cbh4, DC_PRED);
        ctx_fill(a.uvmode, cbx4, cbw4, DC_PRED);
    }
}

// ---------------------------------------------------------------
// decode_b (host/tilecoder.py decode_b; dav1d decode.c:717)
// ---------------------------------------------------------------
void decode_b(TileDec &t, int bl, int bs, int bp, int bx, int by,
              int edge_flags) {
    if (t.err) return;
    if (t.n_blocks >= t.blocks_cap) {
        t.err = -5;
        return;
    }
    ec::Msac *m = &t.m;
    const int32_t *c = t.cfg;
    Blk b;
    b.init();
    b.f[B_BL] = bl;
    b.f[B_BP] = bp;
    b.f[B_BS] = bs;
    b.f[B_BX] = bx;
    b.f[B_BY] = by;
    b.f[B_EDGE_FLAGS] = edge_flags;
    const uint8_t *b_dim = t.bdim(bs);
    const int bw4 = b_dim[0], bh4 = b_dim[1];
    const int bx4 = bx & 31, by4 = by & 31;
    const int ss_ver = t.ss_ver, ss_hor = t.ss_hor;
    const int cbx4 = bx4 >> ss_hor, cby4 = by4 >> ss_ver;
    int w4 = bw4 < t.bw - bx ? bw4 : t.bw - bx;
    int h4 = bh4 < t.bh - by ? bh4 : t.bh - by;
    const int cbw4 = (bw4 + ss_hor) >> ss_hor;
    const int cbh4 = (bh4 + ss_ver) >> ss_ver;
    const int have_left = bx > t.col_start;
    const int have_top = by > t.row_start;
    const bool has_chroma = !t.monochrome &&
                            (bw4 > ss_hor || (bx & 1)) &&
                            (bh4 > ss_ver || (by & 1));
    BlockContext &a = t.a_at(bx);
    BlockContext &l = t.l;
    const bool inter_frame = !t.keyframe;

    // segment_id (dav1d decode.c:851-906)
    bool seg_set = false;
    int seg_pred = 0;
    if (t.seg_enabled) {
        if (!c[CFG_SEG_UPDATE_MAP]) {
            b.f[B_SEG_ID] = prev_seg_id(t, bx, by, w4, h4);
            seg_set = true;
        } else if (c[CFG_SEG_PRESKIP]) {
            if (c[CFG_SEG_TEMPORAL]) {
                const int spctx = a.seg_pred[bx4] + l.seg_pred[by4];
                seg_pred = ec::bool_adapt(m, t.cdf(CDF_SEG_PRED) + 2 * spctx);
            }
            if (seg_pred)
                b.f[B_SEG_ID] = prev_seg_id(t, bx, by, w4, h4);
            else
                b.f[B_SEG_ID] = read_seg_id(t, bx, by, w4, h4, have_top,
                                            have_left);
            seg_set = true;
        }
    } else {
        b.f[B_SEG_ID] = 0;
    }
    const int sid0 = b.f[B_SEG_ID];
    const bool seg_skip0 = seg_set && t.seg_field(sid0, 6);
    const bool seg_gmv0 = seg_set && t.seg_field(sid0, 7);
    const int seg_ref0 = seg_set ? t.seg_field(sid0, 5) : -1;

    // skip_mode (dav1d decode.c:908-919)
    if ((!seg_set || (!seg_gmv0 && seg_ref0 == -1 && !seg_skip0)) &&
        c[CFG_SKIP_MODE_ENABLED] && (bw4 < bh4 ? bw4 : bh4) > 1) {
        const int smctx = a.skip_mode[bx4] + l.skip_mode[by4];
        b.f[B_SKIP_MODE] =
            ec::bool_adapt(m, t.cdf(CDF_SKIP_MODE) + 2 * smctx);
    } else {
        b.f[B_SKIP_MODE] = 0;
    }

    // skip
    if (b.f[B_SKIP_MODE] || seg_skip0) {
        b.f[B_SKIP] = 1;
    } else {
        const int sctx = a.skip[bx4] + l.skip[by4];
        b.f[B_SKIP] = ec::bool_adapt(m, t.cdf(CDF_SKIP) + 2 * sctx);
    }

    // segment_id post-skip
    if (t.seg_enabled && c[CFG_SEG_UPDATE_MAP] && !c[CFG_SEG_PRESKIP]) {
        if (!b.f[B_SKIP] && c[CFG_SEG_TEMPORAL]) {
            const int spctx = a.seg_pred[bx4] + l.seg_pred[by4];
            seg_pred = ec::bool_adapt(m, t.cdf(CDF_SEG_PRED) + 2 * spctx);
        }
        if (!b.f[B_SKIP] && seg_pred) {
            b.f[B_SEG_ID] = prev_seg_id(t, bx, by, w4, h4);
        } else {
            int seg_ctx, pred_seg_id;
            cur_seg_ctx(t, bx, by, have_top, have_left, &seg_ctx,
                        &pred_seg_id);
            if (b.f[B_SKIP])
                b.f[B_SEG_ID] = pred_seg_id;
            else
                b.f[B_SEG_ID] = read_seg_id(t, bx, by, w4, h4, have_top,
                                            have_left);
        }
        seg_set = true;
    } else if (!t.seg_enabled) {
        b.f[B_SEG_ID] = 0;
    }

    if (t.seg_map && c[CFG_SEG_UPDATE_MAP]) {
        for (int y = by; y < by + h4; y++)
            memset(t.seg_map + y * t.bw + bx, b.f[B_SEG_ID], w4);
    }

    // cdef index (always walked; reads 0 bits when cdef_n_bits == 0)
    if (!b.f[B_SKIP]) {
        const int idx =
            t.sb128 ? (((bx & 16) >> 4) + ((by & 16) >> 3)) : 0;
        if (t.cur_sb_cdef_idx[idx] == -1) {
            const int v = ec::bools(m, c[CFG_CDEF_N_BITS]);
            t.cur_sb_cdef_idx[idx] = v;
            if (bw4 > 16) t.cur_sb_cdef_idx[idx + 1] = v;
            if (bh4 > 16) t.cur_sb_cdef_idx[idx + 2] = v;
            if (bw4 == 32 && bh4 == 32) t.cur_sb_cdef_idx[idx + 3] = v;
        }
    }

    // delta q/lf
    {
        const int mask = 31 >> (t.sb128 ? 0 : 1);
        if (!(bx & mask) && !(by & mask))
            read_delta_q_lf(t, b.f[B_SKIP], bs);
    }
    b.f[B_QIDX] = t.last_qidx;

    const int seg_id = b.f[B_SEG_ID];
    const bool seg_skip = seg_set && t.seg_field(seg_id, 6);
    const bool seg_gmv = seg_set && t.seg_field(seg_id, 7);
    const int seg_ref = seg_set ? t.seg_field(seg_id, 5) : -1;

    // intra/inter determination (dav1d decode.c:1067-1086)
    if (b.f[B_SKIP_MODE]) {
        b.f[B_INTRA] = 0;
    } else if (inter_frame) {
        if (seg_set && (seg_ref >= 0 || seg_gmv)) {
            b.f[B_INTRA] = !seg_ref;
        } else {
            const int ictx = get_intra_ctx(a, l, by4, bx4, have_top,
                                           have_left);
            b.f[B_INTRA] =
                1 - ec::bool_adapt(m, t.cdf(CDF_INTRA) + 2 * ictx);
        }
    } else if (c[CFG_ALLOW_INTRABC]) {
        b.f[B_INTRA] = 1 - ec::bool_adapt(m, t.cdf(CDF_INTRABC));
    } else {
        b.f[B_INTRA] = 1;
    }

    if (!b.f[B_INTRA]) {
        if (t.keyframe) {
            if (!intrabc_block(t, b, bs, bx, by, w4, h4, edge_flags,
                               seg_pred, has_chroma)) {
                t.err = -10;  // invalid intrabc mv
                return;
            }
        } else {
            inter_block(t, b, bl, bs, bx, by, w4, h4, edge_flags, seg_set,
                        seg_pred, have_top, have_left);
        }
        if (t.err) return;
        memcpy(t.blk + t.n_blocks * B_NFIELDS, b.f, sizeof(b.f));
        t.n_blocks++;
        return;
    }

    calc_lflvl(t, seg_id, 0, 0, &b.f[B_LF0]);

    // y mode
    uint16_t *ymode_cdf;
    if (inter_frame) {
        ymode_cdf = t.cdf(CDF_Y_MODE) + 16 * t.t_ymodesizectx[bs];
    } else {
        ymode_cdf = t.cdf(CDF_KFYM) +
                    (t.t_intramodectx[a.mode[bx4]] * 5 +
                     t.t_intramodectx[l.mode[by4]]) *
                        16;
    }
    b.f[B_Y_MODE] = ec::symbol_adapt(m, ymode_cdf, N_INTRA_PRED_MODES - 1);

    // y angle
    if (b_dim[2] + b_dim[3] >= 2 && b.f[B_Y_MODE] >= VERT_PRED &&
        b.f[B_Y_MODE] <= VERT_LEFT_PRED) {
        uint16_t *acdf =
            t.cdf(CDF_ANGLE_DELTA) + 8 * (b.f[B_Y_MODE] - VERT_PRED);
        b.f[B_Y_ANGLE] = ec::symbol_adapt(m, acdf, 6) - 3;
    } else {
        b.f[B_Y_ANGLE] = 0;
    }

    const bool lossless = c[CFG_SEG_LOSSLESS + seg_id];
    if (has_chroma) {
        const bool cfl_allowed =
            lossless ? (cbw4 == 1 && cbh4 == 1)
                     : ((bs >= 7) &&  // blocks with w,h <= 32
                        (t.bdim(bs)[0] <= 8 && t.bdim(bs)[1] <= 8));
        uint16_t *uvmode_cdf =
            t.cdf(CDF_UV_MODE) +
            ((cfl_allowed ? 1 : 0) * 13 + b.f[B_Y_MODE]) * 16;
        b.f[B_UV_MODE] =
            ec::symbol_adapt(m, uvmode_cdf, cfl_allowed ? 13 : 12);
        b.f[B_UV_ANGLE] = 0;
        if (b.f[B_UV_MODE] == CFL_PRED) {
            const int sign = ec::symbol_adapt(m, t.cdf(CDF_CFL_SIGN), 7) + 1;
            const int sign_u = sign * 0x56 >> 8;
            const int sign_v = sign - sign_u * 3;
            if (sign_u) {
                const int ctx = (sign_u == 2) * 3 + sign_v;
                const int alpha =
                    ec::symbol_adapt(m, t.cdf(CDF_CFL_ALPHA) + 16 * ctx,
                                     15) +
                    1;
                b.f[B_CFL_A0] = sign_u == 1 ? -alpha : alpha;
            } else {
                b.f[B_CFL_A0] = 0;
            }
            if (sign_v) {
                const int ctx = (sign_v == 2) * 3 + sign_u;
                const int alpha =
                    ec::symbol_adapt(m, t.cdf(CDF_CFL_ALPHA) + 16 * ctx,
                                     15) +
                    1;
                b.f[B_CFL_A1] = sign_v == 1 ? -alpha : alpha;
            } else {
                b.f[B_CFL_A1] = 0;
            }
        } else if (b_dim[2] + b_dim[3] >= 2 &&
                   b.f[B_UV_MODE] >= VERT_PRED &&
                   b.f[B_UV_MODE] <= VERT_LEFT_PRED) {
            uint16_t *acdf =
                t.cdf(CDF_ANGLE_DELTA) + 8 * (b.f[B_UV_MODE] - VERT_PRED);
            b.f[B_UV_ANGLE] = ec::symbol_adapt(m, acdf, 6) - 3;
        }
    } else {
        b.f[B_UV_MODE] = DC_PRED;
        b.f[B_UV_ANGLE] = 0;
    }

    // palette (dav1d decode.c:1155-1179)
    b.f[B_PAL_SZ0] = b.f[B_PAL_SZ1] = 0;
    uint16_t pal[3][8];
    memset(pal, 0, sizeof(pal));
    if (c[CFG_ALLOW_SCREEN_CONTENT] && (bw4 > bh4 ? bw4 : bh4) <= 16 &&
        bw4 + bh4 >= 4) {
        const int sz_ctx = b_dim[2] + b_dim[3] - 2;
        if (b.f[B_Y_MODE] == DC_PRED) {
            const int pal_ctx = (a.pal_sz[bx4] > 0) + (l.pal_sz[by4] > 0);
            if (ec::bool_adapt(
                    m, t.cdf(CDF_PAL_Y) + (sz_ctx * 3 + pal_ctx) * 2))
                read_pal_plane(t, b, 0, sz_ctx, bx, by, pal[0]);
        }
        if (has_chroma && b.f[B_UV_MODE] == DC_PRED) {
            const int pal_ctx = b.f[B_PAL_SZ0] > 0;
            if (ec::bool_adapt(m, t.cdf(CDF_PAL_UV) + 2 * pal_ctx)) {
                read_pal_plane(t, b, 1, sz_ctx, bx, by, pal[1]);
                read_pal_v(t, b, pal[2]);
            }
        }
    }

    // filter intra
    if (b.f[B_Y_MODE] == DC_PRED && !b.f[B_PAL_SZ0] &&
        (b_dim[2] > b_dim[3] ? b_dim[2] : b_dim[3]) <= 3 &&
        c[CFG_FILTER_INTRA]) {
        const int is_filter =
            ec::bool_adapt(m, t.cdf(CDF_USE_FILTER_INTRA) + 2 * bs);
        if (is_filter) {
            b.f[B_Y_MODE] = FILTER_PRED;
            b.f[B_Y_ANGLE] =
                ec::symbol_adapt(m, t.cdf(CDF_FILTER_INTRA), 4);
        }
    }

    // palette index maps (dav1d decode.c:1196-1222)
    if (b.f[B_PAL_SZ0] || b.f[B_PAL_SZ1]) {
        if (t.pal_used >= t.pal_cap) {
            t.err = -6;
            return;
        }
        b.f[B_PAL_OFF] = (int32_t)t.pal_used;
        memcpy(t.pal + t.pal_used * 24, pal, sizeof(pal));
        t.pal_used++;
    }
    if (b.f[B_PAL_SZ0]) {
        b.f[B_PALIDX_Y_OFF] =
            (int32_t)read_pal_indices(t, b, 0, w4, h4, bw4, bh4);
        if (t.err) return;
    }
    if (has_chroma && b.f[B_PAL_SZ1]) {
        const int cw4_ = (w4 + ss_hor) >> ss_hor;
        const int ch4_ = (h4 + ss_ver) >> ss_ver;
        b.f[B_PALIDX_UV_OFF] =
            (int32_t)read_pal_indices(t, b, 1, cw4_, ch4_, cbw4, cbh4);
        if (t.err) return;
    }

    // tx size
    const uint8_t *t_dim;
    if (lossless) {
        b.f[B_TX] = b.f[B_UVTX] = TX_4X4;
        t_dim = t.txdim(TX_4X4);
    } else {
        b.f[B_TX] = t.t_maxtx[4 * bs + 0];
        b.f[B_UVTX] = t.t_maxtx[4 * bs + t.layout];
        t_dim = t.txdim(b.f[B_TX]);
        if (c[CFG_TXFM_MODE] == TX_SWITCHABLE && t_dim[5] > TX_4X4) {
            const int tctx = (l.tx_intra[by4] >= (int8_t)t_dim[3]) +
                             (a.tx_intra[bx4] >= (int8_t)t_dim[2]);
            uint16_t *tx_cdf =
                t.cdf(CDF_TXSZ) + ((t_dim[5] - 1) * 3 + tctx) * 4;
            const int depth = ec::symbol_adapt(
                m, tx_cdf, t_dim[5] < 2 ? t_dim[5] : 2);
            for (int i = 0; i < depth; i++) {
                b.f[B_TX] = t_dim[6];
                t_dim = t.txdim(b.f[B_TX]);
            }
        }
    }

    // coefficient blocks
    b.f[B_COEF_LO] = (int32_t)t.n_coefs;
    read_coef_blocks(t, b, bs, bx, by, w4, h4, has_chroma);
    b.f[B_COEF_HI] = (int32_t)t.n_coefs;
    if (t.err) return;

    // context updates
    const int y_mode_nofilt =
        b.f[B_Y_MODE] == FILTER_PRED ? DC_PRED : b.f[B_Y_MODE];
    const int lw = t_dim[2], lh = t_dim[3];
    ctx_fill((uint8_t *)l.tx_intra, by4, bh4, lh);
    ctx_fill((uint8_t *)l.tx, by4, bh4, lh);
    ctx_fill((uint8_t *)a.tx_intra, bx4, bw4, lw);
    ctx_fill((uint8_t *)a.tx, bx4, bw4, lw);
    ctx_fill(l.mode, by4, bh4, y_mode_nofilt);
    ctx_fill(a.mode, bx4, bw4, y_mode_nofilt);
    ctx_fill(l.pal_sz, by4, bh4, b.f[B_PAL_SZ0]);
    ctx_fill(a.pal_sz, bx4, bw4, b.f[B_PAL_SZ0]);
    const int xw = bw4 < t.bw - bx ? bw4 : t.bw - bx;
    const int yh = bh4 < t.bh - by ? bh4 : t.bh - by;
    memset(&t.pal_sz_uv_x[bx], has_chroma ? b.f[B_PAL_SZ1] : 0, xw);
    memset(&t.pal_sz_uv_y[by], has_chroma ? b.f[B_PAL_SZ1] : 0, yh);
    if (b.f[B_PAL_SZ0]) {
        // dav1d recon copy_pal_block_y (al_pal splat over block extent)
        for (int x = bx; x < bx + xw; x++)
            memcpy(&t.al_pal_x[(x * 3 + 0) * 8], pal[0], 16);
        for (int y = by; y < by + yh; y++)
            memcpy(&t.al_pal_y[(y * 3 + 0) * 8], pal[0], 16);
    }
    if (has_chroma && b.f[B_PAL_SZ1]) {
        for (int pl = 1; pl <= 2; pl++) {
            for (int x = bx; x < bx + xw; x++)
                memcpy(&t.al_pal_x[(x * 3 + pl) * 8], pal[pl], 16);
            for (int y = by; y < by + yh; y++)
                memcpy(&t.al_pal_y[(y * 3 + pl) * 8], pal[pl], 16);
        }
    }
    ctx_fill(l.seg_pred, by4, bh4, seg_pred);
    ctx_fill(a.seg_pred, bx4, bw4, seg_pred);
    ctx_fill(l.skip_mode, by4, bh4, 0);
    ctx_fill(a.skip_mode, bx4, bw4, 0);
    ctx_fill(l.intra, by4, bh4, 1);
    ctx_fill(a.intra, bx4, bw4, 1);
    ctx_fill(l.skip, by4, bh4, b.f[B_SKIP]);
    ctx_fill(a.skip, bx4, bw4, b.f[B_SKIP]);
    if (inter_frame) {
        ctx_fill(l.comp_type, by4, bh4, COMP_INTER_NONE);
        ctx_fill(a.comp_type, bx4, bw4, COMP_INTER_NONE);
        ctx_fill((uint8_t *)l.ref[0], by4, bh4, (uint8_t)-1);
        ctx_fill((uint8_t *)l.ref[1], by4, bh4, (uint8_t)-1);
        ctx_fill((uint8_t *)a.ref[0], bx4, bw4, (uint8_t)-1);
        ctx_fill((uint8_t *)a.ref[1], bx4, bw4, (uint8_t)-1);
        ctx_fill(l.filter[0], by4, bh4, N_SWITCHABLE_FILTERS);
        ctx_fill(l.filter[1], by4, bh4, N_SWITCHABLE_FILTERS);
        ctx_fill(a.filter[0], bx4, bw4, N_SWITCHABLE_FILTERS);
        ctx_fill(a.filter[1], bx4, bw4, N_SWITCHABLE_FILTERS);
    }
    if (has_chroma) {
        ctx_fill(l.uvmode, cby4, cbh4, b.f[B_UV_MODE]);
        ctx_fill(a.uvmode, cbx4, cbw4, b.f[B_UV_MODE]);
    }
    if (inter_frame || c[CFG_ALLOW_INTRABC]) {
        // dav1d decode.c splat_intraref:596
        splat_intraref(t, by, bx, bw4, bh4, bs);
    }

    memcpy(t.blk + t.n_blocks * B_NFIELDS, b.f, sizeof(b.f));
    t.n_blocks++;
}

// ---------------------------------------------------------------
// decode_sb (host/tilecoder.py decode_sb; dav1d decode.c:2161)
// ---------------------------------------------------------------
int gather_top_prob(const uint16_t *pc, int bl) {
    int out = (int)pc[PARTITION_V - 1] - (int)pc[PARTITION_T_TOP_SPLIT];
    out += (int)pc[PARTITION_T_LEFT_SPLIT - 1];
    if (bl != BL_128X128)
        out += (int)pc[PARTITION_V4 - 1] - (int)pc[PARTITION_T_RIGHT_SPLIT];
    return out;
}

int gather_left_prob(const uint16_t *pc, int bl) {
    int out = (int)pc[PARTITION_H - 1] - (int)pc[PARTITION_H];
    out += (int)pc[PARTITION_SPLIT - 1] - (int)pc[PARTITION_T_LEFT_SPLIT];
    if (bl != BL_128X128)
        out += (int)pc[PARTITION_H4 - 1] - (int)pc[PARTITION_H4];
    return out;
}

void decode_sb(TileDec &t, int bl, int bx, int by, const EdgeNode *node) {
    if (t.err) return;
    const int hsz = 16 >> bl;
    const bool have_h_split = t.bw > bx + hsz;
    const bool have_v_split = t.bh > by + hsz;

    if (!have_h_split && !have_v_split) {
        // bl < BL_8X8 guaranteed
        return decode_sb(t, bl + 1, bx, by, node->split[0]);
    }

    const int bx8 = (bx & 31) >> 1;
    const int by8 = (by & 31) >> 1;
    BlockContext &a = t.a_at(bx);
    BlockContext &l = t.l;
    const int ctx = ((a.partition[bx8] >> (4 - bl)) & 1) +
                    (((l.partition[by8] >> (4 - bl)) & 1) << 1);
    uint16_t *pc = t.cdf(CDF_PARTITION) + (bl * 4 + ctx) * 16;
    const bool i422 = t.layout == LAYOUT_I422;

    int bp;
    if (have_h_split && have_v_split) {
        bp = ec::symbol_adapt(&t.m, pc, t.t_partcount[bl]);
        if (i422 && (bp == PARTITION_V || bp == PARTITION_V4 ||
                     bp == PARTITION_T_LEFT_SPLIT ||
                     bp == PARTITION_T_RIGHT_SPLIT)) {
            t.err = -11;  // illegal partition for 4:2:2
            return;
        }
        const uint8_t *bsz = t.t_blocksizes + (bl * 10 + bp) * 2;
        switch (bp) {
        case PARTITION_NONE:
            decode_b(t, bl, bsz[0], bp, bx, by, node->o);
            break;
        case PARTITION_H:
            decode_b(t, bl, bsz[0], bp, bx, by, node->h[0]);
            decode_b(t, bl, bsz[0], bp, bx, by + hsz, node->h[1]);
            break;
        case PARTITION_V:
            decode_b(t, bl, bsz[0], bp, bx, by, node->v[0]);
            decode_b(t, bl, bsz[0], bp, bx + hsz, by, node->v[1]);
            break;
        case PARTITION_SPLIT:
            if (bl == BL_8X8) {
                decode_b(t, bl, BS_4x4, bp, bx, by, EDGE_ALL_TR_AND_BL);
                decode_b(t, bl, BS_4x4, bp, bx + 1, by, node->tip_split[0]);
                decode_b(t, bl, BS_4x4, bp, bx, by + 1, node->tip_split[1]);
                decode_b(t, bl, BS_4x4, bp, bx + 1, by + 1,
                         node->tip_split[2]);
            } else {
                decode_sb(t, bl + 1, bx, by, node->split[0]);
                decode_sb(t, bl + 1, bx + hsz, by, node->split[1]);
                decode_sb(t, bl + 1, bx, by + hsz, node->split[2]);
                decode_sb(t, bl + 1, bx + hsz, by + hsz, node->split[3]);
            }
            break;
        case PARTITION_T_TOP_SPLIT:
            decode_b(t, bl, bsz[0], bp, bx, by, EDGE_ALL_TR_AND_BL);
            decode_b(t, bl, bsz[0], bp, bx + hsz, by, node->v[1]);
            decode_b(t, bl, bsz[1], bp, bx, by + hsz, node->h[1]);
            break;
        case PARTITION_T_BOTTOM_SPLIT:
            decode_b(t, bl, bsz[0], bp, bx, by, node->h[0]);
            decode_b(t, bl, bsz[1], bp, bx, by + hsz, node->v[0]);
            decode_b(t, bl, bsz[1], bp, bx + hsz, by + hsz, 0);
            break;
        case PARTITION_T_LEFT_SPLIT:
            decode_b(t, bl, bsz[0], bp, bx, by, EDGE_ALL_TR_AND_BL);
            decode_b(t, bl, bsz[0], bp, bx, by + hsz, node->h[1]);
            decode_b(t, bl, bsz[1], bp, bx + hsz, by, node->v[1]);
            break;
        case PARTITION_T_RIGHT_SPLIT:
            decode_b(t, bl, bsz[0], bp, bx, by, node->v[0]);
            decode_b(t, bl, bsz[1], bp, bx + hsz, by, node->h[0]);
            decode_b(t, bl, bsz[1], bp, bx + hsz, by + hsz, 0);
            break;
        case PARTITION_H4: {
            const int q = hsz >> 1;
            decode_b(t, bl, bsz[0], bp, bx, by, node->h[0]);
            decode_b(t, bl, bsz[0], bp, bx, by + q, node->h4);
            decode_b(t, bl, bsz[0], bp, bx, by + 2 * q,
                     EDGE_ALL_LEFT_HAS_BOTTOM);
            if (by + 3 * q < t.bh)
                decode_b(t, bl, bsz[0], bp, bx, by + 3 * q, node->h[1]);
            break;
        }
        case PARTITION_V4: {
            const int q = hsz >> 1;
            decode_b(t, bl, bsz[0], bp, bx, by, node->v[0]);
            decode_b(t, bl, bsz[0], bp, bx + q, by, node->v4);
            decode_b(t, bl, bsz[0], bp, bx + 2 * q, by,
                     EDGE_ALL_TOP_HAS_RIGHT);
            if (bx + 3 * q < t.bw)
                decode_b(t, bl, bsz[0], bp, bx + 3 * q, by, node->v[1]);
            break;
        }
        default:
            t.err = -12;
            return;
        }
    } else if (have_h_split) {
        const int is_split =
            ec::bool_prob(&t.m, gather_top_prob(pc, bl));
        if (is_split) {
            bp = PARTITION_SPLIT;
            decode_sb(t, bl + 1, bx, by, node->split[0]);
            decode_sb(t, bl + 1, bx + hsz, by, node->split[1]);
        } else {
            bp = PARTITION_H;
            decode_b(t, bl,
                     t.t_blocksizes[(bl * 10 + PARTITION_H) * 2],
                     PARTITION_H, bx, by, node->h[0]);
        }
    } else {
        const int is_split =
            ec::bool_prob(&t.m, gather_left_prob(pc, bl));
        if (i422 && !is_split) {
            t.err = -11;
            return;
        }
        if (is_split) {
            bp = PARTITION_SPLIT;
            decode_sb(t, bl + 1, bx, by, node->split[0]);
            decode_sb(t, bl + 1, bx, by + hsz, node->split[2]);
        } else {
            bp = PARTITION_V;
            decode_b(t, bl,
                     t.t_blocksizes[(bl * 10 + PARTITION_V) * 2],
                     PARTITION_V, bx, by, node->v[0]);
        }
    }
    if (t.err) return;

    if (bp != PARTITION_SPLIT || bl == BL_8X8) {
        ctx_fill(a.partition, bx8, hsz,
                 t.t_alpartctx[(0 * 5 + bl) * 10 + bp]);
        ctx_fill(l.partition, by8, hsz,
                 t.t_alpartctx[(1 * 5 + bl) * 10 + bp]);
    }
}

}  // namespace

// ---------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------
API int tile_decode(const int32_t *cfg, const uint64_t *tab,
                    const uint64_t *cdfp, const uint64_t *rfp,
                    const uint64_t *misc, const uint64_t *outp,
                    const uint8_t *data, size_t size, int64_t *counts) {
    TileDec t;
    memset(&t, 0, sizeof(TileDec));
    t.cfg = cfg;
    t.tab = tab;
    t.cdfp = cdfp;
    t.rfp = rfp;
    t.misc = misc;
    t.outp = outp;

    t.sb128 = cfg[CFG_SB128];
    t.layout = cfg[CFG_LAYOUT];
    t.bitdepth = cfg[CFG_BITDEPTH];
    t.hbd = cfg[CFG_HBD];
    t.monochrome = cfg[CFG_MONOCHROME];
    t.ss_ver = cfg[CFG_SS_VER];
    t.ss_hor = cfg[CFG_SS_HOR];
    t.keyframe = cfg[CFG_KEYFRAME];
    t.bw = cfg[CFG_FRAME_W4];
    t.bh = cfg[CFG_FRAME_H4];
    t.col_start = cfg[CFG_COL_START];
    t.col_end = cfg[CFG_COL_END];
    t.row_start = cfg[CFG_ROW_START];
    t.row_end = cfg[CFG_ROW_END];
    t.sb_step = cfg[CFG_SB_STEP];
    t.seg_enabled = cfg[CFG_SEG_ENABLED];

    t.t_blockdim = (const uint8_t *)tab[TAB_BLOCK_DIM];
    t.t_blocksizes = (const uint8_t *)tab[TAB_BLOCK_SIZES];
    t.t_alpartctx = (const uint8_t *)tab[TAB_AL_PART_CTX];
    t.t_partcount = (const uint8_t *)tab[TAB_PART_COUNT];
    t.t_maxtx = (const uint8_t *)tab[TAB_MAX_TX];
    t.t_txfm = (const uint8_t *)tab[TAB_TXFM];
    t.t_intramodectx = (const uint8_t *)tab[TAB_INTRA_MODE_CTX];
    t.t_ymodesizectx = (const uint8_t *)tab[TAB_YMODE_SIZE_CTX];
    t.t_txtpfromuv = (const uint8_t *)tab[TAB_TXTP_FROM_UVMODE];
    t.t_txtypesperset = (const uint8_t *)tab[TAB_TX_TYPES_PER_SET];
    t.t_txtypeclass = (const uint8_t *)tab[TAB_TX_TYPE_CLASS];
    t.t_loctxoff = (const uint8_t *)tab[TAB_LO_CTX_OFFSETS];
    t.t_skipctx = (const uint8_t *)tab[TAB_SKIP_CTX];
    t.t_dq = (const uint16_t *)tab[TAB_DQ];
    t.t_compintermodes = (const uint8_t *)tab[TAB_COMP_INTER_MODES];
    t.t_filter2d = (const uint8_t *)tab[TAB_FILTER_2D];
    t.t_wedgectx = (const uint8_t *)tab[TAB_WEDGE_CTX];
    t.t_filt2ymode = (const uint8_t *)tab[TAB_FILTER_MODE_TO_Y_MODE];
    t.t_sgrparams = (const uint16_t *)tab[TAB_SGR_PARAMS];
    for (int i = 0; i < 19; i++)
        t.t_scan[i] = (const uint16_t *)tab[TAB_SCAN0 + i];
    for (int tx = 0; tx < 19; tx++)
        for (int pl = 0; pl < 3; pl++)
            t.t_qm[tx][pl] = (const uint8_t *)tab[TAB_QM + tx * 3 + pl];

    // refmvs
    t.rf_present = cfg[CFG_RF_PRESENT];
    if (t.rf_present) {
        t.rf_iw4 = cfg[CFG_RF_IW4];
        t.rf_ih4 = cfg[CFG_RF_IH4];
        t.rf_iw8 = cfg[CFG_RF_IW8];
        t.rf_stride4 = cfg[CFG_RF_STRIDE4];
        t.rf_use_tmvs = cfg[CFG_RF_USE_REF_FRAME_MVS];
        t.rp_stride8 = cfg[CFG_RP_PROJ_STRIDE8];
        for (int i = 0; i < 7; i++) {
            t.sign_bias[i] = cfg[CFG_RF_SIGN_BIAS + i];
            t.pocdiff[i] = cfg[CFG_RF_POCDIFF + i];
        }
        t.rf_ref = (int8_t *)rfp[RFP_REF];
        t.rf_mv = (int16_t *)rfp[RFP_MV];
        t.rf_bs = (uint8_t *)rfp[RFP_BS];
        t.rf_mf = (uint8_t *)rfp[RFP_MF];
        t.rp_proj_mv = (const int16_t *)rfp[RFP_RP_PROJ_MV];
        t.rp_proj_ref = (const uint8_t *)rfp[RFP_RP_PROJ_REF];
    }

    t.prev_segmap = (const uint8_t *)misc[MISC_PREV_SEGMAP];
    t.seg_map = (uint8_t *)misc[MISC_SEG_MAP];

    // outputs
    t.blk = (int32_t *)outp[OUT_BLK];
    t.coef = (int32_t *)outp[OUT_COEF];
    t.cf = (int32_t *)outp[OUT_CF];
    t.pal = (uint16_t *)outp[OUT_PAL];
    t.palidx = (uint8_t *)outp[OUT_PALIDX];
    t.lr_rec = (int32_t *)outp[OUT_LR];
    t.cdef_rec = (int32_t *)outp[OUT_CDEF];
    t.blocks_cap = cfg[CFG_BLOCKS_CAP];
    t.coefs_cap = cfg[CFG_COEFS_CAP];
    t.cf_cap = cfg[CFG_CF_CAP];
    t.pal_cap = cfg[CFG_PAL_CAP];
    t.palidx_cap = cfg[CFG_PALIDX_CAP];
    t.lr_cap = cfg[CFG_LR_CAP];
    t.cdef_cap = cfg[CFG_CDEF_CAP];

    // contexts
    const int n_a = ((t.col_end - t.col_start + 31) >> 5) + 1;
    t.a_arr.resize(n_a);
    for (auto &a : t.a_arr) {
        memset(&a, 0, sizeof(a));
        memset(a.ref, -1, sizeof(a.ref));
        a.reset(t.keyframe);
    }
    memset(&t.l, 0, sizeof(t.l));
    memset(t.l.ref, -1, sizeof(t.l.ref));

    // quant
    init_quant_tables(t, cfg[CFG_QUANT_YAC], t.dq_frame);
    memcpy(t.dq_cur, t.dq_frame, sizeof(t.dq_cur));
    t.last_qidx = cfg[CFG_QUANT_YAC];
    t.last_delta_lf[0] = t.last_delta_lf[1] = t.last_delta_lf[2] =
        t.last_delta_lf[3] = 0;

    // palette caches
    t.al_pal_x.assign((size_t)t.bw * 3 * 8, 0);
    t.al_pal_y.assign((size_t)t.bh * 3 * 8, 0);
    t.pal_sz_uv_x.assign(t.bw, 0);
    t.pal_sz_uv_y.assign(t.bh, 0);

    // lr state
    t.restore_planes = 0;
    for (int p = 0; p < 3; p++)
        if (cfg[CFG_RESTORATION_TYPE + p] != 0) t.restore_planes |= 1 << p;
    for (int p = 0; p < 3; p++) {
        t.lr_ref[p].type = 0;
        t.lr_ref[p].fv[0] = 3;
        t.lr_ref[p].fv[1] = -7;
        t.lr_ref[p].fv[2] = 15;
        t.lr_ref[p].fh[0] = 3;
        t.lr_ref[p].fh[1] = -7;
        t.lr_ref[p].fh[2] = 15;
        t.lr_ref[p].sw[0] = -32;
        t.lr_ref[p].sw[1] = 31;
    }

    ec::init(&t.m, data, size, cfg[CFG_DISABLE_CDF_UPDATE]);

    const int root_bl = t.sb128 ? BL_128X128 : BL_64X64;
    const EdgeNode *root = edge_root(root_bl);

    for (int by = t.row_start; by < t.row_end && !t.err;
         by += t.sb_step) {
        t.l.reset(t.keyframe);
        for (int bx = t.col_start; bx < t.col_end && !t.err;
             bx += t.sb_step) {
            t.cur_sb_cdef_idx[0] = t.cur_sb_cdef_idx[1] = -1;
            t.cur_sb_cdef_idx[2] = t.cur_sb_cdef_idx[3] = -1;
            read_lr_for_sb(t, bx, by);
            decode_sb(t, root_bl, bx, by, root);
            if (t.n_cdef >= t.cdef_cap) {
                t.err = -7;
                break;
            }
            int32_t *cr = t.cdef_rec + t.n_cdef * CDEF_NFIELDS;
            cr[0] = bx;
            cr[1] = by;
            cr[2] = t.cur_sb_cdef_idx[0];
            cr[3] = t.cur_sb_cdef_idx[1];
            cr[4] = t.cur_sb_cdef_idx[2];
            cr[5] = t.cur_sb_cdef_idx[3];
            t.n_cdef++;
        }
    }

    counts[0] = t.n_blocks;
    counts[1] = t.n_coefs;
    counts[2] = t.cf_used;
    counts[3] = t.pal_used;
    counts[4] = t.palidx_used;
    counts[5] = t.n_lr;
    counts[6] = t.n_cdef;
    counts[7] = (int64_t)t.m.pos;
    return t.err;
}

API int tile_cfg_size(void) { return CFG_N; }
API int tile_tab_size(void) { return TAB_N; }
API int tile_cdf_size(void) { return CDF_COUNT; }
API int tile_blk_fields(void) { return B_NFIELDS; }
API int tile_coef_fields(void) { return C_NFIELDS; }
API int tile_lr_fields(void) { return LR_NFIELDS; }
API int tile_cdef_fields(void) { return CDEF_NFIELDS; }
