// Copied from dav1d_mirror_tpu/native/recon.cpp.
// Native decode-order intra reconstruction pass ("host pass 2").
//
// Mirrors models/ref_decoder._recon_tile for the host-sequential block
// classes (intra prediction needs reconstructed neighbours, so it cannot
// be batched like the device MC/residual passes): edge preparation
// (dav1d src/ipred_prepare_tmpl.c:72-196), all 14 predictors + CFL +
// palette (src/ipred_tmpl.c:93-720, caller src/recon_tmpl.c:1195-1596),
// and the residual add. The inverse transforms themselves are NOT here:
// the device pixel stage batch-computes every residual (models/
// tpu_inter "hres" ops) and hands them over as flat int32 buffers; this
// walk only predicts and adds.
//
// Inputs are the dense records the native tile walk (tilecoder.cpp)
// already produces — no per-block Python objects on the hot path. The
// walk pre-scans the block list and refuses (rc=-1, before touching any
// pixel) when a block needs host inter work (intrabc / inter-intra);
// callers fall back to the Python walk for those frames.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

#define API extern "C" __attribute__((visibility("default")))

// Z1/Z2/Z3 per-pixel interpolation loops (ipred.cpp)
extern "C" {
void ipred_z1_loop(const int32_t *top, int max_base_x, int dx,
                   int base_inc, int w, int h, int32_t *out);
void ipred_z2_loop(const int32_t *edge_c, int dx, int dy,
                   int upsample_above, int upsample_left, int w, int h,
                   int32_t *out);
void ipred_z3_loop(const int32_t *left_c, int max_base_y, int dy,
                   int base_inc, int w, int h, int32_t *out);
}

namespace {

// ---- implementation-order intra modes (ops/ref/ipred.py:37) ----
enum {
    M_DC = 0, M_VERT, M_HOR, M_LEFT_DC, M_TOP_DC, M_DC_128,
    M_Z1, M_Z2, M_Z3, M_SMOOTH, M_SMOOTH_V, M_SMOOTH_H, M_PAETH, M_FILTER
};

// coded-mode enums (spec order)
enum {
    C_DC = 0, C_VERT = 1, C_VERT_LEFT = 8, C_SMOOTH = 9, C_SMOOTH_V = 10,
    C_SMOOTH_H = 11, C_PAETH = 12, C_FILTER = 13, C_CFL = 13 /* uv_mode */
};

constexpr int ANGLE_SMOOTH_FLAG = 512;

// needs_{left,top,topleft,topright,bottomleft} per impl mode
// (ops/ref/ipred_prepare.py EDGES)
constexpr uint8_t EDGE_NEEDS[14][5] = {
    {1, 1, 0, 0, 0},  // DC
    {0, 1, 0, 0, 0},  // VERT
    {1, 0, 0, 0, 0},  // HOR
    {1, 0, 0, 0, 0},  // LEFT_DC
    {0, 1, 0, 0, 0},  // TOP_DC
    {0, 0, 0, 0, 0},  // DC_128
    {0, 1, 1, 1, 0},  // Z1
    {1, 1, 1, 0, 0},  // Z2
    {1, 0, 1, 0, 1},  // Z3
    {1, 1, 0, 0, 0},  // SMOOTH
    {1, 1, 0, 0, 0},  // SMOOTH_V
    {1, 1, 0, 0, 0},  // SMOOTH_H
    {1, 1, 1, 0, 0},  // PAETH
    {1, 1, 1, 0, 0},  // FILTER
};

constexpr int MODE_TO_ANGLE[8] = {90, 180, 45, 135, 113, 157, 203, 67};

// ---- block record fields (host/native_tile.py _NBLK order) ----
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
    NBLK
};

// coef record fields: plane, x, y, tx, txtp, eob, cf_off, cf_len
enum { CO_PLANE, CO_X, CO_Y, CO_TX, CO_TXTP, CO_EOB, CO_CFOFF, CO_CFLEN,
       NCOEF };

// ---- recon config layout (host/native_recon.py must match) ----
enum {
    RC_BITDEPTH, RC_SS_HOR, RC_SS_VER, RC_N_PLANES, RC_LAYOUT,
    RC_KEYFRAME, RC_IEF, RC_SB_STEP, RC_BW, RC_BH, RC_COL_START,
    RC_COL_END, RC_ROW_START, RC_ROW_END, RC_STRIDE0, RC_STRIDE1,
    RC_STRIDE2, RC_N_BLOCKS, RC_N_COEFS, RC_NCFG
};

struct Tabs {
    const uint8_t *block_dim;    // (22, 4)
    const uint8_t *txfm_dim;     // (19, 8)
    const uint8_t *sm_weights;   // (128,)
    const uint16_t *dr_intra;    // (44,)
    const int32_t *filter_taps;  // (5, 8, 7) deinterleaved
};

static inline int ctz(int v) { return __builtin_ctz(v); }
static inline int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// ---- edge helpers (ops/ref/ipred.py:126-156) ----
constexpr int EDGE_KERNELS[3][5] = {
    {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

static void filter_edge(int sz, int lim_from, int lim_to,
                        const int32_t *arr, int base, int frm, int to,
                        int strength, int32_t *out) {
    const int *ker = EDGE_KERNELS[strength - 1];
    for (int i = 0; i < sz; i++) {
        if (i < std::min(sz, lim_from) || i >= std::min(lim_to, sz)) {
            out[i] = arr[base + iclip(i, frm, to - 1)];
        } else {
            int s = 0;
            for (int j = 0; j < 5; j++)
                s += arr[base + iclip(i - 2 + j, frm, to - 1)] * ker[j];
            out[i] = (s + 8) >> 4;
        }
    }
}

static void upsample_edge(int hsz, const int32_t *arr, int base, int frm,
                          int to, int bd_max, int32_t *out) {
    static const int K[4] = {-1, 9, 9, -1};
    for (int i = 0; i < hsz - 1; i++) {
        out[i * 2] = arr[base + iclip(i, frm, to - 1)];
        int s = 0;
        for (int j = 0; j < 4; j++)
            s += arr[base + iclip(i + j - 1, frm, to - 1)] * K[j];
        out[i * 2 + 1] = iclip((s + 8) >> 4, 0, bd_max);
    }
    out[(hsz - 1) * 2] = arr[base + iclip(hsz - 1, frm, to - 1)];
}

static int get_filter_strength(int wh, int angle, int is_sm) {
    if (is_sm) {
        if (wh <= 8) {
            if (angle >= 64) return 2;
            if (angle >= 40) return 1;
        } else if (wh <= 16) {
            if (angle >= 48) return 2;
            if (angle >= 20) return 1;
        } else if (wh <= 24) {
            if (angle >= 4) return 3;
        } else {
            return 3;
        }
    } else {
        if (wh <= 8) {
            if (angle >= 56) return 1;
        } else if (wh <= 16) {
            if (angle >= 40) return 1;
        } else if (wh <= 24) {
            if (angle >= 32) return 3;
            if (angle >= 16) return 2;
            if (angle >= 8) return 1;
        } else if (wh <= 32) {
            if (angle >= 32) return 3;
            if (angle >= 4) return 2;
            return 1;
        } else {
            return 3;
        }
    }
    return 0;
}

static int get_upsample(int wh, int angle, int is_sm) {
    return angle < 40 && wh <= (16 >> is_sm);
}

// ---- dc value (ops/ref/ipred.py:54) ----
static int dc_value(const int32_t *tl, int c, int w, int h, int mode,
                    int bitdepth) {
    if (mode == M_DC_128) return bitdepth > 8 ? (1 << bitdepth) >> 1 : 128;
    if (mode == M_TOP_DC) {
        int dc = w >> 1;
        for (int i = 0; i < w; i++) dc += tl[c + 1 + i];
        return dc >> ctz(w);
    }
    if (mode == M_LEFT_DC) {
        int dc = h >> 1;
        for (int i = 0; i < h; i++) dc += tl[c - 1 - i];
        return dc >> ctz(h);
    }
    int64_t dc = (w + h) >> 1;
    for (int i = 0; i < w; i++) dc += tl[c + 1 + i];
    for (int i = 0; i < h; i++) dc += tl[c - 1 - i];
    dc >>= ctz(w + h);
    if (w != h) {
        int mult_1x2, mult_1x4, base;
        if (bitdepth == 8) { mult_1x2 = 0x5556; mult_1x4 = 0x3334; base = 16; }
        else { mult_1x2 = 0xAAAB; mult_1x4 = 0x6667; base = 17; }
        dc *= (w > h * 2 || h > w * 2) ? mult_1x4 : mult_1x2;
        dc >>= base;
    }
    return (int)dc;
}

// ---- directional predictors (edge prep per ops/ref/ipred.py) ----
static void pred_z1(const int32_t *tl, int c, int w, int h, int angle_in,
                    const Tabs &T, int bd_max, int bitdepth, int32_t *out) {
    const int is_sm = (angle_in >> 9) & 1;
    const int eief = angle_in >> 10;
    const int angle = angle_in & 511;
    int dx = T.dr_intra[angle >> 1];
    const int upsample = eief ? get_upsample(w + h, 90 - angle, is_sm) : 0;
    int32_t top[256];
    int max_base_x;
    if (upsample) {
        upsample_edge(w + h, tl, c + 1, -1, w + std::min(w, h), bd_max, top);
        max_base_x = 2 * (w + h) - 2;
        dx <<= 1;
    } else {
        const int fs =
            eief ? get_filter_strength(w + h, 90 - angle, is_sm) : 0;
        if (fs) {
            filter_edge(w + h, 0, w + h, tl, c + 1, -1,
                        w + std::min(w, h), fs, top);
            max_base_x = w + h - 1;
        } else {
            const int n = w + std::min(w, h);
            memcpy(top, tl + c + 1, n * sizeof(int32_t));
            max_base_x = n - 1;
        }
    }
    ipred_z1_loop(top, max_base_x, dx, 1 + upsample, w, h, out);
}

static void pred_z2(const int32_t *tl, int c, int w, int h, int angle_in,
                    int max_w, int max_h, const Tabs &T, int bd_max,
                    int bitdepth, int32_t *out) {
    const int is_sm = (angle_in >> 9) & 1;
    const int eief = angle_in >> 10;
    const int angle = angle_in & 511;
    int dy = T.dr_intra[(angle - 90) >> 1];
    int dx = T.dr_intra[(180 - angle) >> 1];
    const int up_l = eief ? get_upsample(w + h, 180 - angle, is_sm) : 0;
    const int up_a = eief ? get_upsample(w + h, angle - 90, is_sm) : 0;
    int32_t edge[129];
    memset(edge, 0, sizeof(edge));
    const int ec = 64;
    if (up_a) {
        upsample_edge(w + 1, tl, c, 0, w + 1, bd_max, edge + ec);
        dx <<= 1;
    } else {
        const int fs =
            eief ? get_filter_strength(w + h, angle - 90, is_sm) : 0;
        if (fs)
            filter_edge(w, 0, max_w, tl, c + 1, -1, w, fs, edge + ec + 1);
        else
            memcpy(edge + ec + 1, tl + c + 1, w * sizeof(int32_t));
    }
    if (up_l) {
        upsample_edge(h + 1, tl, c - h, 0, h + 1, bd_max,
                      edge + ec - h * 2);
        dy <<= 1;
    } else {
        const int fs =
            eief ? get_filter_strength(w + h, 180 - angle, is_sm) : 0;
        if (fs)
            filter_edge(h, h - max_h, h, tl, c - h, 0, h + 1, fs,
                        edge + ec - h);
        else
            memcpy(edge + ec - h, tl + c - h, h * sizeof(int32_t));
    }
    edge[ec] = tl[c];
    ipred_z2_loop(edge + ec, dx, dy, up_a, up_l, w, h, out);
}

static void pred_z3(const int32_t *tl, int c, int w, int h, int angle_in,
                    const Tabs &T, int bd_max, int bitdepth, int32_t *out) {
    const int is_sm = (angle_in >> 9) & 1;
    const int eief = angle_in >> 10;
    const int angle = angle_in & 511;
    int dy = T.dr_intra[(270 - angle) >> 1];
    const int up_l = eief ? get_upsample(w + h, angle - 180, is_sm) : 0;
    int32_t buf[256];
    const int32_t *left_arr;
    int left_c, max_base_y;
    if (up_l) {
        upsample_edge(w + h, tl, c - (w + h), std::max(w - h, 0),
                      w + h + 1, bd_max, buf);
        left_arr = buf;
        left_c = 2 * (w + h) - 2;
        max_base_y = 2 * (w + h) - 2;
        dy <<= 1;
    } else {
        const int fs =
            eief ? get_filter_strength(w + h, angle - 180, is_sm) : 0;
        if (fs) {
            filter_edge(w + h, 0, w + h, tl, c - (w + h),
                        std::max(w - h, 0), w + h + 1, fs, buf);
            left_arr = buf;
            left_c = w + h - 1;
            max_base_y = w + h - 1;
        } else {
            left_arr = tl;
            left_c = c - 1;
            max_base_y = h + std::min(w, h) - 1;
        }
    }
    ipred_z3_loop(left_arr + left_c, max_base_y, dy, 1 + up_l, w, h, out);
}

// ---- filter intra (ops/ref/ipred.py:383) ----
static void pred_filter(const int32_t *tl, int c, int w, int h,
                        int filt_idx, const Tabs &T, int bd_max,
                        int32_t *out) {
    filt_idx &= 511;
    const int32_t *flt = T.filter_taps + filt_idx * 8 * 7;
    auto get = [&](int py, int px) -> int {
        if (py < 0) return px >= 0 ? tl[c + 1 + px] : tl[c];
        if (px < 0) return tl[c - 1 - py];
        return out[py * w + px];
    };
    for (int y = 0; y < h; y += 2) {
        for (int x = 0; x < w; x += 4) {
            const int p[7] = {get(y - 1, x - 1), get(y - 1, x),
                              get(y - 1, x + 1), get(y - 1, x + 2),
                              get(y - 1, x + 3), get(y, x - 1),
                              get(y + 1, x - 1)};
            for (int yy = 0; yy < 2; yy++)
                for (int xx = 0; xx < 4; xx++) {
                    const int32_t *fk = flt + (yy * 4 + xx) * 7;
                    int acc = 0;
                    for (int t = 0; t < 7; t++) acc += fk[t] * p[t];
                    out[(y + yy) * w + x + xx] =
                        iclip((acc + 8) >> 4, 0, bd_max);
                }
        }
    }
}

// ---- full predictor dispatch (ops/ref/ipred.py:159) ----
static void intra_pred(int mode, const int32_t *tl, int c, int w, int h,
                       int angle, int max_w, int max_h, const Tabs &T,
                       int bitdepth, int32_t *out) {
    const int bd_max = (1 << bitdepth) - 1;
    switch (mode) {
    case M_DC: case M_TOP_DC: case M_LEFT_DC: case M_DC_128: {
        const int v = dc_value(tl, c, w, h, mode, bitdepth);
        for (int i = 0; i < w * h; i++) out[i] = v;
        break;
    }
    case M_VERT:
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++) out[y * w + x] = tl[c + 1 + x];
        break;
    case M_HOR:
        for (int y = 0; y < h; y++) {
            const int v = tl[c - 1 - y];
            for (int x = 0; x < w; x++) out[y * w + x] = v;
        }
        break;
    case M_PAETH: {
        const int topleft = tl[c];
        for (int y = 0; y < h; y++) {
            const int left = tl[c - 1 - y];
            for (int x = 0; x < w; x++) {
                const int top = tl[c + 1 + x];
                const int base = left + top - topleft;
                const int ld = std::abs(left - base);
                const int td = std::abs(top - base);
                const int tld = std::abs(topleft - base);
                out[y * w + x] = (ld <= td && ld <= tld) ? left
                                 : (td <= tld)           ? top
                                                         : topleft;
            }
        }
        break;
    }
    case M_SMOOTH: {
        const uint8_t *whw = T.sm_weights + w;
        const uint8_t *wvw = T.sm_weights + h;
        const int right = tl[c + w], bottom = tl[c - h];
        for (int y = 0; y < h; y++) {
            const int wv = wvw[y], left = tl[c - 1 - y];
            for (int x = 0; x < w; x++) {
                const int wh = whw[x];
                const int p = wv * tl[c + 1 + x] + (256 - wv) * bottom +
                              wh * left + (256 - wh) * right;
                out[y * w + x] = (p + 256) >> 9;
            }
        }
        break;
    }
    case M_SMOOTH_V: {
        const uint8_t *wvw = T.sm_weights + h;
        const int bottom = tl[c - h];
        for (int y = 0; y < h; y++) {
            const int wv = wvw[y];
            for (int x = 0; x < w; x++)
                out[y * w + x] =
                    (wv * tl[c + 1 + x] + (256 - wv) * bottom + 128) >> 8;
        }
        break;
    }
    case M_SMOOTH_H: {
        const uint8_t *whw = T.sm_weights + w;
        const int right = tl[c + w];
        for (int y = 0; y < h; y++) {
            const int left = tl[c - 1 - y];
            for (int x = 0; x < w; x++) {
                const int wh = whw[x];
                out[y * w + x] =
                    (wh * left + (256 - wh) * right + 128) >> 8;
            }
        }
        break;
    }
    case M_Z1: pred_z1(tl, c, w, h, angle, T, bd_max, bitdepth, out); break;
    case M_Z2:
        pred_z2(tl, c, w, h, angle, max_w, max_h, T, bd_max, bitdepth, out);
        break;
    case M_Z3: pred_z3(tl, c, w, h, angle, T, bd_max, bitdepth, out); break;
    case M_FILTER: pred_filter(tl, c, w, h, angle, T, bd_max, out); break;
    }
}

// ---- edge preparation (ops/ref/ipred_prepare.py:44) ----
// returns impl mode, updates *angle, fills out[257] (center c=128)
template <typename px>
static int prepare_edges(int x, int have_left, int y, int have_top, int w,
                         int h, int edge_flags, const px *plane,
                         int64_t stride, int pxx, int pyy, int mode,
                         int *angle_io, int tw, int th, int ief,
                         int bitdepth, int32_t *out) {
    const int c = 128;
    memset(out, 0, 257 * sizeof(int32_t));
    int angle = *angle_io;

    if (mode >= C_VERT && mode <= C_VERT_LEFT) {
        angle = MODE_TO_ANGLE[mode - C_VERT] + 3 * angle;
        if (angle <= 90)
            mode = (angle < 90 && have_top) ? M_Z1 : M_VERT;
        else if (angle < 180)
            mode = M_Z2;
        else
            mode = (angle > 180 && have_left) ? M_Z3 : M_HOR;
    } else if (mode == C_DC) {
        mode = have_left ? (have_top ? M_DC : M_LEFT_DC)
                         : (have_top ? M_TOP_DC : M_DC_128);
    } else if (mode == C_PAETH) {
        mode = have_left ? (have_top ? M_PAETH : M_HOR)
                         : (have_top ? M_VERT : M_DC_128);
    } else if (mode == C_SMOOTH) {
        mode = M_SMOOTH;
    } else if (mode == C_SMOOTH_V) {
        mode = M_SMOOTH_V;
    } else if (mode == C_SMOOTH_H) {
        mode = M_SMOOTH_H;
    } else if (mode == C_FILTER) {
        mode = M_FILTER;
    }
    *angle_io = angle;

    const uint8_t *nd = EDGE_NEEDS[mode];
    const int needs_left = nd[0], needs_top = nd[1], needs_topleft = nd[2],
              needs_topright = nd[3], needs_bottomleft = nd[4];
    const int have_top_for_read =
        have_top && (needs_top || needs_topleft ||
                     (needs_left && !have_left));

    const px *top_row = plane + (int64_t)(pyy - 1) * stride + pxx;
    const px *left_col = plane + (int64_t)pyy * stride + pxx - 1;

    if (needs_left) {
        const int sz = th << 2;
        if (have_left) {
            const int px_have = std::min(sz, (h - y) << 2);
            for (int i = 0; i < px_have; i++)
                out[c - 1 - i] = left_col[(int64_t)i * stride];
            for (int i = px_have; i < sz; i++)
                out[c - 1 - i] = out[c - px_have];
        } else {
            const int fill = have_top_for_read
                                 ? (int)top_row[0]
                                 : ((1 << bitdepth) >> 1) + 1;
            for (int i = 0; i < sz; i++) out[c - sz + i] = fill;
        }
        if (needs_bottomleft) {
            const int have_bl =
                (!have_left || y + th >= h) ? 0 : (edge_flags & 8);
            if (have_bl) {
                const int px_have = std::min(sz, (h - y - th) << 2);
                for (int i = 0; i < px_have; i++)
                    out[c - sz - 1 - i] =
                        left_col[(int64_t)(sz + i) * stride];
                for (int i = c - 2 * sz; i < c - sz - px_have; i++)
                    out[i] = out[c - sz - px_have];
            } else {
                for (int i = 0; i < sz; i++)
                    out[c - 2 * sz + i] = out[c - sz];
            }
        }
    }

    if (needs_top) {
        const int sz = tw << 2;
        if (have_top) {
            const int px_have = std::min(sz, (w - x) << 2);
            for (int i = 0; i < px_have; i++)
                out[c + 1 + i] = top_row[i];
            for (int i = px_have; i < sz; i++)
                out[c + 1 + i] = out[c + px_have];
        } else {
            const int fill = have_left ? (int)left_col[0]
                                       : ((1 << bitdepth) >> 1) - 1;
            for (int i = 0; i < sz; i++) out[c + 1 + i] = fill;
        }
        if (needs_topright) {
            const int have_tr =
                (!have_top || x + tw >= w) ? 0 : (edge_flags & 1);
            if (have_tr) {
                const int px_have = std::min(sz, (w - x - tw) << 2);
                for (int i = 0; i < px_have; i++)
                    out[c + 1 + sz + i] = top_row[sz + i];
                for (int i = px_have; i < sz; i++)
                    out[c + 1 + sz + i] = out[c + sz + px_have];
            } else {
                for (int i = 0; i < sz; i++)
                    out[c + 1 + sz + i] = out[c + sz];
            }
        }
    }

    if (needs_topleft) {
        if (have_left)
            out[c] = have_top ? (int)top_row[-1] : (int)left_col[0];
        else
            out[c] = have_top ? (int)top_row[0] : (1 << bitdepth) >> 1;
        if (mode == M_Z2 && tw + th >= 6 && ief)
            out[c] = ((out[c - 1] + out[c + 1]) * 5 + out[c] * 6 + 8) >> 4;
    }
    return mode;
}

// ---- CFL AC (ops/ref/ipred.py:413) ----
template <typename px>
static void cfl_ac(const px *ypx, int64_t ystride, int w_pad, int h_pad,
                   int cw, int ch, int ss_hor, int ss_ver, int32_t *ac) {
    const int shift = 1 + !ss_ver + !ss_hor;
    for (int y = 0; y < ch - 4 * h_pad; y++) {
        const px *r0 = ypx + ((int64_t)y << ss_ver) * ystride;
        const px *r1 = r0 + (ss_ver ? ystride : 0);
        int32_t *arow = ac + y * cw;
        for (int x = 0; x < cw - 4 * w_pad; x++) {
            int s = r0[x << ss_hor];
            if (ss_hor) s += r0[x * 2 + 1];
            if (ss_ver) {
                s += r1[x << ss_hor];
                if (ss_hor) s += r1[x * 2 + 1];
            }
            arow[x] = s << shift;
        }
        for (int x = cw - 4 * w_pad; x < cw; x++) arow[x] = arow[x - 1];
    }
    for (int y = ch - 4 * h_pad; y < ch; y++)
        memcpy(ac + y * cw, ac + (y - 1) * cw, cw * sizeof(int32_t));
    const int log2sz = ctz(cw) + ctz(ch);
    int64_t sum = (int64_t)(1 << log2sz) >> 1;
    for (int i = 0; i < cw * ch; i++) sum += ac[i];
    sum >>= log2sz;
    for (int i = 0; i < cw * ch; i++) ac[i] -= (int32_t)sum;
}

// ---- intrabc motion compensation (models/ref_decoder._mc_put with
// FILTER_2D_BILINEAR: dav1d mc_tmpl.c put_bilin + emu_edge clamping;
// intrabc luma MVs are whole-pel so only chroma ever interpolates) ----
template <typename px>
static void put_bilin_clamped(const px *plane, int64_t stride, int ref_w,
                              int ref_h, int bw4, int bh4, int bx, int by,
                              int ssh, int ssv, int mvy, int mvx, int ib,
                              int bd_max, int32_t *out /* bh_px*bw_px */) {
    const int h_mul = 4 >> ssh, v_mul = 4 >> ssv;
    int mx = mvx & (15 >> (ssh ? 0 : 1));
    int my = mvy & (15 >> (ssv ? 0 : 1));
    const int dx = bx * h_mul + (mvx >> (3 + ssh));
    const int dy = by * v_mul + (mvy >> (3 + ssv));
    const int w = (ref_w + ssh) >> ssh;
    const int h = (ref_h + ssv) >> ssv;
    const int bw_px = bw4 * h_mul, bh_px = bh4 * v_mul;
    mx <<= ssh ? 0 : 1;
    my <<= ssv ? 0 : 1;
    auto at = [&](int yy, int xx) -> int {
        return plane[(int64_t)iclip(dy + yy, 0, h - 1) * stride +
                     iclip(dx + xx, 0, w - 1)];
    };
    auto bil = [](int a, int b, int mxy, int sh) {
        return (16 * a + mxy * (b - a) + ((1 << sh) >> 1)) >> sh;
    };
    if (mx && my) {
        // two-pass: horizontal into (bh_px+2) mid rows, then vertical
        int32_t mid[(128 + 2) * 128];
        for (int y = 0; y < bh_px + 2; y++)
            for (int x = 0; x < bw_px; x++)
                mid[y * bw_px + x] =
                    bil(at(y, x), at(y, x + 1), mx, 4 - ib);
        for (int y = 0; y < bh_px; y++)
            for (int x = 0; x < bw_px; x++)
                out[y * bw_px + x] =
                    iclip(bil(mid[y * bw_px + x], mid[(y + 1) * bw_px + x],
                              my, 4 + ib),
                          0, bd_max);
    } else if (mx) {
        const int irnd = (1 << ib) >> 1;
        for (int y = 0; y < bh_px; y++)
            for (int x = 0; x < bw_px; x++) {
                const int v = bil(at(y, x), at(y, x + 1), mx, 4 - ib);
                out[y * bw_px + x] = iclip((v + irnd) >> ib, 0, bd_max);
            }
    } else if (my) {
        for (int y = 0; y < bh_px; y++)
            for (int x = 0; x < bw_px; x++)
                out[y * bw_px + x] =
                    iclip(bil(at(y, x), at(y + 1, x), my, 4), 0, bd_max);
    } else {
        for (int y = 0; y < bh_px; y++)
            for (int x = 0; x < bw_px; x++)
                out[y * bw_px + x] = at(y, x);
    }
}

// ---- per-tile walk ----
template <typename px>
struct Walk {
    const int32_t *cfg;
    Tabs T;
    px *planes[3];
    int64_t strides[3];
    const int32_t *blk;
    const int32_t *coef;
    const uint16_t *pal;       // (n, 3, 8)
    const uint8_t *palidx;
    const int32_t *res_buf;
    const int64_t *res_off;    // per coef record, -1 = none
    const uint8_t *device_done;  // 0 host, 1 device-complete,
                                 // 2 device-put + host inter-intra blend
    const uint8_t *ii_masks;   // inter-intra blend masks (flat)
    const int64_t *ii_off;     // (n_blocks, 2): luma/chroma mask offsets

    int bitdepth, bd_max, ss_hor, ss_ver, n_planes, layout, keyframe, ief;
    int sb_step, bw, bh, col_start, col_end, row_start, row_end;
    int n_blocks, n_coefs;

    std::vector<uint8_t> a_mode, a_intra, a_uvmode;
    uint8_t l_mode[32], l_intra[32], l_uvmode[32];

    int init() {
        bitdepth = cfg[RC_BITDEPTH];
        bd_max = (1 << bitdepth) - 1;
        ss_hor = cfg[RC_SS_HOR];
        ss_ver = cfg[RC_SS_VER];
        n_planes = cfg[RC_N_PLANES];
        layout = cfg[RC_LAYOUT];
        keyframe = cfg[RC_KEYFRAME];
        ief = cfg[RC_IEF];
        sb_step = cfg[RC_SB_STEP];
        bw = cfg[RC_BW];
        bh = cfg[RC_BH];
        col_start = cfg[RC_COL_START];
        col_end = cfg[RC_COL_END];
        row_start = cfg[RC_ROW_START];
        row_end = cfg[RC_ROW_END];
        n_blocks = cfg[RC_N_BLOCKS];
        n_coefs = cfg[RC_N_COEFS];
        // refuse before touching pixels when a block needs host inter
        // work this walk cannot do. Natively covered: plain intra,
        // device-complete inter (1), keyframe intrabc, and inter-intra
        // blend over a device put (2, needs its masks).
        for (int i = 0; i < n_blocks; i++) {
            if (blk[i * NBLK + B_INTRA]) continue;
            if (keyframe) continue;                   // intrabc
            if (device_done[i] == 1) continue;
            if (device_done[i] == 2 &&
                ii_off && ii_off[(int64_t)i * 2] >= 0) continue;
            return -1;
        }
        a_mode.assign(bw + 32, 0);
        a_intra.assign(bw + 32, keyframe ? 1 : 0);
        a_uvmode.assign(bw + 32, 0);
        memset(l_mode, 0, 32);
        memset(l_intra, keyframe ? 1 : 0, 32);
        memset(l_uvmode, 0, 32);
        return 0;
    }

    static int sm_flag(const uint8_t *mode, const uint8_t *intra, int i) {
        if (!intra[i]) return 0;
        const int m = mode[i];
        return (m >= 9 && m <= 11) ? ANGLE_SMOOTH_FLAG : 0;
    }
    static int sm_uv_flag(const uint8_t *uvmode, int i) {
        const int m = uvmode[i];
        return (m >= 9 && m <= 11) ? ANGLE_SMOOTH_FLAG : 0;
    }

    // residual add (models/ref_decoder._itx_add_block device-res branch)
    int add_residual(int ci, int pl, int exp_x, int exp_y, int tw4,
                     int th4) {
        const int32_t *r = coef + (int64_t)ci * NCOEF;
        if (r[CO_PLANE] != pl || r[CO_X] != exp_x || r[CO_Y] != exp_y)
            return -2;
        if (r[CO_EOB] < 0) return 0;
        const int64_t off = res_off[ci];
        if (off < 0) return -3;
        const int32_t *res = res_buf + off;
        px *plane = planes[pl];
        const int64_t stride = strides[pl];
        const int w = tw4 * 4, h = th4 * 4;
        px *dst = plane + (int64_t)r[CO_Y] * 4 * stride + r[CO_X] * 4;
        for (int y = 0; y < h; y++) {
            px *row = dst + (int64_t)y * stride;
            const int32_t *rr = res + y * w;
            for (int x = 0; x < w; x++)
                row[x] = (px)iclip((int)row[x] + rr[x], 0, bd_max);
        }
        return 0;
    }

    // record-order residual replay for inter-class blocks (intrabc /
    // inter-intra: ref_decoder._recon_b_inter coefficient loop — dims
    // come from each record's own tx)
    int add_residual_rec(int ci) {
        const int32_t *r = coef + (int64_t)ci * NCOEF;
        if (r[CO_EOB] < 0) return 0;
        const uint8_t *td = T.txfm_dim + r[CO_TX] * 8;
        return add_residual(ci, r[CO_PLANE], r[CO_X], r[CO_Y], td[0],
                            td[1]);
    }

    void write_pred32(int pl, int pyy, int pxx, int w, int h,
                      const int32_t *pred) {
        px *dst = planes[pl] + (int64_t)pyy * strides[pl] + pxx;
        for (int y = 0; y < h; y++) {
            px *row = dst + (int64_t)y * strides[pl];
            const int32_t *p = pred + y * w;
            for (int x = 0; x < w; x++) row[x] = (px)p[x];
        }
    }

    // keyframe intra-block-copy (ref_decoder._recon_b_inter:354-370)
    int intrabc_block(const int32_t *b) {
        const uint8_t *bdm = T.block_dim + b[B_BS] * 4;
        const int bw4 = bdm[0], bh4 = bdm[1];
        const int bx = b[B_BX], by = b[B_BY];
        const int mvy = b[B_MV0Y], mvx = b[B_MV0X];
        const int ib = bitdepth == 8 ? 4 : 14 - bitdepth;
        const int ref_w = bw * 4, ref_h = bh * 4;
        const int has_chroma =
            n_planes > 1 && (bw4 > ss_hor || (bx & 1)) &&
            (bh4 > ss_ver || (by & 1));
        int32_t predb[128 * 128];
        put_bilin_clamped(planes[0], strides[0], ref_w, ref_h, bw4, bh4,
                          bx, by, 0, 0, mvy, mvx, ib, bd_max, predb);
        write_pred32(0, by * 4, bx * 4, bw4 * 4, bh4 * 4, predb);
        if (has_chroma) {
            const int bw4c = bw4 << (bw4 == ss_hor);
            const int bh4c = bh4 << (bh4 == ss_ver);
            const int uvx = (bx >> ss_hor) * 4, uvy = (by >> ss_ver) * 4;
            const int cw = bw4c * 4 >> ss_hor, ch = bh4c * 4 >> ss_ver;
            for (int pl = 1; pl <= 2; pl++) {
                put_bilin_clamped(planes[pl], strides[pl], ref_w, ref_h,
                                  bw4c, bh4c, bx & ~ss_hor, by & ~ss_ver,
                                  ss_hor, ss_ver, mvy, mvx, ib, bd_max,
                                  predb);
                write_pred32(pl, uvy, uvx, cw, ch, predb);
            }
        }
        if (!b[B_SKIP])
            for (int ci = b[B_COEF_LO]; ci < b[B_COEF_HI]; ci++) {
                const int rc = add_residual_rec(ci);
                if (rc) return rc;
            }
        return 0;
    }

    // inter-intra blend over the device-produced put
    // (ref_decoder._recon_b_inter:392-407, 474-496)
    int interintra_block(int bi, const int32_t *b) {
        const uint8_t *bdm = T.block_dim + b[B_BS] * 4;
        const int bw4 = bdm[0], bh4 = bdm[1];
        const int bx = b[B_BX], by = b[B_BY];
        const int has_chroma =
            n_planes > 1 && (bw4 > ss_hor || (bx & 1)) &&
            (bh4 > ss_ver || (by & 1));
        const int m = b[B_INTERINTRA_MODE] == 3 ? 9 : b[B_INTERINTRA_MODE];
        int32_t tl[257];
        int32_t predb[64 * 64];
        int angle = 0;
        const int m2 = prepare_edges(
            bx, bx > col_start, by, by > row_start, col_end, row_end, 0,
            planes[0], strides[0], bx * 4, by * 4, m, &angle, bw4, bh4,
            0, bitdepth, tl);
        intra_pred(m2, tl, 128, bw4 * 4, bh4 * 4, 0, 0, 0, T, bitdepth,
                   predb);
        blend(0, by * 4, bx * 4, bw4 * 4, bh4 * 4, predb,
              ii_masks + ii_off[(int64_t)bi * 2]);
        if (has_chroma) {
            const int cbw4 = (bw4 + ss_hor) >> ss_hor;
            const int cbh4 = (bh4 + ss_ver) >> ss_ver;
            if (ii_off[(int64_t)bi * 2 + 1] < 0) return -4;
            const uint8_t *cmsk = ii_masks + ii_off[(int64_t)bi * 2 + 1];
            for (int pl = 1; pl <= 2; pl++) {
                const int xpos = bx >> ss_hor, ypos = by >> ss_ver;
                angle = 0;
                const int mc2 = prepare_edges(
                    xpos, xpos > (col_start >> ss_hor), ypos,
                    ypos > (row_start >> ss_ver), col_end >> ss_hor,
                    row_end >> ss_ver, 0, planes[pl], strides[pl],
                    xpos * 4, ypos * 4, m, &angle, cbw4, cbh4, 0,
                    bitdepth, tl);
                intra_pred(mc2, tl, 128, cbw4 * 4, cbh4 * 4, 0, 0, 0, T,
                           bitdepth, predb);
                blend(pl, ypos * 4, xpos * 4, cbw4 * 4, cbh4 * 4, predb,
                      cmsk);
            }
        }
        if (!b[B_SKIP])
            for (int ci = b[B_COEF_LO]; ci < b[B_COEF_HI]; ci++) {
                const int rc = add_residual_rec(ci);
                if (rc) return rc;
            }
        return 0;
    }

    // dst = (dst*(64-m) + pred*m + 32) >> 6 (mc.py blend / dav1d blend)
    void blend(int pl, int pyy, int pxx, int w, int h,
               const int32_t *pred, const uint8_t *msk) {
        px *dst = planes[pl] + (int64_t)pyy * strides[pl] + pxx;
        for (int y = 0; y < h; y++) {
            px *row = dst + (int64_t)y * strides[pl];
            const int32_t *p = pred + y * w;
            const uint8_t *mr = msk + y * w;
            for (int x = 0; x < w; x++)
                row[x] = (px)(((int)row[x] * (64 - mr[x]) + p[x] * mr[x] +
                               32) >>
                              6);
        }
    }

    void write_pred(int pl, int pyy, int pxx, int w, int h,
                    const int32_t *pred) {
        px *dst = planes[pl] + (int64_t)pyy * strides[pl] + pxx;
        for (int y = 0; y < h; y++) {
            px *row = dst + (int64_t)y * strides[pl];
            const int32_t *p = pred + y * w;
            for (int x = 0; x < w; x++) row[x] = (px)p[x];
        }
    }

    int run() {
        int cur_sbrow = -1;
        for (int bi = 0; bi < n_blocks; bi++) {
            const int32_t *b = blk + (int64_t)bi * NBLK;
            const int by = b[B_BY], bx = b[B_BX];
            const int sbrow = by / sb_step;
            if (sbrow != cur_sbrow) {
                cur_sbrow = sbrow;
                memset(l_mode, 0, 32);
                memset(l_intra, keyframe ? 1 : 0, 32);
                memset(l_uvmode, 0, 32);
            }
            const uint8_t *bd = T.block_dim + b[B_BS] * 4;
            const int bw4 = bd[0], bh4 = bd[1];
            const int by4 = by & 31;

            if (!b[B_INTRA]) {
                // keyframe intrabc and inter-intra blends run here in
                // decode order; device-complete inter blocks only
                // maintain neighbour state
                if (keyframe) {
                    const int rc = intrabc_block(b);
                    if (rc) return rc;
                } else if (device_done[bi] == 2) {
                    const int rc = interintra_block(bi, b);
                    if (rc) return rc;
                }
                std::fill(a_intra.begin() + bx, a_intra.begin() + bx + bw4,
                          0);
                for (int i = 0; i < bh4; i++) l_intra[by4 + i] = 0;
                if (n_planes > 1) {
                    const int cbw4 = (bw4 + ss_hor) >> ss_hor;
                    const int cbh4 = (bh4 + ss_ver) >> ss_ver;
                    const int has_c = (bw4 > ss_hor || (bx & 1)) &&
                                      (bh4 > ss_ver || (by & 1));
                    if (has_c) {
                        const int cbx = bx >> ss_hor;
                        std::fill(a_uvmode.begin() + cbx,
                                  a_uvmode.begin() + cbx + cbw4, 0);
                        const int cby4 = by4 >> ss_ver;
                        for (int i = 0; i < cbh4; i++)
                            l_uvmode[cby4 + i] = 0;
                    }
                }
                continue;
            }

            int ci = b[B_COEF_LO];
            const int w4 = std::min(bw4, bw - bx);
            const int h4 = std::min(bh4, bh - by);
            const int cw4 = (w4 + ss_hor) >> ss_hor;
            const int ch4 = (h4 + ss_ver) >> ss_ver;
            const int cbw4 = (bw4 + ss_hor) >> ss_hor;
            const int cbh4 = (bh4 + ss_ver) >> ss_ver;
            const int has_chroma =
                n_planes > 1 && (bw4 > ss_hor || (bx & 1)) &&
                (bh4 > ss_ver || (by & 1));
            const uint8_t *td = T.txfm_dim + b[B_TX] * 8;
            const uint8_t *utd = T.txfm_dim + b[B_UVTX] * 8;
            const int tw = td[0], th = td[1];
            const int ctw = utd[0], cth = utd[1];
            const int ief_flag = ief << 10;
            const int edge_flags = b[B_EDGE_FLAGS];
            const int skip = b[B_SKIP];

            int32_t tl[257];
            int32_t pred[64 * 64];

            for (int init_y = 0; init_y < h4; init_y += 16) {
                const int sub_h4 = std::min(h4, 16 + init_y);
                const int sub_ch4 = std::min(ch4, (init_y + 16) >> ss_ver);
                for (int init_x = 0; init_x < w4; init_x += 16) {
                    const int sub_w4 = std::min(w4, init_x + 16);
                    const int intra_flags =
                        sm_flag(a_mode.data(), a_intra.data(),
                                bx + init_x) |
                        sm_flag(l_mode, l_intra, by4 + init_y) | ief_flag;
                    const int sb_has_tr =
                        (init_x + 16 < w4) ? 1
                        : init_y           ? 0
                                           : (edge_flags & 1);
                    const int sb_has_bl =
                        init_x              ? 0
                        : (init_y + 16 < h4) ? 1
                                             : (edge_flags & 8);

                    // luma palette (recon_tmpl.c:1228-1247)
                    if (b[B_PAL_SZ0] && !init_x && !init_y) {
                        const uint16_t *p8 = pal + (int64_t)b[B_PAL_OFF] *
                                                       24;  // row 0
                        const uint8_t *idx = palidx + b[B_PALIDX_Y_OFF];
                        px *dst = planes[0] +
                                  (int64_t)(4 * by) * strides[0] + 4 * bx;
                        for (int y = 0; y < bh4 * 4; y++) {
                            px *row = dst + (int64_t)y * strides[0];
                            const uint8_t *ir = idx + y * bw4 * 4;
                            for (int x = 0; x < bw4 * 4; x++)
                                row[x] = (px)p8[ir[x]];
                        }
                    }

                    // ---- luma ----
                    for (int y = init_y; y < sub_h4; y += th) {
                        for (int x = init_x; x < sub_w4; x += tw) {
                            const int pxx = 4 * (bx + x),
                                      pyy = 4 * (by + y);
                            if (b[B_PAL_SZ0]) {
                                if (!skip) {
                                    const int rc = add_residual(
                                        ci++, 0, bx + x, by + y, tw, th);
                                    if (rc) return rc;
                                }
                                continue;
                            }
                            int angle = b[B_Y_ANGLE];
                            const int eflags =
                                (((y > init_y || !sb_has_tr) &&
                                  (x + tw >= sub_w4))
                                     ? 0
                                     : 1) |
                                ((x > init_x ||
                                  (!sb_has_bl && y + th >= sub_h4))
                                     ? 0
                                     : 8);
                            const int mode = prepare_edges(
                                bx + x, bx + x > col_start, by + y,
                                by + y > row_start, col_end, row_end,
                                eflags, planes[0], strides[0], pxx, pyy,
                                b[B_Y_MODE], &angle, tw, th, ief,
                                bitdepth, tl);
                            intra_pred(mode, tl, 128, tw * 4, th * 4,
                                       angle | intra_flags,
                                       4 * bw - 4 * (bx + x),
                                       4 * bh - 4 * (by + y), T, bitdepth,
                                       pred);
                            write_pred(0, pyy, pxx, tw * 4, th * 4, pred);
                            if (!skip) {
                                const int rc = add_residual(
                                    ci++, 0, bx + x, by + y, tw, th);
                                if (rc) return rc;
                            }
                        }
                    }

                    if (!has_chroma) continue;

                    // ---- CFL / chroma palette ----
                    const int uv_mode = b[B_UV_MODE];
                    if (uv_mode == C_CFL && !init_x && !init_y) {
                        // recon_tmpl.c:1310-1337 (init 0,0 only)
                        const int ysrc_x = 4 * (bx & ~ss_hor);
                        const int ysrc_y = 4 * (by & ~ss_ver);
                        const int furthest_r =
                            ((cw4 << ss_hor) + tw - 1) & ~(tw - 1);
                        const int furthest_b =
                            ((ch4 << ss_ver) + th - 1) & ~(th - 1);
                        const int w_pad = cbw4 - (furthest_r >> ss_hor);
                        const int h_pad = cbh4 - (furthest_b >> ss_ver);
                        int32_t ac[32 * 32];
                        cfl_ac(planes[0] +
                                   (int64_t)ysrc_y * strides[0] + ysrc_x,
                               strides[0], w_pad, h_pad, cbw4 * 4,
                               cbh4 * 4, ss_hor, ss_ver, ac);
                        for (int pl = 0; pl < 2; pl++) {
                            const int alpha = b[B_CFL_A0 + pl];
                            if (!alpha) continue;
                            const int xpos = bx >> ss_hor,
                                      ypos = by >> ss_ver;
                            int ang0 = 0;
                            const int m = prepare_edges(
                                xpos, xpos > (col_start >> ss_hor), ypos,
                                ypos > (row_start >> ss_ver),
                                col_end >> ss_hor, row_end >> ss_ver, 0,
                                planes[1 + pl], strides[1 + pl], xpos * 4,
                                ypos * 4, 0, &ang0, ctw, cth, 0, bitdepth,
                                tl);
                            const int dc = dc_value(tl, 128, ctw * 4,
                                                    cth * 4, m, bitdepth);
                            px *dst = planes[1 + pl] +
                                      (int64_t)(ypos * 4) *
                                          strides[1 + pl] +
                                      xpos * 4;
                            for (int y = 0; y < cth * 4; y++) {
                                px *row =
                                    dst + (int64_t)y * strides[1 + pl];
                                const int32_t *arow = ac + y * cbw4 * 4;
                                for (int x = 0; x < ctw * 4; x++) {
                                    const int diff = alpha * arow[x];
                                    const int ad =
                                        (std::abs(diff) + 32) >> 6;
                                    const int v =
                                        dc + (diff < 0 ? -ad
                                              : diff > 0 ? ad
                                                         : 0);
                                    row[x] = (px)iclip(v, 0, bd_max);
                                }
                            }
                        }
                    } else if (b[B_PAL_SZ1]) {
                        // chroma palette (recon_tmpl.c:1424-1446)
                        const int uvx = (bx >> ss_hor) * 4,
                                  uvy = (by >> ss_ver) * 4;
                        const uint8_t *idx = palidx + b[B_PALIDX_UV_OFF];
                        for (int pl = 1; pl <= 2; pl++) {
                            const uint16_t *p8 =
                                pal + (int64_t)b[B_PAL_OFF] * 24 + pl * 8;
                            px *dst = planes[pl] +
                                      (int64_t)uvy * strides[pl] + uvx;
                            for (int y = 0; y < cbh4 * 4; y++) {
                                px *row = dst + (int64_t)y * strides[pl];
                                const uint8_t *ir = idx + y * cbw4 * 4;
                                for (int x = 0; x < cbw4 * 4; x++)
                                    row[x] = (px)p8[ir[x]];
                            }
                        }
                    }

                    const int sm_uv_fl =
                        sm_uv_flag(a_uvmode.data(),
                                   (bx + init_x) >> ss_hor) |
                        sm_uv_flag(l_uvmode,
                                   (by4 >> ss_ver) + (init_y >> ss_ver));
                    const int uv_sb_has_tr =
                        (((init_x + 16) >> ss_hor) < cw4) ? 1
                        : init_y                          ? 0
                        : (edge_flags & (4 >> (layout - 1)));
                    const int uv_sb_has_bl =
                        init_x                              ? 0
                        : (((init_y + 16) >> ss_ver) < ch4) ? 1
                        : (edge_flags & (32 >> (layout - 1)));
                    const int sub_cw4 =
                        std::min(cw4, (init_x + 16) >> ss_hor);
                    for (int pl = 0; pl < 2; pl++) {
                        for (int y = init_y >> ss_ver; y < sub_ch4;
                             y += cth) {
                            for (int x = init_x >> ss_hor; x < sub_cw4;
                                 x += ctw) {
                                const int xpos = (bx >> ss_hor) + x;
                                const int ypos = (by >> ss_ver) + y;
                                const int ppx = xpos * 4, ppy = ypos * 4;
                                const int do_pred =
                                    !((uv_mode == C_CFL &&
                                       b[B_CFL_A0 + pl]) ||
                                      b[B_PAL_SZ1]);
                                if (do_pred) {
                                    int angle = b[B_UV_ANGLE];
                                    const int eflags =
                                        (((y > (init_y >> ss_ver) ||
                                           !uv_sb_has_tr) &&
                                          (x + ctw >= sub_cw4))
                                             ? 0
                                             : 1) |
                                        ((x > (init_x >> ss_hor) ||
                                          (!uv_sb_has_bl &&
                                           y + cth >= sub_ch4))
                                             ? 0
                                             : 8);
                                    const int cmode =
                                        uv_mode == C_CFL ? 0 : uv_mode;
                                    int m = prepare_edges(
                                        xpos,
                                        xpos > (col_start >> ss_hor),
                                        ypos,
                                        ypos > (row_start >> ss_ver),
                                        col_end >> ss_hor,
                                        row_end >> ss_ver, eflags,
                                        planes[1 + pl], strides[1 + pl],
                                        ppx, ppy, cmode, &angle, ctw,
                                        cth, ief, bitdepth, tl);
                                    angle |= ief << 10;
                                    intra_pred(
                                        m, tl, 128, ctw * 4, cth * 4,
                                        angle | sm_uv_fl,
                                        (4 * bw + ss_hor -
                                         4 * (bx & ~ss_hor)) >>
                                            ss_hor,
                                        (4 * bh + ss_ver -
                                         4 * (by & ~ss_ver)) >>
                                            ss_ver,
                                        T, bitdepth, pred);
                                    write_pred(1 + pl, ppy, ppx, ctw * 4,
                                               cth * 4, pred);
                                }
                                if (!skip) {
                                    const int rc = add_residual(
                                        ci++, 1 + pl, xpos, ypos, ctw,
                                        cth);
                                    if (rc) return rc;
                                }
                            }
                        }
                    }
                }
            }

            // update neighbour mode state
            const int y_mode_nofilt =
                b[B_Y_MODE] == C_FILTER ? 0 : b[B_Y_MODE];
            std::fill(a_mode.begin() + bx, a_mode.begin() + bx + bw4,
                      (uint8_t)y_mode_nofilt);
            std::fill(a_intra.begin() + bx, a_intra.begin() + bx + bw4, 1);
            for (int i = 0; i < bh4; i++) {
                l_mode[by4 + i] = (uint8_t)y_mode_nofilt;
                l_intra[by4 + i] = 1;
            }
            if (has_chroma) {
                const int cbx = bx >> ss_hor;
                std::fill(a_uvmode.begin() + cbx,
                          a_uvmode.begin() + cbx + cbw4,
                          (uint8_t)b[B_UV_MODE]);
                const int cby4 = by4 >> ss_ver;
                for (int i = 0; i < cbh4; i++)
                    l_uvmode[cby4 + i] = (uint8_t)b[B_UV_MODE];
            }
        }
        return 0;
    }
};

template <typename px>
static int run_walk(const int32_t *cfg, const uint64_t *tabs,
                    const uint64_t *plane_ptrs, const int32_t *blk,
                    const int32_t *coef, const uint16_t *pal,
                    const uint8_t *palidx, const int32_t *res_buf,
                    const int64_t *res_off, const uint8_t *device_done,
                    const uint8_t *ii_masks, const int64_t *ii_off) {
    Walk<px> w;
    w.cfg = cfg;
    w.T.block_dim = (const uint8_t *)tabs[0];
    w.T.txfm_dim = (const uint8_t *)tabs[1];
    w.T.sm_weights = (const uint8_t *)tabs[2];
    w.T.dr_intra = (const uint16_t *)tabs[3];
    w.T.filter_taps = (const int32_t *)tabs[4];
    for (int i = 0; i < 3; i++) {
        w.planes[i] = (px *)plane_ptrs[i];
        w.strides[i] = (int64_t)cfg[RC_STRIDE0 + i];
    }
    w.blk = blk;
    w.coef = coef;
    w.pal = pal;
    w.palidx = palidx;
    w.res_buf = res_buf;
    w.res_off = res_off;
    w.device_done = device_done;
    w.ii_masks = ii_masks;
    w.ii_off = ii_off;
    const int rc = w.init();
    if (rc) return rc;
    return w.run();
}

}  // namespace

API int recon_cfg_size() { return RC_NCFG; }

// rc: 0 ok; -1 unsupported host-inter block present (no pixels
// touched); -2 coef record order mismatch; -3 missing residual;
// -4 missing inter-intra mask.
API int recon_intra_pass(const int32_t *cfg, const uint64_t *tabs,
                         const uint64_t *plane_ptrs, const int32_t *blk,
                         const int32_t *coef, const uint16_t *pal,
                         const uint8_t *palidx, const int32_t *res_buf,
                         const int64_t *res_off,
                         const uint8_t *device_done,
                         const uint8_t *ii_masks, const int64_t *ii_off) {
    if (cfg[RC_BITDEPTH] == 8)
        return run_walk<uint8_t>(cfg, tabs, plane_ptrs, blk, coef, pal,
                                 palidx, res_buf, res_off, device_done,
                                 ii_masks, ii_off);
    return run_walk<uint16_t>(cfg, tabs, plane_ptrs, blk, coef, pal,
                              palidx, res_buf, res_off, device_done,
                              ii_masks, ii_off);
}
