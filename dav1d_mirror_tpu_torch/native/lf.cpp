// Copied from dav1d_mirror_tpu/native/lf.cpp.
// Native deblocking edge/level map construction — the C++ twin of
// host/lf.py build_lf_arrays (dense-array formulation of dav1d
// src/lf_mask.c mask_edges_intra/inter/chroma + level cache fill).
//
// Consumes the dense per-tile block records the native tile walk
// produces (same B_* layout as tilecoder.cpp / host/native_tile.py);
// one call per tile in coding order, sharing the frame-global maps so
// cross-tile neighbour reads behave exactly like the Python map construction.

#include <cstdint>
#include <algorithm>

#define API extern "C" __attribute__((visibility("default")))

namespace {

enum {
    B_BL, B_BP, B_BS, B_BX, B_BY, B_SEG_ID, B_SKIP_MODE, B_SKIP, B_INTRA,
    B_Y_MODE, B_Y_ANGLE, B_UV_MODE, B_UV_ANGLE, B_CFL_A0, B_CFL_A1,
    B_PAL_SZ0, B_PAL_SZ1, B_TX, B_UVTX, B_MAX_YTX, B_TX_SPLIT0,
    B_TX_SPLIT1, B_INTER_MODE, B_DRL_IDX, B_REF0, B_REF1, B_MV0Y, B_MV0X,
    B_MV1Y, B_MV1X, B_COMP_TYPE, B_MOTION_MODE, B_INTERINTRA_TYPE,
    B_INTERINTRA_MODE, B_WEDGE_IDX, B_MASK_SIGN, B_FILTER2D, B_QIDX,
    B_EDGE_FLAGS, B_LF0, B_LF1, B_LF2, B_LF3, B_COEF_LO, B_COEF_HI,
    B_PAL_OFF, B_PALIDX_Y_OFF, B_PALIDX_UV_OFF, NBLK_USED
};
constexpr int NBLK = 59;

// lf cfg layout (host/lf.py must match)
enum { LC_W4, LC_H4, LC_CW4, LC_CH4, LC_SS_HOR, LC_SS_VER, LC_MONO,
       LC_N_BLOCKS, LC_NCFG };

struct Ctx {
    const uint8_t *block_dim;   // (22, 4)
    const uint8_t *txfm_dim;    // (19, 8)
    int w4, h4, cw4, ch4, ss_hor, ss_ver, mono;
    int8_t *edge_v_y, *edge_h_y, *edge_v_uv, *edge_h_uv;
    uint8_t *lvl_y, *lvl_uv;          // (h4, w4, 2) / (ch4, cw4, 2)
    uint8_t *txw_map, *txh_map;       // (h4+32, w4+32)
    uint8_t *ctxw_map, *ctxh_map;     // (ch4+32, cw4+32)
    int mstride, cmstride;            // w4+32 / cw4+32

    int l_y(int by, int bx) const {
        return bx == 0 ? 2 : txw_map[by * mstride + bx - 1];
    }
    int a_y(int by, int bx) const {
        return by == 0 ? 2 : txh_map[(by - 1) * mstride + bx];
    }
    int l_uv(int cby, int cbx) const {
        return cbx == 0 ? 1 : ctxw_map[cby * cmstride + cbx - 1];
    }
    int a_uv(int cby, int cbx) const {
        return cby == 0 ? 1 : ctxh_map[(cby - 1) * cmstride + cbx];
    }
};

// dav1d lf_mask.c decomp_tx:39 — dense 32x32 formulation (host/lf.py
// _decomp_tx)
static void decomp_tx(const Ctx &C, int32_t txw[32][32],
                      int32_t txh[32][32], int32_t stepw[32][32],
                      int32_t steph[32][32], int from_tx, int depth,
                      int y_off, int x_off, const int masks[2], int y0,
                      int x0) {
    const uint8_t *td = C.txfm_dim + from_tx * 8;
    const int w = td[0], hh = td[1];
    const int is_split =
        (from_tx == 0 || depth > 1)
            ? 0
            : (masks[depth] >> (y_off * 4 + x_off)) & 1;
    if (is_split) {
        const int sub = td[6];
        const int htw4 = w >> 1, hth4 = hh >> 1;
        decomp_tx(C, txw, txh, stepw, steph, sub, depth + 1, y_off * 2,
                  x_off * 2, masks, y0, x0);
        if (w >= hh)
            decomp_tx(C, txw, txh, stepw, steph, sub, depth + 1,
                      y_off * 2, x_off * 2 + 1, masks, y0, x0 + htw4);
        if (hh >= w) {
            decomp_tx(C, txw, txh, stepw, steph, sub, depth + 1,
                      y_off * 2 + 1, x_off * 2, masks, y0 + hth4, x0);
            if (w >= hh)
                decomp_tx(C, txw, txh, stepw, steph, sub, depth + 1,
                          y_off * 2 + 1, x_off * 2 + 1, masks, y0 + hth4,
                          x0 + htw4);
        }
    } else {
        const int lw = std::min(2, (int)td[2]), lh = std::min(2, (int)td[3]);
        for (int y = y0; y < y0 + hh; y++)
            for (int x = x0; x < x0 + w; x++) {
                txw[y][x] = lw;
                txh[y][x] = lh;
            }
        for (int y = y0; y < y0 + hh; y++) stepw[y][x0] = w;
        for (int x = x0; x < x0 + w; x++) steph[y0][x] = hh;
    }
}

}  // namespace

API int lf_cfg_size() { return LC_NCFG; }

API void lf_build(const int32_t *cfg, const uint64_t *tabs,
                  const int32_t *blk, const uint64_t *outp) {
    Ctx C;
    C.block_dim = (const uint8_t *)tabs[0];
    C.txfm_dim = (const uint8_t *)tabs[1];
    C.w4 = cfg[LC_W4];
    C.h4 = cfg[LC_H4];
    C.cw4 = cfg[LC_CW4];
    C.ch4 = cfg[LC_CH4];
    C.ss_hor = cfg[LC_SS_HOR];
    C.ss_ver = cfg[LC_SS_VER];
    C.mono = cfg[LC_MONO];
    C.edge_v_y = (int8_t *)outp[0];
    C.edge_h_y = (int8_t *)outp[1];
    C.edge_v_uv = (int8_t *)outp[2];
    C.edge_h_uv = (int8_t *)outp[3];
    C.lvl_y = (uint8_t *)outp[4];
    C.lvl_uv = (uint8_t *)outp[5];
    C.txw_map = (uint8_t *)outp[6];
    C.txh_map = (uint8_t *)outp[7];
    C.ctxw_map = (uint8_t *)outp[8];
    C.ctxh_map = (uint8_t *)outp[9];
    C.mstride = C.w4 + 32;
    C.cmstride = C.cw4 + 32;
    const int n_blocks = cfg[LC_N_BLOCKS];
    const int w4 = C.w4, h4 = C.h4, cw4 = C.cw4, ch4 = C.ch4;

    for (int bi = 0; bi < n_blocks; bi++) {
        const int32_t *b = blk + (int64_t)bi * NBLK;
        const uint8_t *bdm = C.block_dim + b[B_BS] * 4;
        const int bx = b[B_BX], by = b[B_BY];
        const int bw4 = std::min(w4 - bx, (int)bdm[0]);
        const int bh4 = std::min(h4 - by, (int)bdm[1]);
        if (bw4 <= 0 || bh4 <= 0) continue;

        for (int y = by; y < by + bh4; y++)
            for (int x = bx; x < bx + bw4; x++) {
                C.lvl_y[(y * w4 + x) * 2 + 0] = (uint8_t)b[B_LF0];
                C.lvl_y[(y * w4 + x) * 2 + 1] = (uint8_t)b[B_LF1];
            }

        if (b[B_INTRA]) {
            const uint8_t *td = C.txfm_dim + b[B_TX] * 8;
            const int tw = td[0], th = td[1];
            const int twl4c = std::min(2, (int)td[2]);
            const int thl4c = std::min(2, (int)td[3]);
            for (int y = 0; y < bh4; y++)
                C.edge_v_y[(by + y) * w4 + bx] =
                    (int8_t)std::min(twl4c, C.l_y(by + y, bx));
            for (int x = 0; x < bw4; x++)
                C.edge_h_y[by * w4 + bx + x] =
                    (int8_t)std::min(thl4c, C.a_y(by, bx + x));
            for (int xi = tw; xi < bw4; xi += tw)
                for (int y = 0; y < bh4; y++)
                    C.edge_v_y[(by + y) * w4 + bx + xi] = (int8_t)twl4c;
            for (int yi = th; yi < bh4; yi += th)
                for (int x = 0; x < bw4; x++)
                    C.edge_h_y[(by + yi) * w4 + bx + x] = (int8_t)thl4c;
            for (int y = 0; y < bh4; y++)
                for (int x = 0; x < bw4; x++) {
                    C.txw_map[(by + y) * C.mstride + bx + x] =
                        (uint8_t)twl4c;
                    C.txh_map[(by + y) * C.mstride + bx + x] =
                        (uint8_t)thl4c;
                }
        } else {
            // dav1d lf_mask.c mask_edges_inter:82 (dense formulation)
            static thread_local int32_t txw[32][32], txh[32][32],
                stepw[32][32], steph[32][32];
            for (int y = 0; y < 32; y++)
                for (int x = 0; x < 32; x++)
                    txw[y][x] = txh[y][x] = stepw[y][x] = steph[y][x] = 0;
            const uint8_t *ytd = C.txfm_dim + b[B_MAX_YTX] * 8;
            const int yw = ytd[0], yh = ytd[1];
            const int masks[2] = {b[B_TX_SPLIT0], b[B_TX_SPLIT1]};
            for (int yy = 0, y_off = 0; yy < bh4; yy += yh, y_off++)
                for (int xx = 0, x_off = 0; xx < bw4; xx += yw, x_off++)
                    decomp_tx(C, txw, txh, stepw, steph, b[B_MAX_YTX], 0,
                              y_off, x_off, masks, yy, xx);
            for (int y = 0; y < bh4; y++)
                C.edge_v_y[(by + y) * w4 + bx] =
                    (int8_t)std::min(txw[y][0], C.l_y(by + y, bx));
            for (int x = 0; x < bw4; x++)
                C.edge_h_y[by * w4 + bx + x] =
                    (int8_t)std::min(txh[0][x], C.a_y(by, bx + x));
            if (!b[B_SKIP]) {
                for (int y = 0; y < bh4; y++) {
                    int ltx = txw[y][0];
                    int step = stepw[y][0];
                    for (int x = step; x < bw4;) {
                        const int rtx = txw[y][x];
                        C.edge_v_y[(by + y) * w4 + bx + x] =
                            (int8_t)std::min(rtx, ltx);
                        ltx = rtx;
                        step = stepw[y][x];
                        x += step;
                    }
                }
                for (int x = 0; x < bw4; x++) {
                    int ttx = txh[0][x];
                    int step = steph[0][x];
                    for (int y = step; y < bh4;) {
                        const int btx = txh[y][x];
                        C.edge_h_y[(by + y) * w4 + bx + x] =
                            (int8_t)std::min(ttx, btx);
                        ttx = btx;
                        step = steph[y][x];
                        y += step;
                    }
                }
            }
            for (int y = 0; y < bh4; y++)
                for (int x = 0; x < bw4; x++) {
                    C.txw_map[(by + y) * C.mstride + bx + x] =
                        (uint8_t)txw[y][x];
                    C.txh_map[(by + y) * C.mstride + bx + x] =
                        (uint8_t)txh[y][x];
                }
        }

        if (C.mono) continue;
        const int full_bw4 = bdm[0], full_bh4 = bdm[1];
        const int has_chroma = (full_bw4 > C.ss_hor || (bx & 1)) &&
                               (full_bh4 > C.ss_ver || (by & 1));
        if (!has_chroma) continue;
        const int cbx = bx >> C.ss_hor, cby = by >> C.ss_ver;
        const int cbw4 =
            std::min(cw4 - cbx, (full_bw4 + C.ss_hor) >> C.ss_hor);
        const int cbh4 =
            std::min(ch4 - cby, (full_bh4 + C.ss_ver) >> C.ss_ver);
        if (cbw4 <= 0 || cbh4 <= 0) continue;
        const uint8_t *utd = C.txfm_dim + b[B_UVTX] * 8;
        const int ctw = utd[0], cth = utd[1];
        const int ctwl4c = utd[2] ? 1 : 0;
        const int cthl4c = utd[3] ? 1 : 0;

        for (int y = cby; y < cby + cbh4; y++)
            for (int x = cbx; x < cbx + cbw4; x++) {
                C.lvl_uv[(y * cw4 + x) * 2 + 0] = (uint8_t)b[B_LF2];
                C.lvl_uv[(y * cw4 + x) * 2 + 1] = (uint8_t)b[B_LF3];
            }
        for (int y = 0; y < cbh4; y++)
            C.edge_v_uv[(cby + y) * cw4 + cbx] =
                (int8_t)std::min(ctwl4c, C.l_uv(cby + y, cbx));
        for (int x = 0; x < cbw4; x++)
            C.edge_h_uv[cby * cw4 + cbx + x] =
                (int8_t)std::min(cthl4c, C.a_uv(cby, cbx + x));
        if (b[B_INTRA] || !b[B_SKIP]) {  // mask_edges_chroma skip_inter
            for (int xi = ctw; xi < cbw4; xi += ctw)
                for (int y = 0; y < cbh4; y++)
                    C.edge_v_uv[(cby + y) * cw4 + cbx + xi] =
                        (int8_t)ctwl4c;
            for (int yi = cth; yi < cbh4; yi += cth)
                for (int x = 0; x < cbw4; x++)
                    C.edge_h_uv[(cby + yi) * cw4 + cbx + x] =
                        (int8_t)cthl4c;
        }
        for (int y = 0; y < cbh4; y++)
            for (int x = 0; x < cbw4; x++) {
                C.ctxw_map[(cby + y) * C.cmstride + cbx + x] =
                    (uint8_t)ctwl4c;
                C.ctxh_map[(cby + y) * C.cmstride + cbx + x] =
                    (uint8_t)cthl4c;
            }
    }
}
