// Copied from dav1d_mirror_tpu/native/msac.cpp.
// Native host entropy stage: AV1 multi-symbol adaptive range decoder.
//
// This is the inherently serial hot loop of the decoder (the reference
// spends 50-70% of single-thread time here); the TPU framework keeps it
// on the host as native code, exposed through a C ABI consumed via
// ctypes (host/native.py). Semantics are bit-exact with the Python
// behavioral spec in host/msac.py (itself verified against the reference
// decoder), i.e. the AV1/daala entropy coder: 15-bit probabilities,
// EC_PROB_SHIFT=6, EC_MIN_PROB=4, 64-bit window, CDF adaptation per
// dav1d src/msac.c:154-163.
//
// The coefficient-block decode loop (dav1d src/recon_tmpl.c
// decode_coefs:321 onward — the eob/token/sign/dequant walk, by far the
// densest symbol stream) is also implemented here so Python makes ONE
// FFI call per transform block instead of ~10^2 per-symbol calls.
// Behavioral spec: host/tilecoder.py _decode_coefs (eob decode onward)
// and _ac_loop.

#include "ec.h"

#define API extern "C" __attribute__((visibility("default")))

using ec::Msac;
using ec::refill;
using ec::norm;
using ec::bool_equi;
using ec::bool_prob;
using ec::bool_adapt;
using ec::symbol_adapt;
using ec::hi_tok;
using ec::bools;
using ec::golomb;
using ec::inv_recenter;


API size_t msac_sizeof(void) { return sizeof(Msac); }

API void msac_init(Msac *s, const uint8_t *buf, size_t sz,
                   int disable_cdf_update) {
    s->buf = buf;
    s->pos = 0;
    s->end = sz;
    s->dif = 0;
    s->rng = 0x8000;
    s->cnt = -15;
    s->allow_update_cdf = !disable_cdf_update;
    refill(s);
}

API unsigned msac_decode_bool_equi(Msac *s) { return bool_equi(s); }
API unsigned msac_decode_bool(Msac *s, unsigned f) {
    return bool_prob(s, f);
}
API unsigned msac_decode_bool_adapt(Msac *s, uint16_t *cdf) {
    return bool_adapt(s, cdf);
}
API unsigned msac_decode_symbol_adapt(Msac *s, uint16_t *cdf, unsigned n) {
    return symbol_adapt(s, cdf, n);
}
API unsigned msac_decode_hi_tok(Msac *s, uint16_t *cdf) {
    return hi_tok(s, cdf);
}
API unsigned msac_decode_bools(Msac *s, unsigned n) { return bools(s, n); }
API unsigned msac_decode_golomb(Msac *s) { return golomb(s); }

API int msac_decode_subexp(Msac *s, int ref, int n, unsigned k) {
    unsigned a = 0;
    if (bool_equi(s)) {
        if (bool_equi(s)) k += bool_equi(s) + 1;
        a = 1u << k;
    }
    const unsigned v = bools(s, k) + a;
    if (ref * 2 <= n) return (int)inv_recenter(ref, v);
    return n - 1 - (int)inv_recenter(n - 1 - ref, v);
}

API uint32_t msac_get_rng(const Msac *s) { return s->rng; }
API int msac_get_cnt(const Msac *s) { return s->cnt; }
API uint64_t msac_get_dif(const Msac *s) { return s->dif; }
API size_t msac_get_pos(const Msac *s) { return s->pos; }

// ---------------------------------------------------------------------
// Coefficient-block decode: everything in tilecoder._decode_coefs from
// the eob-bin symbol to the dequantised output (skip + txtp selection
// stay in Python — they are a handful of symbols with richly-indexed
// CDFs). CDF pointers are raw views into the tile's numpy-backed
// CdfContext (all uint16, contiguous) so adaptation is shared.
//
// tx_class: 0 = 2D, 1 = H, 2 = V (tilecoder TX_CLASS_*).
// Returns cf_ctx (min(cul_level,63) | dc_sign_level); writes eob.
// ---------------------------------------------------------------------

API int coef_decode_block(
    Msac *s,
    // CDFs (rows/bases into CdfContext.coef, uint16):
    uint16_t *eob_bin_cdf, int eob_bin_count,   // selected row; 4+tx2dszctx
    uint16_t *eob_hi_bit_cdf,                   // [t_ctx][chroma] base, stride 2
    uint16_t *eob_base_cdf,                     // [t_ctx][chroma] base, stride 4
    uint16_t *base_cdf,                         // [t_ctx][chroma] base, stride 4
    uint16_t *br_cdf,                           // [min(t_ctx,3)][chroma], stride 4
    uint16_t *dc_sign_cdf,                      // selected row
    // geometry / tables:
    int tx_class, int sw4, int sh4, int lw, int lh,
    const uint16_t *scan,                       // 2D class only, else null
    const uint8_t *lo_ctx_offsets,              // 2D class 5x5 row, else null
    // dequant:
    int32_t dq_dc, int32_t dq_ac,
    const uint8_t *qm,                          // per-coef weights or null
    int dq_shift, int32_t cf_max,
    // outputs:
    int32_t *cf_out,                            // 4*sw4*4*sh4, dav1d layout
    int32_t *eob_out)
{
    // eob (tilecoder.py:2540-2547)
    const int eob_bin = symbol_adapt(s, eob_bin_cdf, eob_bin_count);
    int eob;
    if (eob_bin > 1) {
        const int hi = bool_adapt(s, eob_hi_bit_cdf + 2 * eob_bin);
        eob = ((hi | 2) << (eob_bin - 2)) | (int)bools(s, eob_bin - 2);
    } else {
        eob = eob_bin;
    }
    *eob_out = eob;

    const int n_coef = (4 * sw4) * (4 * sh4);
    int32_t cf_tok[32 * 32];
    memset(cf_tok, 0, sizeof(int32_t) * n_coef);

    int rc = 0, dc_tok = 0;

    if (eob) {
        int stride, shift, shift2, mask, lvl_rows;
        if (tx_class == 0) {
            stride = 4 * sh4;
            shift = (lh < 4) ? lh + 2 : 5;
            shift2 = 0;
            mask = 4 * sh4 - 1;
            lvl_rows = 4 * sw4 + 2;
        } else if (tx_class == 1) {
            stride = 16;
            shift = lh + 2;
            shift2 = 0;
            mask = 4 * sh4 - 1;
            lvl_rows = 4 * sh4 + 2;
        } else {
            stride = 16;
            shift = lw + 2;
            shift2 = lh + 2;
            mask = 4 * sw4 - 1;
            lvl_rows = 4 * sw4 + 2;
        }
        uint8_t levels[36 * 36];
        memset(levels, 0, stride * lvl_rows);

        int ctx = 1 + (eob > sw4 * sh4 * 2) + (eob > sw4 * sh4 * 4);
        const int eob_tok = symbol_adapt(s, eob_base_cdf + 4 * ctx, 2);
        int tok = eob_tok + 1;
        int level_tok = tok * 0x41;

        int x, y;
        if (tx_class == 0) {
            rc = scan[eob];
            x = rc >> shift;
            y = rc & mask;
        } else if (tx_class == 1) {
            x = eob & mask;
            y = eob >> shift;
            rc = eob;
        } else {
            x = eob & mask;
            y = eob >> shift;
            rc = (x << shift2) | y;
        }
        if (eob_tok == 2) {
            ctx = ((tx_class == 0) ? ((x | y) > 1) : (y != 0)) ? 14 : 7;
            tok = hi_tok(s, br_cdf + 4 * ctx);
            level_tok = tok + (3 << 6);
        }
        cf_tok[rc] = tok << 11;
        levels[x * stride + y] = (uint8_t)level_tok;

        for (int i = eob - 1; i > 0; i--) {
            int rc_i;
            if (tx_class == 0) {
                rc_i = scan[i];
                x = rc_i >> shift;
                y = rc_i & mask;
            } else if (tx_class == 1) {
                x = i & mask;
                y = i >> shift;
                rc_i = i;
            } else {
                x = i & mask;
                y = i >> shift;
                rc_i = (x << shift2) | y;
            }
            uint8_t *lo = &levels[x * stride + y];
            int mag = lo[1] + lo[stride];
            int hi_mag, offset;
            if (tx_class == 0) {
                mag += lo[stride + 1];
                hi_mag = mag;
                mag += lo[2] + lo[2 * stride];
                offset = lo_ctx_offsets[(y > 4 ? 4 : y) * 5 +
                                        (x > 4 ? 4 : x)];
            } else {
                mag += lo[2];
                hi_mag = mag;
                mag += lo[3] + lo[4];
                offset = 26 + (y > 1 ? 10 : y * 5);
            }
            ctx = offset + (mag > 512 ? 4 : (mag + 64) >> 7);
            const int yy = (tx_class == 0) ? (y | x) : y;
            tok = symbol_adapt(s, base_cdf + 4 * ctx, 3);
            if (tok == 3) {
                mag = hi_mag & 63;
                ctx = ((yy > ((tx_class == 0) ? 1 : 0)) ? 14 : 7) +
                      (mag > 12 ? 6 : (mag + 1) >> 1);
                tok = hi_tok(s, br_cdf + 4 * ctx);
                *lo = (uint8_t)(tok + (3 << 6));
                cf_tok[rc_i] = (tok << 11) | rc;
                rc = rc_i;
            } else {
                *lo = (uint8_t)(tok * 0x41);
                if (tok) {
                    cf_tok[rc_i] = (tok << 11) | rc;
                    rc = rc_i;
                }
            }
        }

        // dc (tilecoder.py:2654-2672)
        int mag = 0, hi_mag = 0;
        if (tx_class == 0) {
            ctx = 0;
        } else {
            mag = levels[1] + levels[stride] + levels[2];
            hi_mag = mag;
            mag += levels[3] + levels[4];
            ctx = 26 + (mag > 512 ? 4 : (mag + 64) >> 7);
        }
        dc_tok = symbol_adapt(s, base_cdf + 4 * ctx, 3);
        if (dc_tok == 3) {
            if (tx_class == 0)
                mag = levels[1] + levels[stride] + levels[stride + 1];
            else
                mag = hi_mag;
            mag &= 63;
            ctx = mag > 12 ? 6 : (mag + 1) >> 1;
            dc_tok = hi_tok(s, br_cdf + 4 * ctx);
        }
    } else {
        const int tok_br = symbol_adapt(s, eob_base_cdf, 2);
        dc_tok = 1 + tok_br;
        if (tok_br == 2) dc_tok = hi_tok(s, br_cdf);
        rc = 0;
    }

    // dequant (tilecoder.py:2680-2722 + _ac_loop)
    int64_t cul_level = 0;
    int dc_sign_level = 1 << 6;
    if (dc_tok) {
        const int dc_sign = bool_adapt(s, dc_sign_cdf);
        int64_t dc_dq = dq_dc;
        dc_sign_level = (dc_sign - 1) & (2 << 6);
        if (qm) dc_dq = (dc_dq * qm[0] + 16) >> 5;
        int64_t tok_v = dc_tok;
        if (dc_tok == 15) {
            tok_v = (golomb(s) + 15) & 0xFFFFF;
            dc_dq = (dc_dq * tok_v) & 0xFFFFFF;
        } else {
            dc_dq *= tok_v;
        }
        cul_level = tok_v;
        dc_dq >>= dq_shift;
        if (dc_dq > (int64_t)cf_max + dc_sign)
            dc_dq = (int64_t)cf_max + dc_sign;
        cf_out[0] = dc_sign ? (int32_t)-dc_dq : (int32_t)dc_dq;
    }
    while (rc) {
        const int sign = bool_equi(s);
        const int rc_tok = cf_tok[rc];
        int64_t dq = qm ? ((int64_t)dq_ac * qm[rc] + 16) >> 5 : dq_ac;
        int64_t tok_v;
        if (rc_tok >= (15 << 11)) {
            tok_v = (golomb(s) + 15) & 0xFFFFF;
            dq = (dq * tok_v) & 0xFFFFFF;
        } else {
            tok_v = rc_tok >> 11;
            dq *= tok_v;
        }
        cul_level += tok_v;
        dq >>= dq_shift;
        if (dq > (int64_t)cf_max + sign) dq = (int64_t)cf_max + sign;
        cf_out[rc] = sign ? (int32_t)-dq : (int32_t)dq;
        rc = rc_tok & 0x3FF;
    }
    return (int)(cul_level > 63 ? 63 : cul_level) | dc_sign_level;
}
