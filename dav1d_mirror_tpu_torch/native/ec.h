// Copied from dav1d_mirror_tpu/native/ec.h.
// Shared AV1 range-decoder primitives for the native host entropy stage.
//
// Bit-exact with the Python behavioral spec in host/msac.py (itself
// verified against the reference decoder): 15-bit probabilities,
// EC_PROB_SHIFT=6, EC_MIN_PROB=4, 64-bit window, CDF adaptation per
// dav1d src/msac.c:154-163. Included by msac.cpp (per-symbol C ABI +
// coefficient block decode) and tilecoder.cpp (full tile walk).
#pragma once

#include <cstdint>
#include <cstring>

namespace ec {

constexpr int EC_PROB_SHIFT = 6;
constexpr int EC_MIN_PROB = 4;

struct Msac {
    const uint8_t *buf;
    size_t pos, end;
    uint64_t dif;
    uint32_t rng;
    int cnt;
    int allow_update_cdf;
};

inline void refill(Msac *s) {
    int c = 64 - s->cnt - 24;
    uint64_t dif = s->dif;
    size_t pos = s->pos, end = s->end;
    const uint8_t *buf = s->buf;
    for (;;) {
        if (pos >= end) {
            dif |= (1ull << (c + 8)) - 1;
            break;
        }
        dif |= (uint64_t)(buf[pos] ^ 0xFF) << c;
        pos++;
        c -= 8;
        if (c < 0) break;
    }
    s->dif = dif;
    s->cnt = 64 - c - 24;
    s->pos = pos;
}

inline int bitlen(uint32_t v) { return 32 - __builtin_clz(v); }

inline void norm(Msac *s, uint64_t dif, uint32_t rng) {
    const int d = 16 - bitlen(rng);
    s->dif = dif << d;
    s->rng = rng << d;
    const int cnt = s->cnt;
    s->cnt = cnt - d;
    if (cnt < d) refill(s);
}

inline void init(Msac *s, const uint8_t *buf, size_t sz,
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

inline unsigned bool_equi(Msac *s) {
    const uint32_t r = s->rng;
    const uint32_t v = ((r >> 8) << 7) + EC_MIN_PROB;
    const uint64_t vw = (uint64_t)v << 48;
    if (s->dif >= vw) {
        norm(s, s->dif - vw, r - v);
        return 0;
    }
    norm(s, s->dif, v);
    return 1;
}

inline unsigned bool_prob(Msac *s, unsigned f) {
    const uint32_t r = s->rng;
    const uint32_t v = (((r >> 8) * (f >> EC_PROB_SHIFT))
                        >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB;
    const uint64_t vw = (uint64_t)v << 48;
    if (s->dif >= vw) {
        norm(s, s->dif - vw, r - v);
        return 0;
    }
    norm(s, s->dif, v);
    return 1;
}

inline unsigned bool_adapt(Msac *s, uint16_t *cdf) {
    const unsigned bit = bool_prob(s, cdf[0]);
    if (s->allow_update_cdf) {
        const unsigned count = cdf[1];
        const int rate = 4 + (count >> 4);
        if (bit)
            cdf[0] = cdf[0] + ((32768 - cdf[0]) >> rate);
        else
            cdf[0] = cdf[0] - (cdf[0] >> rate);
        cdf[1] = count + (count < 32);
    }
    return bit;
}

inline unsigned symbol_adapt(Msac *s, uint16_t *cdf, unsigned n_symbols) {
    const uint32_t c = (uint32_t)(s->dif >> 48);
    const uint32_t r = s->rng >> 8;
    uint32_t u, v = s->rng;
    unsigned val = (unsigned)-1;
    do {
        val++;
        u = v;
        v = (r * (cdf[val] >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT);
        v += EC_MIN_PROB * (n_symbols - val);
    } while (c < v);
    norm(s, s->dif - ((uint64_t)v << 48), u - v);
    if (s->allow_update_cdf) {
        const unsigned count = cdf[n_symbols];
        const int rate = 4 + (count >> 4) + (n_symbols > 2);
        unsigned i = 0;
        for (; i < val; i++) cdf[i] = cdf[i] + ((32768 - cdf[i]) >> rate);
        for (; i < n_symbols; i++) cdf[i] = cdf[i] - (cdf[i] >> rate);
        cdf[n_symbols] = count + (count < 32);
    }
    return val;
}

inline unsigned hi_tok(Msac *s, uint16_t *cdf) {
    unsigned tok_br = symbol_adapt(s, cdf, 3);
    unsigned tok = 3 + tok_br;
    if (tok_br == 3) {
        tok_br = symbol_adapt(s, cdf, 3);
        tok = 6 + tok_br;
        if (tok_br == 3) {
            tok_br = symbol_adapt(s, cdf, 3);
            tok = 9 + tok_br;
            if (tok_br == 3) tok = 12 + symbol_adapt(s, cdf, 3);
        }
    }
    return tok;
}

inline unsigned bools(Msac *s, unsigned n) {
    unsigned v = 0;
    while (n--) v = (v << 1) | bool_equi(s);
    return v;
}

// host/tilecoder.py DecodeSide.golomb (dav1d msac.h decode_golomb).
inline unsigned golomb(Msac *s) {
    int len = 0;
    while (!bool_equi(s) && len < 32) len++;
    unsigned v = 1;
    while (len--) v = (v << 1) + bool_equi(s);
    return v - 1;
}

inline unsigned inv_recenter(unsigned r, unsigned v) {
    if (v > (r << 1)) return v;
    if ((v & 1) == 0) return (v >> 1) + r;
    return r - ((v + 1) >> 1);
}

inline int subexp(Msac *s, int ref, int n, unsigned k) {
    unsigned a = 0;
    if (bool_equi(s)) {
        if (bool_equi(s)) k += bool_equi(s) + 1;
        a = 1u << k;
    }
    const unsigned v = bools(s, k) + a;
    if (ref * 2 <= n) return (int)inv_recenter(ref, v);
    return n - 1 - (int)inv_recenter(n - 1 - ref, v);
}

// dav1d_msac_decode_uniform (msac.h): ns(n) over the arithmetic coder.
inline unsigned uniform(Msac *s, unsigned n) {
    const int ln = bitlen(n - 1);
    const unsigned m = (1u << ln) - n;
    const unsigned v = bools(s, ln - 1);
    return v < m ? v : (v << 1) - m + bool_equi(s);
}

}  // namespace ec
