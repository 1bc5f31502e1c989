// Copied from dav1d_mirror_tpu/native/ipred.cpp.
// Native inner loops for the directional intra predictors (Z1/Z2/Z3).
//
// Edge preparation (upsample/filter, the spec-table lookups) stays in
// Python (ops/ref/ipred.py — the verified spec); these are the per-pixel
// interpolation walks (dav1d src/ipred_tmpl.c ipred_z1/z2/z3_c:408-542),
// which dominate the host intra reconstruction time in Python.

#include <cstdint>

#define API extern "C" __attribute__((visibility("default")))

API void ipred_z1_loop(const int32_t *top, int max_base_x, int dx,
                       int base_inc, int w, int h, int32_t *out) {
    for (int y = 0; y < h; y++) {
        int xpos = dx * (y + 1);
        int frac = xpos & 0x3E;
        int base = xpos >> 6;
        int32_t *row = out + (int64_t)y * w;
        for (int x = 0; x < w; x++) {
            if (base < max_base_x) {
                int v = top[base] * (64 - frac) + top[base + 1] * frac;
                row[x] = (v + 32) >> 6;
                base += base_inc;
            } else {
                for (; x < w; x++) row[x] = top[max_base_x];
                break;
            }
        }
    }
}

API void ipred_z2_loop(const int32_t *edge_c /* centered */, int dx,
                       int dy, int upsample_above, int upsample_left,
                       int w, int h, int32_t *out) {
    const int base_inc_x = 1 + upsample_above;
    const int left_off = -(1 + upsample_left);
    for (int y = 0; y < h; y++) {
        int xpos = ((1 + upsample_above) << 6) - dx * (y + 1);
        int base_x = xpos >> 6;
        const int frac_x = xpos & 0x3E;
        int ypos = (y << (6 + upsample_left)) - dy;
        int32_t *row = out + (int64_t)y * w;
        for (int x = 0; x < w; x++) {
            int v;
            if (base_x >= 0) {
                v = edge_c[base_x] * (64 - frac_x) +
                    edge_c[base_x + 1] * frac_x;
            } else {
                const int base_y = ypos >> 6;
                const int frac_y = ypos & 0x3E;
                v = edge_c[left_off - base_y] * (64 - frac_y) +
                    edge_c[left_off - (base_y + 1)] * frac_y;
            }
            row[x] = (v + 32) >> 6;
            base_x += base_inc_x;
            ypos -= dy;
        }
    }
}

API void ipred_z3_loop(const int32_t *left_c /* at left_c index */,
                       int max_base_y, int dy, int base_inc, int w,
                       int h, int32_t *out) {
    for (int x = 0; x < w; x++) {
        int ypos = dy * (x + 1);
        int frac = ypos & 0x3E;
        int base = ypos >> 6;
        for (int y = 0; y < h; y++) {
            if (base < max_base_y) {
                int v = left_c[-base] * (64 - frac) +
                        left_c[-(base + 1)] * frac;
                out[(int64_t)y * w + x] = (v + 32) >> 6;
                base += base_inc;
            } else {
                for (; y < h; y++)
                    out[(int64_t)y * w + x] = left_c[-max_base_y];
                break;
            }
        }
    }
}
