# Copied from dav1d_mirror_tpu/ops/ref/filmgrain.py (constants, _rand,
# _round2, generate_grain_y, generate_grain_uv, generate_scaling,
# _row_seeds).
"""Film grain synthesis, the host part (numpy, bit-exact).

The sequential pieces of AV1 film grain (spec 7.18.3.3, dav1d
src/filmgrain_tmpl.c generate_grain_y/uv_c and src/fg_apply_tmpl.c
generate_scaling): the auto-regressive grain LUTs (82x73 values), the
piecewise-linear scaling tables and the per-row LFSR seeds. They are
tiny and stay on the host; ops/filmgrain.py applies the grain on the
device.
"""
from __future__ import annotations

import numpy as np

from ..data.tables import TABLES

GAUSSIAN = TABLES["gaussian_sequence"].astype(np.int32)  # [2048]
GRAIN_WIDTH, GRAIN_HEIGHT = 82, 73
SUB_GRAIN_WIDTH, SUB_GRAIN_HEIGHT = 44, 38
FG_BLOCK_SIZE = 32


def _rand(state, bits):
    r = state
    bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
    state = (r >> 1) | (bit << 15)
    return state, (state >> (16 - bits)) & ((1 << bits) - 1)


def _round2(x, shift):
    return (x + ((1 << shift) >> 1)) >> shift


def generate_grain_y(fgd, bitdepth):
    bd_m8 = bitdepth - 8
    seed = fgd.seed
    shift = 4 - bd_m8 + fgd.grain_scale_shift
    grain_ctr = 128 << bd_m8
    gmin, gmax = -grain_ctr, grain_ctr - 1

    buf = np.zeros((GRAIN_HEIGHT, GRAIN_WIDTH), np.int32)
    for y in range(GRAIN_HEIGHT):
        for x in range(GRAIN_WIDTH):
            seed, v = _rand(seed, 11)
            buf[y, x] = _round2(int(GAUSSIAN[v]), shift)

    lag = fgd.ar_coeff_lag
    pad = 3
    coeffs = fgd.ar_coeffs_y
    for y in range(pad, GRAIN_HEIGHT):
        for x in range(pad, GRAIN_WIDTH - pad):
            s = 0
            ci = 0
            for dy in range(-lag, 1):
                for dx in range(-lag, lag + 1):
                    if dx == 0 and dy == 0:
                        break
                    s += int(coeffs[ci]) * int(buf[y + dy, x + dx])
                    ci += 1
            g = int(buf[y, x]) + _round2(s, fgd.ar_coeff_shift)
            buf[y, x] = max(gmin, min(gmax, g))
    return buf


def generate_grain_uv(fgd, buf_y, uv, subx, suby, bitdepth):
    bd_m8 = bitdepth - 8
    seed = fgd.seed ^ (0x49D8 if uv else 0xB524)
    shift = 4 - bd_m8 + fgd.grain_scale_shift
    grain_ctr = 128 << bd_m8
    gmin, gmax = -grain_ctr, grain_ctr - 1
    cw = SUB_GRAIN_WIDTH if subx else GRAIN_WIDTH
    ch = SUB_GRAIN_HEIGHT if suby else GRAIN_HEIGHT

    buf = np.zeros((GRAIN_HEIGHT + 1, GRAIN_WIDTH), np.int32)
    for y in range(ch):
        for x in range(cw):
            seed, v = _rand(seed, 11)
            buf[y, x] = _round2(int(GAUSSIAN[v]), shift)

    lag = fgd.ar_coeff_lag
    pad = 3
    coeffs = fgd.ar_coeffs_uv[uv]
    for y in range(pad, ch):
        for x in range(pad, cw - pad):
            s = 0
            ci = 0
            done = False
            for dy in range(-lag, 1):
                if done:
                    break
                for dx in range(-lag, lag + 1):
                    if dx == 0 and dy == 0:
                        if not fgd.num_y_points:
                            done = True
                            break
                        luma = 0
                        lx = ((x - pad) << subx) + pad
                        ly = ((y - pad) << suby) + pad
                        for i in range(suby + 1):
                            for j in range(subx + 1):
                                luma += int(buf_y[ly + i, lx + j])
                        luma = _round2(luma, subx + suby)
                        s += luma * int(coeffs[ci])
                        done = True
                        break
                    s += int(coeffs[ci]) * int(buf[y + dy, x + dx])
                    ci += 1
            g = int(buf[y, x]) + _round2(s, fgd.ar_coeff_shift)
            buf[y, x] = max(gmin, min(gmax, g))
    return buf


def generate_scaling(bitdepth, points, num):
    shift_x = 0 if bitdepth == 8 else bitdepth - 8
    size = 256 if bitdepth == 8 else (1 << bitdepth)
    scaling = np.zeros(size, np.int32)
    if num == 0:
        return scaling
    scaling[:points[0][0] << shift_x] = points[0][1]
    for i in range(num - 1):
        bx, by = points[i]
        ex, ey = points[i + 1]
        dx = ex - bx
        dy = ey - by
        delta = dy * ((0x10000 + (dx >> 1)) // dx)
        d = 0x8000
        for x in range(dx):
            scaling[(bx + x) << shift_x] = by + (d >> 16)
            d += delta
    n = points[num - 1][0] << shift_x
    scaling[n:] = points[num - 1][1]
    if bitdepth > 8:
        pad = 1 << shift_x
        rnd = pad >> 1
        for i in range(num - 1):
            bx = points[i][0] << shift_x
            ex = points[i + 1][0] << shift_x
            for x in range(0, ex - bx, pad):
                rng = int(scaling[bx + x + pad]) - int(scaling[bx + x])
                r = rnd
                for k in range(1, pad):
                    r += rng
                    scaling[bx + x + k] = int(scaling[bx + x]) + (r >> shift_x)
    return scaling


def _row_seeds(fgd, row_num, rows):
    seeds = []
    for i in range(rows):
        s = fgd.seed
        s ^= (((row_num - i) * 37 + 178) & 0xFF) << 8
        s ^= ((row_num - i) * 173 + 105) & 0xFF
        seeds.append(s)
    return seeds
