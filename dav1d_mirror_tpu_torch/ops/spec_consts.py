"""Spec constants this package uses from the JAX package's numpy
references (``dav1d_mirror_tpu/ops/ref/``), copied name by name:

- ``clip_ranges`` from ``ops/ref/itx.py``;
- ``FILTER_INTRA_TAPS`` from ``ops/ref/ipred.py``;
- ``calc_eih`` from ``ops/ref/loopfilter.py``;
- ``CDEF_DIRECTIONS`` from ``ops/ref/cdef.py``;
- the loop restoration constants (``LR_HAVE_*``, ``RESTORATION_*``,
  ``SGR_PARAMS``, ``SGR_X_BY_X``) from ``ops/ref/looprestoration.py``.
"""
from __future__ import annotations

import numpy as np

from ..data.tables import TABLES


def clip_ranges(bitdepth: int):
    """(row_min, row_max, col_min, col_max) intermediate clip bounds."""
    if bitdepth == 8:
        return -32768, 32767, -32768, 32767
    bd_max = (1 << bitdepth) - 1
    row_min = -((bd_max + 1) << 7)
    col_min = -((bd_max + 1) << 5)
    return row_min, ~row_min, col_min, ~col_min


def _deinterleave_filter_taps():
    """The extracted dav1d_filter_intra_taps is in the x86-interleaved
    layout (tables.c F() macro); convert to canonical (5, 8 px, 7 taps)."""
    raw = TABLES["filter_intra_taps"].astype(np.int32)  # [5][64]
    out = np.zeros((5, 8, 7), np.int32)
    for f in range(5):
        for k in range(8):
            out[f, k] = [raw[f, 2 * k], raw[f, 2 * k + 1],
                         raw[f, 16 + 2 * k], raw[f, 16 + 2 * k + 1],
                         raw[f, 32 + 2 * k], raw[f, 32 + 2 * k + 1],
                         raw[f, 48 + 2 * k]]
    return out


FILTER_INTRA_TAPS = _deinterleave_filter_taps()  # (5, 8, 7)


def calc_eih(sharpness: int):
    """E/I lookup per level (dav1d src/lf_mask.c:412 dav1d_calc_eih)."""
    i_lut = np.zeros(64, np.int32)
    e_lut = np.zeros(64, np.int32)
    for level in range(64):
        limit = level
        if sharpness > 0:
            limit >>= (sharpness + 3) >> 2
            limit = min(limit, 9 - sharpness)
        limit = max(limit, 1)
        i_lut[level] = limit
        e_lut[level] = 2 * (level + 2) + limit
    return e_lut, i_lut


_DIRS_RAW = TABLES["cdef_directions"]  # [12][2], off = dy*12 + dx

CDEF_DIRECTIONS = []
for _k in range(12):
    _pair = []
    for _p in range(2):
        _off = int(_DIRS_RAW[_k][_p])
        _dy = (_off + 6) // 12
        _pair.append((_dy, _off - 12 * _dy))
    CDEF_DIRECTIONS.append(_pair)


SGR_PARAMS = TABLES["sgr_params"]        # [16][2]
SGR_X_BY_X = TABLES["sgr_x_by_x"]        # [256]

LR_HAVE_LEFT, LR_HAVE_RIGHT, LR_HAVE_TOP, LR_HAVE_BOTTOM = 1, 2, 4, 8

RESTORATION_NONE = 0
RESTORATION_WIENER = 2
RESTORATION_SGRPROJ = 3
