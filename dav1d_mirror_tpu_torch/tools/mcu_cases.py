"""Seeded synthetic inputs of the unit MC kernels (``csrc/mc_units.cu``,
``csrc/mc_scaled.cu``) and their plain versions (``ops/mc.py``
``mc_units_plane`` / ``mc_units_slots`` / ``mc_scaled_plane`` /
``mc_scaled_slots``): descriptor rows, destination origins on a unit grid
and the planner's pad rows, as numpy int32 arrays from a numpy
``Generator``. ``tests/test_torch_mc_units.py`` holds the plain versions
to the JAX package on them; ``chip_smoke.py`` holds the kernels to the
plain versions on them."""
from __future__ import annotations

import numpy as np

from ..ops.mc import PAD_OOB


def unit_rows(rng, n, refs_shape, uw, uh):
    """(n, 6) translational rows (ref, oy, ox, mx, my, f2d): every
    Filter2d in the first nine rows, subpel 1..15, window origins far
    above, left of, below and right of an (r, h, w) reference stack."""
    r, h, w = refs_shape
    f2d = rng.integers(0, 9, n)
    f2d[:min(n, 9)] = np.arange(min(n, 9))
    oy = rng.integers(-uh - 40, h + 30, n)
    ox = rng.integers(-uw - 40, w + 30, n)
    return np.stack([rng.integers(0, r, n), oy, ox, rng.integers(1, 16, n),
                     rng.integers(1, 16, n), f2d], 1).astype(np.int32)


def grid_origins(rng, n, uw, uh, H, W, pads=2):
    """(ys, xs) of n units: n - pads disjoint origins on the unit grid of
    an (H, W) plane plus the row and column past its edge (units cut by
    the edge), then `pads` pad rows (PAD_OOB) repeating the last real
    unit's column."""
    gy, gx = H // uh + 1, W // uw + 1
    cells = rng.permutation(gy * gx)[:n - pads]
    ys = np.concatenate([cells // gx * uh, [PAD_OOB] * pads])
    xs = np.concatenate([cells % gx * uw, [cells[-1] % gx * uw] * pads])
    return ys.astype(np.int32), xs.astype(np.int32)


def scaled_rows(rng, n, refs_shape, uw, uh):
    """(n, 9) scaled rows (ref, top, left, mxf, myf, dx, dy, f2d, pad):
    steps 512..2048, with whole subpel-0 units (dx = dy = 1024 from phase
    < 64), alternating copy columns (dx = 1536 from phase 0) and random
    ones; every Filter2d; windows far outside the reference."""
    r, h, w = refs_shape
    k = np.arange(n)
    dx = np.where(k % 4 == 0, 1024, np.where(
        k % 4 == 1, 1536, rng.integers(512, 2049, n)))
    dy = np.where(k % 4 == 0, 1024, np.where(
        k % 4 == 2, 2048, rng.integers(512, 2049, n)))
    mxf = np.where(k % 4 < 2, rng.integers(0, 64, n), rng.integers(0, 1024, n))
    myf = np.where(k % 4 == 0, rng.integers(0, 64, n),
                   rng.integers(0, 1024, n))
    f2d = rng.integers(0, 9, n)
    f2d[:min(n, 9)] = np.arange(min(n, 9))
    top = rng.integers(-2 * uh - 20, h + 20, n)
    left = rng.integers(-2 * uw - 20, w + 20, n)
    return np.stack([rng.integers(0, r, n), top, left, mxf, myf, dx, dy,
                     f2d, np.zeros(n, int)], 1).astype(np.int32)


def slot_bases(N, bwp, bhp, uw, uh):
    """Flat offsets of every (uw, uh) sub-rect of slots 0..N-2 of an
    (N, bhp, bwp) slot buffer (slot N-1 left for pad rows)."""
    return np.asarray([s * bhp * bwp + sy * bwp + sx for s in range(N - 1)
                       for sy in range(0, bhp, uh)
                       for sx in range(0, bwp, uw)], np.int32)


def pad_dup(a, k=2):
    """The planner's pad rows: k copies of the last row."""
    return np.concatenate([a, np.repeat(a[-1:], k, 0)])
