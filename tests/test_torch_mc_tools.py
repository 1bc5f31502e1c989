"""The compound, warp and OBMC ops of the PyTorch port
(dav1d_mirror_tpu_torch/ops/mc.py) against the JAX package's
ops/mc_tpu.py on the same seeded numpy inputs, at bit depths 8, 10 and
12, with 4:2:0, 4:2:2 and 4:4:4 chroma masks, and with pad rows (slot
and row duplicates, PAD_OOB destinations). Tolerance: exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dav1d_mirror_tpu.ops import mc_tpu as jmc
from dav1d_mirror_tpu_torch.ops import mc

BDS = [8, 10, 12]
SUBSAMPLING = [(1, 1), (1, 0), (0, 0)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _prep(rng, bd, shape):
    """Prep-domain intermediates: pixel << ib, minus the 8192 bias above
    8 bit, with filter overshoot on both sides."""
    ib = mc.ibits(bd)
    lo, hi = -(1 << (bd + ib - 3)), (1 << (bd + ib)) + (1 << (bd + ib - 3))
    bias = 0 if bd == 8 else 8192
    return (rng.integers(lo, hi, shape) - bias).astype(np.int32)


@pytest.mark.parametrize("bd", BDS)
def test_avg_w_avg_mask_match_jax(bd):
    rng = np.random.default_rng(bd)
    a, b = _prep(rng, bd, (13, 8, 16)), _prep(rng, bd, (13, 8, 16))
    w = rng.integers(1, 16, (13, 1, 1)).astype(np.int32)
    m = rng.integers(0, 65, (13, 8, 16)).astype(np.int32)
    _eq(mc.avg_batch(_t(a), _t(b), bd), jmc.avg_batch(a, b, bd))
    _eq(mc.w_avg_batch(_t(a), _t(b), _t(w), bd),
        jmc.w_avg_batch(a, b, w, bd))
    _eq(mc.mask_batch(_t(a), _t(b), _t(m), bd),
        jmc.mask_batch(a, b, m, bd))


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("ssh,ssv", SUBSAMPLING)
def test_w_mask_batch_matches_jax(bd, ssh, ssv):
    rng = np.random.default_rng(bd * 7 + ssh * 2 + ssv)
    a, b = _prep(rng, bd, (11, 16, 32)), _prep(rng, bd, (11, 16, 32))
    # near-equal pairs too: the mask's low end (38)
    b[:4] = a[:4] + rng.integers(-3, 4, a[:4].shape).astype(np.int32)
    sign = rng.integers(0, 2, 11).astype(np.int32)
    got = mc.w_mask_batch(_t(a), _t(b), _t(sign), ssh, ssv, bd)
    want = jmc.w_mask_batch(a, b, sign, ssh, ssv, bd)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert tuple(got[1].shape) == (11, 16 >> ssv, 32 >> ssh)


def _join_inputs(rng, bd, N=16, h=8, w=16):
    """Two side batches and a slot list padded as the planner pads it:
    the last real slot repeated, carrying the same sign and weight."""
    t0, t1 = _prep(rng, bd, (N, h, w)), _prep(rng, bd, (N, h, w))
    real = rng.permutation(N - 1)[:5].astype(np.int32)
    sl = np.concatenate([real, np.repeat(real[-1:], 3)]).astype(np.int32)
    sgn_r = rng.integers(0, 2, 5).astype(np.int32)
    sgn = np.concatenate([sgn_r, np.repeat(sgn_r[-1:], 3)]).astype(np.int32)
    w_r = rng.integers(1, 16, 5).astype(np.int32)
    wt = np.concatenate([w_r, np.repeat(w_r[-1:], 3)]).astype(np.int32)
    return t0, t1, sl, sgn, wt


@pytest.mark.parametrize("bd", BDS)
def test_comp_joins_with_pad_slots_match_jax(bd):
    """mc.comp_run on a list of average and distance-weighted rows (the
    join form the tile-sharded decode runs; the frame path's joins are
    held to the JAX joins in tests/test_torch_comp_run.py), against
    comp_join_wavg on the padded slot list: its real slots (the pads
    repeat the last) as rows, each slot joined into its rows of an (N h,
    w) plane that holds the N slots one under another."""
    rng = np.random.default_rng(100 + bd)
    t0, t1, sl, sgn, wt = _join_inputs(rng, bd)
    N, h, w = t0.shape
    out0 = rng.integers(-99, 99, (N, h, w)).astype(np.int32)
    want = jmc.comp_join_wavg(out0, t0, t1, sl, wt[:, None, None], bd)
    real = sl[:5]
    table, work = mc.comp_build_table([dict(
        plane=0, bhp=h, bwp=w, s0=0, s1=5 * h * w, dy=0, dx=5,
        rows=[(mc.CJ_WAVG, k, 0) for k in wt[:5]])])
    assert work == (1, 5, 5 * h * w // mc.COMP_ITEM)
    desc = np.concatenate([real * h, np.zeros(5, np.int32)])
    arena = np.concatenate([t0[real].reshape(-1), t1[real].reshape(-1)])
    plane = _t(out0.copy()).view(N * h, w)
    mc.comp_run(_t(table), work, _t(desc), [plane], _t(arena), bd)
    _eq(plane.view(N, h, w), want)


def test_set_slots_and_scatter_slot_units_match_jax():
    rng = np.random.default_rng(5)
    N, bhp, bwp = 8, 16, 16
    buf = rng.integers(-99, 99, (N, bhp, bwp)).astype(np.int32)
    slots = np.asarray([3, 0, 6, 6, 6], np.int32)
    vals = rng.integers(0, 4096, (5, bhp, bwp)).astype(np.int32)
    vals[3:] = vals[2]
    _eq(mc.set_slots(_t(buf.copy()), _t(slots), _t(vals)),
        jmc.set_slots(buf, slots, vals))
    # 8x8 warp units at sub-rect offsets of slots 1 and 5, the last
    # repeated as pad rows
    base = np.asarray([1 * 256 + 0, 1 * 256 + 8, 1 * 256 + 136,
                       5 * 256 + 128, 5 * 256 + 128, 5 * 256 + 128],
                      np.int32)
    u = rng.integers(0, 4096, (6, 8, 8)).astype(np.int32)
    u[4:] = u[3]
    _eq(mc.scatter_slot_units(_t(buf.copy()), _t(base), _t(u), 8, 8, bwp),
        jmc.scatter_slot_units(buf, base, u, 8, 8, bwp))


def _warp_args(rng, n, H, W):
    """(n, 10) rows as the planner makes them (_warp_rows): phases from a
    position's fractional part minus the shear's centring offset, window
    origins inside and outside the plane; the last rows repeat as pads."""
    al, be, ga, de = (rng.integers(-24, 25, n) * 64 for _ in range(4))
    mx = (rng.integers(0, 1 << 16, n) - al * 4 - be * 7) & ~0x3F
    my = (rng.integers(0, 1 << 16, n) - ga * 4 - de * 4) & ~0x3F
    oy = rng.integers(-20, H + 10, n)
    ox = rng.integers(-20, W + 10, n)
    rows = np.stack([rng.integers(0, 3, n), oy, ox, mx, my, al, be, ga, de,
                     np.zeros(n, np.int64)], 1).astype(np.int32)
    rows[-3:] = rows[-4]
    return rows


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("prep", [False, True])
def test_warp8x8_batch_matches_jax(bd, prep):
    rng = np.random.default_rng(bd * 3 + prep)
    H, W = 40, 56
    refs = rng.integers(0, 1 << bd, (3, H, W)).astype(np.int32)
    rows = _warp_args(rng, 24, H, W)
    _eq(mc.warp8x8_batch(_t(refs), _t(rows), bd, prep),
        jmc.warp8x8_batch(jnp.asarray(refs), jnp.asarray(rows), bd, prep))


@pytest.mark.parametrize("vert", [False, True])
@pytest.mark.parametrize("lap_h,lap_w,region", [(6, 16, 8), (12, 16, 16),
                                                 (16, 8, 8), (4, 2, 2)])
def test_obmc_blend_batch_matches_jax(vert, lap_h, lap_w, region):
    """Top laps (rows) and left laps (columns); pad laps at PAD_OOB."""
    rng = np.random.default_rng(lap_h * 100 + lap_w + vert)
    H, W = 48, 64
    plane = rng.integers(0, 1024, (H, W)).astype(np.int32)
    n = 6
    ys = (rng.integers(0, (H - lap_h) // lap_h, n) * lap_h).astype(np.int32)
    xs = (np.arange(n) * lap_w % (W - lap_w)).astype(np.int32)
    ys[0], xs[0] = H - lap_h, W - lap_w
    ys = np.concatenate([ys, [mc.PAD_OOB] * 2]).astype(np.int32)
    xs = np.concatenate([xs, [0, 0]]).astype(np.int32)
    keep = np.ones(n, bool)
    for i in range(n):      # disjoint laps only, as the planner gives
        for j in range(i):
            if keep[j] and abs(int(ys[i]) - int(ys[j])) < lap_h and \
                    abs(int(xs[i]) - int(xs[j])) < lap_w:
                keep[i] = False
    ys[:n][~keep] = mc.PAD_OOB
    laps = rng.integers(0, 1024, (n + 2, lap_h, lap_w)).astype(np.int32)
    got = mc.obmc_blend_batch(_t(plane.copy()), _t(laps), _t(ys), _t(xs),
                              lap_h, lap_w, region, vert)
    want = jmc.obmc_blend_batch(jnp.asarray(plane), jnp.asarray(laps),
                                jnp.asarray(ys), jnp.asarray(xs), lap_h,
                                lap_w, region, vert)
    _eq(got, want)
    assert not np.array_equal(got.numpy(), plane)
