"""Loop restoration of the PyTorch port (dav1d_mirror_tpu_torch/ops/
looprestoration.py, ops/mc.gather_units) against the JAX package's
pad_stripes_tpu, wiener_batch_tpu, selfguided_batch_tpu, sgr_batch_tpu and
mc_tpu.gather_units on the same numpy inputs, at bit depths 8, 10 and 12.
Tolerance: exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dav1d_mirror_tpu.ops.looprestoration_tpu import (pad_stripes_tpu,
                                                      selfguided_batch_tpu,
                                                      sgr_batch_tpu,
                                                      wiener_batch_tpu)
from dav1d_mirror_tpu.ops.mc_tpu import gather_units as gather_units_jax
from dav1d_mirror_tpu_torch.ops.looprestoration import (pad_stripes,
                                                        selfguided_batch,
                                                        sgr_batch,
                                                        wiener_batch)
from dav1d_mirror_tpu_torch.ops.mc import gather_units
from dav1d_mirror_tpu_torch.ops.spec_consts import SGR_PARAMS, SGR_X_BY_X

BDS = [8, 10, 12]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _wiener_taps(rng, B):
    """(B, 7) symmetric taps from coefficients in the spec's ranges
    (dav1d wiener_taps_min/max), built as the planner builds them."""
    lo, hi = np.array([-5, -23, -17]), np.array([10, 8, 46])
    f3 = rng.integers(lo, hi + 1, (B, 3))
    f = np.zeros((B, 7), np.int32)
    f[:, :3] = f3
    f[:, 4:] = f3[:, ::-1]
    f[:, 3] = 128 - 2 * f3.sum(1)
    return f


@pytest.mark.parametrize("w,h", [(64, 56), (48, 8), (5, 1)])
def test_pad_stripes_matches_jax(w, h):
    """Every LR_HAVE_* mask (B = 16), origins at the plane's edges and
    beyond its bottom (both clamp)."""
    rng = np.random.default_rng(w * 100 + h)
    ph, pw = 80, 120
    pre_lr = rng.integers(0, 1024, (ph, pw)).astype(np.int32)
    pre = rng.integers(0, 1024, (ph, pw)).astype(np.int32)
    edges = np.arange(16, dtype=np.int32)
    xs = rng.integers(0, pw - w + 1, 16).astype(np.int32)
    xs[:3] = [0, pw - w, pw - 1]
    ys = rng.integers(0, ph - h + 1, 16).astype(np.int32)
    ys[:3] = [0, ph - h, ph - 1]
    want = pad_stripes_tpu(jnp.asarray(pre_lr), jnp.asarray(pre),
                           jnp.asarray(xs), jnp.asarray(ys),
                           jnp.asarray(edges), w, h)
    got = pad_stripes(_t(pre_lr), _t(pre), _t(xs), _t(ys), _t(edges), w, h)
    _same(got, want)


@pytest.mark.parametrize("bd", BDS)
def test_wiener_batch_matches_jax(bd):
    rng = np.random.default_rng(bd)
    B, w, h = 8, 20, 12
    padded = rng.integers(0, 1 << bd, (B, h + 6, w + 6)).astype(np.int32)
    padded[0] = np.where(np.indices((h + 6, w + 6)).sum(0) % 2, 0,
                         (1 << bd) - 1)          # max contrast: clips
    fh, fv = _wiener_taps(rng, B), _wiener_taps(rng, B)
    want = wiener_batch_tpu(jnp.asarray(padded), jnp.asarray(fh),
                            jnp.asarray(fv), w, h, bd)
    got = wiener_batch(_t(padded), _t(fh), _t(fv), w, h, bd)
    _same(got, want)


def _strengths(rng, B, n):
    col = 0 if n == 25 else 1
    s = SGR_PARAMS[:, col].astype(np.int32)
    return rng.choice(s[s > 0], B).astype(np.int32)


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("n", [25, 9])
def test_selfguided_batch_matches_jax(bd, n):
    """An odd h: the 5x5 filter's last row takes the even-row form."""
    rng = np.random.default_rng(bd + n)
    B, w, h = 6, 18, 11
    padded = rng.integers(0, 1 << bd, (B, h + 6, w + 6)).astype(np.int32)
    s = _strengths(rng, B, n)
    want = selfguided_batch_tpu(jnp.asarray(padded), jnp.asarray(s), w, h,
                                n, bd)
    got = selfguided_batch(_t(padded), _t(s), w, h, n, bd)
    _same(got, want)


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_sgr_batch_matches_jax(bd, kind):
    rng = np.random.default_rng(bd * 3 + kind)
    B, w, h = 4, 16, 10
    padded = rng.integers(0, 1 << bd, (B, h + 6, w + 6)).astype(np.int32)
    cur = rng.integers(0, 1 << bd, (B, h, w)).astype(np.int32)
    s0 = _strengths(rng, B, 25) * (kind != 1)
    s1 = _strengths(rng, B, 9) * (kind != 0)
    w0 = rng.integers(-96, 32, B).astype(np.int32)
    w1 = rng.integers(-32, 96, B).astype(np.int32)
    want = sgr_batch_tpu(*(jnp.asarray(a) for a in (padded, cur, s0, s1,
                                                     w0, w1)),
                         w, h, bd, kind)
    got = sgr_batch(*(_t(a) for a in (padded, cur, s0, s1, w0, w1)),
                    w, h, bd, kind)
    _same(got, want)


def _unsigned_products(padded, s, n, bd):
    """Largest p * s and x * sum * one_by_x of the self-guided filter on
    these inputs, in int64 (numpy restatement of dav1d's unsigned
    arithmetic, to show the test reaches past int32)."""
    rad = 2 if n == 25 else 1
    win = np.lib.stride_tricks.sliding_window_view(
        padded.astype(np.int64), (2 * rad + 1, 2 * rad + 1), axis=(1, 2))
    sv = win.sum((-1, -2))
    sv2 = (win * win).sum((-1, -2))
    bd_m8 = bd - 8
    a = (sv2 + ((1 << (2 * bd_m8)) >> 1)) >> (2 * bd_m8)
    b = (sv + ((1 << bd_m8) >> 1)) >> bd_m8
    p = np.maximum(a * n - b * b, 0)
    ps = p * s[:, None, None]
    z = np.minimum((ps + (1 << 19)) >> 20, 255)
    x = np.asarray(SGR_X_BY_X, np.int64)[z]
    return ps.max(), (x * sv * (164 if n == 25 else 455)).max()


@pytest.mark.parametrize("n", [25, 9])
def test_selfguided_unsigned_products_pass_int32(n):
    """bd 12, the largest strength of each radius (140 at n = 25, 3236 at
    n = 9), a stripe half checkerboard of 0 and 4095 (largest p), half
    flat 4080 (a multiple of 16, so the rounded p is 0 and x is 255: the
    largest x * sum): dav1d's unsigned products exceed 2^31, so an int32
    port wraps here."""
    bd, w, h = 12, 24, 8
    padded = np.full((2, h + 6, w + 6), 4080, np.int32)
    chk = np.indices((h + 6, (w + 6) // 2)).sum(0) % 2 == 0
    padded[:, :, :(w + 6) // 2] = np.where(chk, 0, 4095)
    s = np.full(2, 140 if n == 25 else 3236, np.int32)
    ps, xsv = _unsigned_products(padded, s, n, bd)
    assert xsv > 2 ** 31 and (n == 25 or ps > 2 ** 31), (ps, xsv)
    want = selfguided_batch_tpu(jnp.asarray(padded), jnp.asarray(s), w, h,
                                n, bd)
    got = selfguided_batch(_t(padded), _t(s), w, h, n, bd)
    _same(got, want)


@pytest.mark.parametrize("uh,uw", [(64, 64), (8, 48), (1, 3)])
def test_gather_units_matches_jax(uh, uw):
    rng = np.random.default_rng(uh + uw)
    H, W = 70, 130
    plane = rng.integers(0, 4096, (H, W)).astype(np.int32)
    ys = rng.integers(0, H - uh + 1, 9).astype(np.int32)
    xs = rng.integers(0, W - uw + 1, 9).astype(np.int32)
    ys[0], xs[0] = H - uh, W - uw
    want = gather_units_jax(jnp.asarray(plane), jnp.asarray(ys),
                            jnp.asarray(xs), uh, uw)
    got = gather_units(_t(plane), _t(ys), _t(xs), uh, uw)
    _same(got, want)
