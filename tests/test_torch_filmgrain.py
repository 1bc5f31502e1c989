"""Film grain of the PyTorch port (dav1d_mirror_tpu_torch/ops/filmgrain.py
over host/filmgrain.py) against the JAX package's ops/filmgrain_tpu.py on
JAX-CPU, on the same numpy inputs: the per-block offset seeds, the blended
grain field, the luma and chroma application, and apply_film_grain on
odd-sized frames in every layout. Tolerance: exact."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))

from dav1d_mirror_tpu.ops import filmgrain_tpu as jfg  # noqa: E402
from dav1d_mirror_tpu_torch.ops import filmgrain as tfg  # noqa: E402
from test_filmgrain_tpu import _mk  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_randvals_and_offsets_match_jax():
    fgd = _mk(seed=777)[2].film_grain_data
    R = tfg.block_randvals(fgd, 5, 7)
    np.testing.assert_array_equal(R, jfg.block_randvals(fgd, 5, 7))
    for sx, sy in ((0, 0), (1, 0), (1, 1)):
        for got, want in zip(tfg._off_maps(R, sx, sy),
                             jfg._off_maps(R, sx, sy)):
            np.testing.assert_array_equal(got, want)


def _offyx(rng, sx, sy, nby, nbx):
    R = rng.integers(0, 256, (nby, nbx)).astype(np.int32)
    oy, ox = tfg._off_maps(R, sx, sy)
    shifted = [np.roll(oy, 1, 1), np.roll(ox, 1, 1)]
    return np.stack([np.stack([oy, ox]), np.stack(shifted),
                     np.stack([np.roll(a, 1, 0) for a in (oy, ox)]),
                     np.stack([np.roll(a, 1, 0) for a in shifted])]
                    ).astype(np.int32)


@pytest.mark.parametrize("sx,sy", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("overlap", [False, True])
def test_fg_blend_grain_matches_jax(sx, sy, overlap):
    """The patch gathers reach past the LUT where the overlap is masked
    out: both clamp."""
    rng = np.random.default_rng(sx * 4 + sy * 2 + overlap)
    gmax = 511
    lut = rng.integers(-gmax - 1, gmax + 1, (74, 82)).astype(np.int32)
    offyx = _offyx(rng, sx, sy, 3, 4)
    bh_step, step = 32 >> sy, 32 >> sx
    want = jfg._fg_blend_grain(jnp.asarray(lut), jnp.asarray(offyx), sx, sy,
                               overlap, bh_step, step, gmax)
    got = tfg._fg_blend_grain(_t(lut), _t(offyx), sx, sy, overlap, bh_step,
                              step, gmax)
    _same(got, want)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("clip", [False, True])
def test_fgy_apply_matches_jax(bd, clip):
    rng = np.random.default_rng(bd + clip)
    gmax = (128 << (bd - 8)) - 1
    src = rng.integers(0, 1 << bd, (40, 64)).astype(np.int32)
    grain = rng.integers(-gmax - 1, gmax + 1, (40, 64)).astype(np.int32)
    scaling = rng.integers(0, 256, 256 if bd == 8 else 1 << bd
                           ).astype(np.int32)
    want = jfg._fgy_apply(jnp.asarray(src), jnp.asarray(grain),
                          jnp.asarray(scaling), 9, bd, clip)
    got = tfg._fgy_apply(_t(src), _t(grain), _t(scaling), 9, bd, clip)
    _same(got, want)


@pytest.mark.parametrize("csfl", [False, True])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("is_id", [False, True])
def test_fguv_apply_matches_jax(csfl, clip, is_id):
    """Chroma at 4:2:0, 4:2:2 and 4:4:4 in turn, bd 8/10/12 in turn."""
    k = csfl * 4 + clip * 2 + is_id
    sx, sy = ((1, 1), (1, 0), (0, 0))[k % 3]
    bd = (8, 10, 12)[k // 3]
    rng = np.random.default_rng(k)
    gmax = (128 << (bd - 8)) - 1
    ch, cw = 24, 32
    src = rng.integers(0, 1 << bd, (ch, cw)).astype(np.int32)
    luma = rng.integers(0, 1 << bd, (ch << sy, cw << sx)).astype(np.int32)
    grain = rng.integers(-gmax - 1, gmax + 1, (ch, cw)).astype(np.int32)
    scaling = rng.integers(0, 256, 256 if bd == 8 else 1 << bd
                           ).astype(np.int32)
    args = (10, bd, clip, is_id, sx, csfl, 45, -20, 37)
    want = jfg._fguv_apply(jnp.asarray(src), jnp.asarray(luma),
                           jnp.asarray(grain), jnp.asarray(scaling), *args)
    got = tfg._fguv_apply(_t(src), _t(luma), _t(grain), _t(scaling), *args)
    _same(got, want)


@pytest.mark.parametrize("kw", [
    dict(bitdepth=8, layout=1),
    dict(bitdepth=10, layout=1, clip=1, mtrx=0),
    dict(bitdepth=12, layout=2, overlap=0),
    dict(bitdepth=10, layout=3, csfl=1),
    dict(bitdepth=8, layout=1, nuv=(0, 2), lag=3, ny=0),
    dict(bitdepth=10, layout=0),
], ids=["420_8", "420_10_clip_id", "422_12_nooverlap", "444_10_csfl",
        "420_8_no_y", "mono_10"])
def test_apply_film_grain_matches_jax(kw):
    """67x53 frames: odd width and height (the chroma pass reads luma
    column `width`, replicated). Inputs are left as they were."""
    planes, seq, hdr, w, h = _mk(**kw)
    want = jfg.apply_film_grain_tpu(planes, seq, hdr, w, h)
    dt = torch.uint8 if seq.bitdepth == 8 else torch.int16
    src = [_t(p).to(dt) for p in planes]
    got = tfg.apply_film_grain(src, seq, hdr, w, h)
    for s, p in zip(src, planes):
        assert torch.equal(s, _t(p).to(dt)), "an input plane was written"
    assert len(got) == len(want)
    for g, s, wnt in zip(got, src, want):
        assert g.dtype == s.dtype
        np.testing.assert_array_equal(g.numpy().astype(np.int32),
                                      np.asarray(wnt).astype(np.int32))
    assert not np.array_equal(np.asarray(want[0]), planes[0]) or \
        not hdr.film_grain_data.num_y_points
