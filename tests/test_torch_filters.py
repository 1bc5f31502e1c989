"""Deblock and CDEF of the PyTorch port (dav1d_mirror_tpu_torch/ops/
loopfilter.py, ops/cdef.py) against the JAX package's deblock_plane_tpu
and cdef_frame_tpu on the same numpy inputs: random 64x64 luma and 32x32
chroma planes, maps drawn in their legal ranges. Tolerance: exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dav1d_mirror_tpu.ops.cdef_tpu import cdef_frame_tpu
from dav1d_mirror_tpu.ops.loopfilter_tpu import deblock_plane_tpu
from dav1d_mirror_tpu_torch.ops.cdef import cdef_frame
from dav1d_mirror_tpu_torch.ops.loopfilter import deblock_plane
from dav1d_mirror_tpu_torch.ops.spec_consts import calc_eih


def _smooth_plane(rng, n, bd):
    """Blocky content: flat 4x4 cells plus small noise, so that the
    filters' flatness and activity masks take both values."""
    cells = rng.integers(0, 1 << bd, (n // 4, n // 4))
    base = np.repeat(np.repeat(cells, 4, 0), 4, 1)
    noise = rng.integers(-3, 4, (n, n)) << (bd - 8)
    return np.clip(base + noise, 0, (1 << bd) - 1).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("sharpness", [0, 5])
def test_deblock_plane_matches_jax(bd, luma, sharpness):
    rng = np.random.default_rng(bd * 10 + luma * 2 + sharpness)
    n = 64 if luma else 32
    plane = _smooth_plane(rng, n, bd)
    h4 = w4 = n // 4
    top = 2 if luma else 1            # edge classes -1..2 (chroma -1..1)
    maps = [rng.integers(-1, top + 1, (h4, w4)).astype(np.int32)
            for _ in range(2)]
    lvls = [rng.integers(0, 64, (h4, w4)).astype(np.int32)
            for _ in range(4)]
    e_lut, i_lut = calc_eih(sharpness)
    want = np.asarray(deblock_plane_tpu(
        jnp.asarray(plane), *(jnp.asarray(m) for m in maps),
        *(jnp.asarray(v) for v in lvls), jnp.asarray(e_lut),
        jnp.asarray(i_lut), luma=luma, bitdepth=bd))
    src = _t(plane)
    got = deblock_plane(src, *(_t(m) for m in maps), *(_t(v) for v in lvls),
                        _t(e_lut), _t(i_lut), luma=luma, bitdepth=bd)
    assert torch.equal(src, _t(plane)), "input plane was modified"
    assert not np.array_equal(want, plane), "nothing was filtered"
    assert torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("damping", [3, 6])
def test_cdef_frame_matches_jax(bd, damping):
    rng = np.random.default_rng(bd + damping)
    planes = [_smooth_plane(rng, 64, bd), _smooth_plane(rng, 32, bd),
              _smooth_plane(rng, 32, bd)]
    # strengths as the header codes them: pri (0..15) << 2 | sec (0..3)
    y_str = (rng.integers(0, 16, 8) << 2 | rng.integers(0, 4, 8))
    uv_str = (rng.integers(0, 16, 8) << 2 | rng.integers(0, 4, 8))
    y_str[0] = uv_str[0] = 0
    # one 64x64 unit with a nonzero strength index (index -1, a skipped
    # unit, is the next test); noskip per 4x4
    idx_map = np.array([[rng.integers(1, 8)]], np.int32)
    noskip = rng.random((16, 16)) < 0.7
    d = damping + bd - 8
    want = cdef_frame_tpu(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(idx_map),
        jnp.asarray(noskip), jnp.asarray(y_str.astype(np.int32)),
        jnp.asarray(uv_str.astype(np.int32)), damping=d, bitdepth=bd,
        ss_hor=1, ss_ver=1, monochrome=False)
    got = cdef_frame(tuple(_t(p) for p in planes), _t(idx_map),
                     _t(noskip), _t(y_str.astype(np.int32)),
                     _t(uv_str.astype(np.int32)), damping=d, bitdepth=bd,
                     ss_hor=1, ss_ver=1, monochrome=False)
    for w, g in zip(want, got):
        assert torch.equal(g, torch.from_numpy(np.array(w)))
    assert not np.array_equal(np.array(want[0]), planes[0])


def test_cdef_frame_skipped_unit_is_identity():
    rng = np.random.default_rng(3)
    planes = [_smooth_plane(rng, 64, 8), _smooth_plane(rng, 32, 8),
              _smooth_plane(rng, 32, 8)]
    strengths = _t(np.full(8, 37, np.int32))
    got = cdef_frame(tuple(_t(p) for p in planes),
                     _t(np.array([[-1]], np.int32)),
                     _t(np.ones((16, 16), bool)), strengths, strengths,
                     damping=4, bitdepth=8, ss_hor=1, ss_ver=1,
                     monochrome=False)
    for g, p in zip(got, planes):
        assert torch.equal(g, _t(p))
