"""Streams of the PyTorch port's tests (tests/streams_torch/): their
configurations and the functions that make them.

Every stream takes config 2's own parameters (bench.E2E_CONFIGS
["e2e_1080p_inter_cdef"]: 8-bit 4:2:0, q 80, switchable tx, deblock and
CDEF). ``build_tools_stream`` is test_e2e_inter.build_stream with global
motion added: that function codes none, so each inter frame's header gets
random global-motion parameters (streamgen.make_random_gmv, as
test_e2e_features does) for the references of GMV_TYPES.
``build_superres_stream`` is test_e2e_inter.build_stream with a
super-res denominator of its own on each inter frame (SUPERRES_DENOMS):
that function codes one for all. ``build_sharded_stream`` is
test_e2e_inter.build_stream with every block of the inter frames inter
(the ``_InterOnly`` policy of __graft_entry__._sharded_stream_decode) and
no inter tool but compound averages, so every block lies within the
sharded inter decode's scope. The Professional and High profile streams
(PRO, HIGH) are TOOLS at 12-bit 4:2:2 with loop restoration and chroma
film grain, and at 10-bit 4:4:4 with screen-content tools, made by
``build_tools_stream``. The small format streams (FORMATS) are
test_e2e_features.build_stream and test_e2e_inter.build_stream of the
configurations named there, at their tests' seeds. Written, with their
md5, by tools_dev/gen_torch_streams.py.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np

import bench
import test_e2e_features
import test_e2e_inter
from dav1d_mirror_tpu.host import headers as h
from dav1d_mirror_tpu.testing.streamgen import RandomPolicy, make_random_gmv

DIR = Path(__file__).parent / "streams_torch"
CONFIG2 = bench.E2E_CONFIGS["e2e_1080p_inter_cdef"]
# compound references with distance weights, wedge and seg masks; local
# warp, OBMC and inter-intra; a keyframe and 4 inter frames
TOOLS = dict(CONFIG2, n_inter=4, order_hint=1, comp=True, jnt=1, masked=1,
             warp=True, swmotion=True, interintra=1)
TOOLS_SEED = 9
LOSSLESS = dict(CONFIG2, w=128, h=64, n_inter=3, q=0)
LOSSLESS_SEED = 9
# super-res: the keyframe coded at denominator 16 (half width), the inter
# frames at SUPERRES_DENOMS (None: no super-res, every reference at the
# frame's own size); compound, OBMC and inter-intra blocks
SUPERRES = dict(CONFIG2, n_inter=4, sr=16, order_hint=1, comp=True, jnt=1,
                masked=1, swmotion=True, interintra=1)
SUPERRES_SEED = 9
SUPERRES_DENOMS = (16, 12, None, 9)
# the sharded path's stream: one tile, single-reference translational and
# compound average / distance-weighted blocks only (order hints and
# distance weights on, every other inter tool off)
SHARDED = dict(CONFIG2, n_inter=4, order_hint=1, comp=True, jnt=1)
SHARDED_SEED = 9
# AV1's Professional profile: TOOLS at 12-bit 4:2:2, with loop
# restoration (switchable on Y, self-guided on U, Wiener on V: dav1d's
# enum order, in which config 3's (2, 2, 2) is Wiener) and film grain:
# config 3's luma points and seed, Cb and Cr points of their own, a lag-3
# auto-regression on every plane, overlap and restricted-range clipping
PRO_GRAIN = dict(
    seed=4321, num_y_points=3, y_points=[(0, 40), (80, 90), (255, 20)],
    chroma_scaling_from_luma=0, num_uv_points=[2, 2],
    uv_points=[[(0, 30), (255, 70)], [(40, 60), (200, 25)]],
    scaling_shift=8, ar_coeff_lag=3,
    ar_coeffs_y=[2, -3, 1, 0, 4, -2, 3, -1, 0, 2, -4, 5,
                 1, -2, 6, 3, -5, 2, 0, 4, -3, 7, 9, -6],
    ar_coeffs_uv=[[1, 0, -2, 3, 0, 1, -1, 2, 4, -3, 0, 2,
                   -1, 3, 0, -2, 5, 1, -4, 2, 3, 6, -5, 8, 12],
                  [-2, 1, 0, 1, 3, -1, 2, 0, -3, 4, 1, -2,
                   2, 0, -1, 4, -2, 3, 1, -5, 6, -4, 7, 5, -9]],
    uv_mult=[-24, 16], uv_luma_mult=[64, 40], uv_offset=[0, 12],
    overlap_flag=1, clip_to_restricted_range=1)
PRO = dict(TOOLS, bitdepth=12, layout=h.PIXEL_LAYOUT_I422, lr=(1, 3, 2),
           fg=PRO_GRAIN)
PRO_SEED = 9
# AV1's High profile: TOOLS at 10-bit 4:4:4 with screen-content tools
# (palette blocks, in inter frames too)
HIGH = dict(TOOLS, bitdepth=10, layout=h.PIXEL_LAYOUT_I444, scc=1)
HIGH_SEED = 9
# the small format streams: (the test module whose build_stream makes
# it, its CONFIGS index), at 64x64 and the seed that module's test gives
# that index; CONFIGS 0-4 of test_e2e_features are 12-bit, 12-bit 4:4:4
# and 4:2:2 at 8, 10 and 12 bit
FORMATS = {
    "features0_12bit.ivf": (test_e2e_features, 0),
    "features1_444_12bit.ivf": (test_e2e_features, 1),
    "features2_422_8bit.ivf": (test_e2e_features, 2),
    "features3_422_10bit.ivf": (test_e2e_features, 3),
    "features4_422_12bit.ivf": (test_e2e_features, 4),
    "inter16_mono.ivf": (test_e2e_inter, 16),    # monochrome
    "inter39_scc.ivf": (test_e2e_inter, 39),     # palette in inter frames
}
# the seeds of test_e2e_features and test_e2e_inter for config ci
FORMAT_SEEDS = {test_e2e_features: lambda ci: 71000 + 173 * ci,
                test_e2e_inter: lambda ci: 31000 + 137 * ci}

# global-motion type of each reference (LAST .. ALTREF)
GMV_TYPES = (h.WM_TYPE_ROT_ZOOM, h.WM_TYPE_TRANSLATION, h.WM_TYPE_AFFINE,
             h.WM_TYPE_ROT_ZOOM, h.WM_TYPE_AFFINE, 0, h.WM_TYPE_ROT_ZOOM)

STREAMS = {
    # name: (md5 from the JAX package's host reference path, frames)
    "e2e_1080p_inter_tools.ivf": ("8e678ba92fc156763dac7dcfaae2e727", 5),
    "lossless_128x64.ivf": ("d8bb566f6479722343086a0cb22048e5", 4),
    "e2e_1080p_superres.ivf": ("c365d81ab907f53467bd0ae7762cb0ce", 5),
    "e2e_1080p_sharded.ivf": ("076650a32371f706c1437177be26aede", 5),
    "e2e_1080p_422_12bit.ivf": ("e4dce1d6efe442cf9b400eccdac09195", 5),
    "e2e_1080p_444_10bit.ivf": ("9916482c5803fb77ac8fe0f78caa36a6", 5),
    "features0_12bit.ivf": ("d6856dce530d35f9a63d85bc4481da38", 3),
    "features1_444_12bit.ivf": ("11ff0933268d4585d2cc30f04064486d", 3),
    "features2_422_8bit.ivf": ("4bf35ee594fa8ea810836a855fc8d5c7", 3),
    "features3_422_10bit.ivf": ("3d187e714b09f373abaef9b4185e6d3f", 3),
    "features4_422_12bit.ivf": ("97ac433eb36e44502493cd98cd04b508", 3),
    "inter16_mono.ivf": ("4d7a1f4b85605a8c61a33ed7312185f1", 4),
    "inter39_scc.ivf": ("2e5a1b57ca1005ebc8a7d9cec79c33fb", 4),
}
# md5 without film grain (Settings(apply_grain=False)) of each stream
# that has grain
NO_GRAIN_MD5 = {
    "e2e_1080p_422_12bit.ivf": "5a0f803eac6e7b2de4adde0f26e376a5"}
# md5 of the committed file of each 1080p profile stream (building one
# takes about a minute on a CPU)
FILE_MD5 = {"e2e_1080p_422_12bit.ivf": "33c0ca4a3ef5e05b33b4f9702f090be6",
            "e2e_1080p_444_10bit.ivf": "cd41284ce3380e1437baa56d300245c4"}


@contextlib.contextmanager
def _global_motion(seed):
    rng = np.random.default_rng(seed * 3 + 1)
    orig = test_e2e_inter.make_inter_frame_hdr

    def with_gmv(*args, **kw):
        fi = orig(*args, **kw)
        for ri, typ in enumerate(GMV_TYPES):
            if typ:
                fi.gmv[ri] = make_random_gmv(rng, typ, fi.hp)
        return fi

    test_e2e_inter.make_inter_frame_hdr = with_gmv
    try:
        yield
    finally:
        test_e2e_inter.make_inter_frame_hdr = orig


def build_tools_stream(cfg, seed, gmv=True):
    """test_e2e_inter.build_stream(cfg, seed), with global motion on every
    inter frame when gmv. Returns (seq, ivf bytes, frames)."""
    if not gmv:
        return test_e2e_inter.build_stream(cfg, seed)
    with _global_motion(seed):
        return test_e2e_inter.build_stream(cfg, seed)


@contextlib.contextmanager
def _superres_denoms(denoms):
    orig = test_e2e_inter.make_inter_frame_hdr
    left = list(denoms)

    def with_denom(*args, **kw):
        kw["superres_denom"] = left.pop(0)
        return orig(*args, **kw)

    test_e2e_inter.make_inter_frame_hdr = with_denom
    try:
        yield
    finally:
        test_e2e_inter.make_inter_frame_hdr = orig


def build_superres_stream(cfg, seed, denoms=SUPERRES_DENOMS):
    """test_e2e_inter.build_stream(cfg, seed) with inter frame i coded at
    super-res denominator denoms[i] (None: none); cfg["sr"] is the
    keyframe's. build_stream derives each frame's scaled references from
    its own header. Returns (seq, ivf bytes, frames)."""
    assert len(denoms) == cfg["n_inter"]
    with _superres_denoms(denoms):
        return test_e2e_inter.build_stream(cfg, seed)


class InterOnly(RandomPolicy):
    """RandomPolicy with every block of an inter frame inter
    (__graft_entry__._sharded_stream_decode's _InterOnly)."""

    def __call__(self, key, maxv):
        return 1 if key == "is_inter" else super().__call__(key, maxv)


def build_sharded_stream(cfg, seed):
    """test_e2e_inter.build_stream(cfg, seed) with the InterOnly policy on
    every frame. Returns (seq, ivf bytes, frames)."""
    orig = test_e2e_inter.RandomPolicy
    test_e2e_inter.RandomPolicy = InterOnly
    try:
        return test_e2e_inter.build_stream(cfg, seed)
    finally:
        test_e2e_inter.RandomPolicy = orig


def build_format_stream(name):
    """The small format stream `name` of FORMATS. Returns (seq, ivf
    bytes, frames)."""
    mod, ci = FORMATS[name]
    return mod.build_stream(mod.CONFIGS[ci], FORMAT_SEEDS[mod](ci))
