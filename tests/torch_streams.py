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
sharded inter decode's scope. Written, with their md5, by
tools_dev/gen_torch_streams.py.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np

import bench
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
# global-motion type of each reference (LAST .. ALTREF)
GMV_TYPES = (h.WM_TYPE_ROT_ZOOM, h.WM_TYPE_TRANSLATION, h.WM_TYPE_AFFINE,
             h.WM_TYPE_ROT_ZOOM, h.WM_TYPE_AFFINE, 0, h.WM_TYPE_ROT_ZOOM)

STREAMS = {
    # name: (md5 from the JAX package's host reference path, frames)
    "e2e_1080p_inter_tools.ivf": ("8e678ba92fc156763dac7dcfaae2e727", 5),
    "lossless_128x64.ivf": ("d8bb566f6479722343086a0cb22048e5", 4),
    "e2e_1080p_superres.ivf": ("c365d81ab907f53467bd0ae7762cb0ce", 5),
    "e2e_1080p_sharded.ivf": ("076650a32371f706c1437177be26aede", 5),
}


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
