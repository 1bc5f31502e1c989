"""The PyTorch port's player (dav1d_mirror_tpu_torch/player.py) against
examples/player.py, the JAX package's player: the same YUV -> RGB
conversion on 8/10-bit 4:2:0, 4:2:2, 4:4:4 and 4:0:0 pictures, the same
keyframe seek targets, and a headless run (SDL's dummy driver) on the
CPU."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from dav1d_mirror_tpu_torch import player as tplayer
from dav1d_mirror_tpu_torch.host.demux import open_demuxer

REPO = Path(__file__).resolve().parent.parent
STREAMS = REPO / "tests" / "streams"


@pytest.fixture(scope="module")
def jplayer():
    """examples/player.py, loaded by path (it is no package module)."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_player", REPO / "examples" / "player.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _picture(layout, bitdepth, seed):
    """A random picture of 64x48 luma in `layout` (ss_hor, ss_ver) or
    monochrome (None)."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bitdepth == 8 else np.uint16
    hi = 1 << bitdepth
    planes = [rng.integers(0, hi, (48, 64)).astype(dt)]
    if layout is not None:
        ssh, ssv = layout
        planes += [rng.integers(0, hi, (48 >> ssv, 64 >> ssh)).astype(dt)
                   for _ in (1, 2)]
    return SimpleNamespace(planes=tuple(planes), bitdepth=bitdepth)


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("layout", [(1, 1), (1, 0), (0, 0), None],
                         ids=["420", "422", "444", "400"])
def test_yuv_to_rgb_matches_the_jax_player(jplayer, layout, bitdepth):
    pic = _picture(layout, bitdepth, seed=bitdepth * 7 + len(str(layout)))
    got = tplayer.yuv_to_rgb(pic)
    assert got.dtype == np.uint8 and got.shape == (48, 64, 3)
    np.testing.assert_array_equal(got, jplayer.yuv_to_rgb(pic))


@pytest.mark.parametrize("name", ["inter_basic.ivf", "multitile_2x2.ivf"])
def test_keyframe_tus_match_the_jax_player(jplayer, name):
    data = (STREAMS / name).read_bytes()
    units = list(open_demuxer(data)[1])
    keys = tplayer.keyframe_tus(units)
    assert keys and keys[0] == 0
    assert keys == jplayer.keyframe_tus(units)


def test_player_runs_headless_on_the_cpu():
    pytest.importorskip("pygame")
    env = dict(os.environ, SDL_VIDEODRIVER="dummy")
    r = subprocess.run(
        [sys.executable, "-m", "dav1d_mirror_tpu_torch.player",
         str(STREAMS / "inter_basic.ivf"), "--null", "--untimed",
         "--frames", "3", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    assert "played 3 frames" in r.stderr


def test_player_defaults_to_cuda():
    assert tplayer.parse_args(["x.ivf"]).device == "cuda"
