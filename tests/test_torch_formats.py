"""The PyTorch port on AV1's Professional and High profile formats (4:2:2,
4:4:4, 12-bit) and on monochrome, on the CPU, md5 for md5 against the
JAX package's host reference path (or the same exception type):

- the Professional (12-bit 4:2:2, loop restoration, chroma film grain)
  and High (10-bit 4:4:4, screen-content tools) profile configurations
  of tests/torch_streams.py at 128x64 with 3 inter frames, with grain
  and without;
- every configuration of test_e2e_features.CONFIGS, and the 4:4:4,
  monochrome, 10-bit 4:4:4 compound, 4:4:4 masked compound and
  palette-on-inter configurations of test_e2e_inter.CONFIGS, at 64x64;
- the device intra engine's route on the 4:2:2, 12-bit and monochrome
  small streams;
- CDEF at 4:2:2 (its chroma direction remap and 4x8 blocks), 4:4:4 and
  monochrome, and deblock at 12 bit, against the JAX package's
  cdef_frame_tpu and deblock_plane_tpu on random 64x64 frames, and the
  inverse transform of every size and type at 12 bit on coefficients
  across the whole 20-bit range (its clamps, int32 butterflies);
- the sequence headers of the small streams (profiles 1 and 2, 12-bit,
  monochrome) and the bytes the yuv and y4m muxers write for their
  pictures, against the JAX package's;
- the committed streams of tests/streams_torch/ against their
  generators and their recorded hashes, and chip_smoke.py's copies of
  those hashes (the 1080p profile streams decode on the GPU only)."""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))

import dav1d_mirror_tpu.api as japi  # noqa: E402
import dav1d_mirror_tpu.models.ref_decoder as jref  # noqa: E402
import dav1d_mirror_tpu.output as joutput  # noqa: E402
import test_e2e_features  # noqa: E402
import test_e2e_inter  # noqa: E402
import torch_streams as ts  # noqa: E402
from dav1d_mirror_tpu.ops import itx as jitx  # noqa: E402
from dav1d_mirror_tpu.ops.cdef_tpu import cdef_frame_tpu  # noqa: E402
from dav1d_mirror_tpu.ops.loopfilter_tpu import (  # noqa: E402
    deblock_plane_tpu)
from dav1d_mirror_tpu.output import MD5Muxer as JMD5Muxer  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch import output as toutput  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.ops import itx as titx  # noqa: E402
from dav1d_mirror_tpu_torch.ops.cdef import cdef_frame  # noqa: E402
from dav1d_mirror_tpu_torch.ops.itx_meta import (  # noqa: E402
    TX_INFO, WHT_WHT, allowed_txtypes)
from dav1d_mirror_tpu_torch.ops.loopfilter import deblock_plane  # noqa: E402
from dav1d_mirror_tpu_torch.ops.spec_consts import calc_eih  # noqa: E402
from dav1d_mirror_tpu_torch.output import MD5Muxer  # noqa: E402
from test_torch_cli import _fields  # noqa: E402
from test_torch_filters import _smooth_plane  # noqa: E402

PROFILE_STREAMS = {"e2e_1080p_422_12bit.ivf": ts.PRO,
                   "e2e_1080p_444_10bit.ivf": ts.HIGH}
# test_e2e_inter.CONFIGS indices: 4:4:4, monochrome, 10-bit 4:4:4
# compound, 4:4:4 wedge/seg compound, palette on inter frames
INTER_FORMATS = (15, 16, 17, 26, 39)
# the small streams the intra engine decodes: 4:2:2, 12-bit, monochrome
ENGINE_STREAMS = ("features2_422_8bit.ivf", "features0_12bit.ivf",
                  "inter16_mono.ivf")


def _decode(api, mux, settings, data):
    """(md5, pictures), or the type name of the exception it raised."""
    _, _, _, frames = parse_ivf(data)
    dec = api.Decoder(settings)
    m = mux()
    try:
        for fr in frames:
            dec.send_data(fr.data)
            while (pic := dec.get_picture()) is not None:
                m.write(pic)
    except Exception as e:      # noqa: BLE001 (compared across packages)
        return type(e).__name__
    return m.digest(), m.n


def _port(data, grain=True, engine=False):
    return _decode(tapi, MD5Muxer, tapi.Settings(
        device="cpu", apply_grain=grain, intra_engine=engine), data)


def _jax_host(data, grain=True):
    # the JAX host path caches global-motion warp parameters by
    # id(frame header): a header freed by an earlier decode can hand its
    # id, and its stale entry, to this one
    jref._GMV_WARP_CACHE.clear()
    return _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False, apply_grain=grain),
        data)


@pytest.mark.parametrize("name,grain", [("e2e_1080p_422_12bit.ivf", True),
                                        ("e2e_1080p_422_12bit.ivf", False),
                                        ("e2e_1080p_444_10bit.ivf", True)])
def test_profile_mini_stream_matches_jax_host_reference(name, grain):
    """The profile stream's configuration at 128x64, 3 inter frames."""
    cfg = dict(PROFILE_STREAMS[name], w=128, h=64, n_inter=3)
    _, data, n_frames = ts.build_tools_stream(cfg, 9)
    want = _jax_host(data, grain)
    assert want[1] == n_frames == 4
    assert _port(data, grain) == want


@pytest.mark.parametrize("ci", range(len(test_e2e_features.CONFIGS)))
def test_features_config_matches_jax_host_reference(ci):
    cfg = test_e2e_features.CONFIGS[ci]
    _, data, n_frames = test_e2e_features.build_stream(
        cfg, ts.FORMAT_SEEDS[test_e2e_features](ci))
    want = _jax_host(data)
    assert want[1] == n_frames
    assert _port(data) == want


@pytest.mark.parametrize("ci", INTER_FORMATS)
def test_inter_format_config_matches_jax_host_reference(ci):
    cfg = test_e2e_inter.CONFIGS[ci]
    assert cfg.get("layout") or cfg.get("mono") or cfg.get("scc")
    _, data, n_frames = test_e2e_inter.build_stream(
        cfg, ts.FORMAT_SEEDS[test_e2e_inter](ci))
    want = _jax_host(data)
    assert want[1] == n_frames
    assert _port(data) == want


@pytest.mark.parametrize("name", ENGINE_STREAMS)
def test_engine_route_on_format_stream_matches_jax_host_reference(name):
    data = (ts.DIR / name).read_bytes()
    assert _port(data, engine=True) == _jax_host(data) == \
        ts.STREAMS[name]


@pytest.mark.parametrize("ss_hor,ss_ver,mono", [(1, 0, False),
                                                (0, 0, False),
                                                (1, 1, True)])
def test_cdef_frame_at_format_matches_jax(ss_hor, ss_ver, mono):
    bd = 12
    rng = np.random.default_rng(4 * ss_hor + 2 * ss_ver + mono)
    luma = _smooth_plane(rng, 64, bd)
    chroma = [] if mono else [
        _smooth_plane(rng, 64, bd)[:64 >> ss_ver, :64 >> ss_hor]
        for _ in range(2)]
    y_str = (rng.integers(0, 16, 8) << 2 | rng.integers(0, 4, 8))
    uv_str = (rng.integers(0, 16, 8) << 2 | rng.integers(0, 4, 8))
    y_str[0] = uv_str[0] = 0
    idx_map = np.array([[rng.integers(1, 8)]], np.int32)
    noskip = rng.random((16, 16)) < 0.7
    kw = dict(damping=4 + bd - 8, bitdepth=bd, ss_hor=ss_hor,
              ss_ver=ss_ver, monochrome=mono)
    planes = [luma] + chroma
    want = cdef_frame_tpu(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(idx_map),
        jnp.asarray(noskip), jnp.asarray(y_str.astype(np.int32)),
        jnp.asarray(uv_str.astype(np.int32)), **kw)
    got = cdef_frame(tuple(torch.from_numpy(p.copy()) for p in planes),
                     torch.from_numpy(idx_map), torch.from_numpy(noskip),
                     torch.from_numpy(y_str.astype(np.int32)),
                     torch.from_numpy(uv_str.astype(np.int32)), **kw)
    assert len(got) == len(planes)
    for w, g, p in zip(want, got, planes):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert not np.array_equal(np.asarray(w), p), "nothing was filtered"


@pytest.mark.parametrize("luma", [True, False])
def test_deblock_plane_at_12bit_matches_jax(luma):
    rng = np.random.default_rng(12 + luma)
    n = 64 if luma else 32
    plane = _smooth_plane(rng, n, 12)
    h4 = w4 = n // 4
    maps = [rng.integers(-1, (2 if luma else 1) + 1, (h4, w4)).astype(
        np.int32) for _ in range(2)]
    lvls = [rng.integers(0, 64, (h4, w4)).astype(np.int32)
            for _ in range(4)]
    e_lut, i_lut = calc_eih(3)
    want = np.asarray(deblock_plane_tpu(
        jnp.asarray(plane), *(jnp.asarray(m) for m in maps),
        *(jnp.asarray(v) for v in lvls), jnp.asarray(e_lut),
        jnp.asarray(i_lut), luma=luma, bitdepth=12))
    got = deblock_plane(*(torch.from_numpy(a) for a in
                          [plane] + maps + lvls + [e_lut, i_lut]),
                        luma=luma, bitdepth=12)
    assert not np.array_equal(want, plane), "nothing was filtered"
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("tx", range(19))
def test_itx_at_12bit_full_range_matches_jax(tx):
    """Every allowed type of `tx`, 4 blocks each, their low-frequency
    corners drawn from the whole range a 12-bit coefficient may take
    (dav1d clamps it to bd + 8 = 20 bits signed)."""
    rng = np.random.default_rng(120 + tx)
    w, h, _ = TX_INFO[tx]
    sw, sh = min(w, 32), min(h, 32)
    types = [t for t in allowed_txtypes(tx) if t != WHT_WHT]
    cf = np.zeros((4 * len(types), sh, sw), np.int32)
    for i in range(len(cf)):
        ky, kx = rng.integers(1, sh + 1), rng.integers(1, sw + 1)
        cf[i, :ky, :kx] = rng.integers(-(1 << 19), 1 << 19, (ky, kx))
    sel = np.array([titx.itx_multi_sel(tx, t) for t in types
                    for _ in range(4)], np.int32)
    want = jitx._residual_multi_core(cf, sel[:, 0], sel[:, 1], tx, 12, np)
    got = titx.itx_residual_multi(torch.from_numpy(cf),
                                  torch.from_numpy(sel[:, 0].copy()),
                                  torch.from_numpy(sel[:, 1].copy()), tx, 12)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(ts.FORMATS))
def test_committed_format_stream_is_its_generator_output(name):
    """Each small format stream: the generator's bytes, its recorded md5
    the JAX host reference path's, and the port's decode of it."""
    data = (ts.DIR / name).read_bytes()
    _, made, n_frames = ts.build_format_stream(name)
    assert data == made
    md5, n = ts.STREAMS[name]
    assert n == n_frames
    assert _jax_host(data) == (md5, n) == _port(data)


@pytest.mark.parametrize("name", sorted(ts.FORMATS))
def test_format_sequence_header_matches_jax(name):
    first = parse_ivf((ts.DIR / name).read_bytes())[3][0].data
    got = tapi.parse_sequence_header(first)
    assert _fields(got) == _fields(japi.parse_sequence_header(first))


@pytest.mark.parametrize("muxer", ["yuv", "y4m2"])
@pytest.mark.parametrize("name", ["features1_444_12bit.ivf",
                                  "features3_422_10bit.ivf",
                                  "inter16_mono.ivf"])
def test_format_muxer_bytes_equal_the_jax_muxers(name, muxer, tmp_path):
    """Plane sizes at 4:4:4 and 4:2:2 and 16-bit samples; monochrome
    writes no chroma planes."""
    dec = tapi.Decoder(tapi.Settings(device="cpu"))
    pics = []
    for fr in parse_ivf((ts.DIR / name).read_bytes())[3]:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            pics.append(pic)
    outs = []
    for mod in (toutput, joutput):
        path = tmp_path / f"{mod.__name__}.out"
        m = mod.open_muxer(muxer, str(path), fps=(25, 1))
        for pic in pics:
            m.write(pic)
        m.finish()
        outs.append(path.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 0


@pytest.mark.parametrize("name", sorted(PROFILE_STREAMS))
def test_committed_profile_stream_has_its_recorded_shape_and_hash(name):
    """A 1080p profile stream: its sequence header's size and format,
    its frame count and its file's recorded md5 (its decode's md5 is
    asserted on the GPU by chip_smoke.py)."""
    data = (ts.DIR / name).read_bytes()
    _, _, _, frames = parse_ivf(data)
    assert len(frames) == ts.STREAMS[name][1]
    seq = tapi.parse_sequence_header(frames[0].data)
    cfg = PROFILE_STREAMS[name]
    assert (seq.max_width, seq.max_height, seq.hbd, seq.layout) == (
        1920, 1080, {10: 1, 12: 2}[cfg["bitdepth"]], cfg["layout"])
    assert hashlib.md5(data).hexdigest() == ts.FILE_MD5[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(PROFILE_STREAMS))
def test_committed_profile_stream_is_the_generator_output(name):
    """The keyframe and first inter frame of a 1080p profile stream are
    what build_tools_stream makes from its configuration and seed (slow:
    20-30 s a stream on a CPU)."""
    data = (ts.DIR / name).read_bytes()
    _, _, _, frames = parse_ivf(data)
    _, made, _ = ts.build_tools_stream(
        dict(PROFILE_STREAMS[name], n_inter=1), 9)
    _, _, _, made_frames = parse_ivf(made)
    assert [f.data for f in frames[:2]] == [f.data for f in made_frames]


def test_chip_smoke_asserts_the_recorded_format_hashes():
    """chip_smoke.py's stream names and no-grain hashes (its TOOLS_STREAMS
    is held to STREAMS by test_torch_tools.py)."""
    import chip_smoke
    assert chip_smoke.NO_GRAIN_MD5 == ts.NO_GRAIN_MD5
    for name, md5 in ts.NO_GRAIN_MD5.items():    # the grain is visible
        assert md5 != ts.STREAMS[name][0]
    assert set(chip_smoke.FORMAT_STREAMS) == set(ts.FORMATS)
    for name in (chip_smoke.PRO_STREAM, chip_smoke.HIGH_STREAM):
        assert name in ts.STREAMS and (ts.DIR / name).is_file()
