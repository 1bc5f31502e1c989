"""Scaled motion compensation, super-resolution and the standalone
``Decoder.apply_grain`` of the PyTorch port on the CPU, exact against the
JAX package on the same inputs:

- ``ops/mc.mc_scaled_batch`` against ``mc_tpu.mc_scaled_batch`` (put and
  prep, bit depths 8/10/12, unit sizes of puts, compound sides and OBMC
  laps, steps 512..2048, pad rows, windows clamped at every frame edge),
  ``ops/mc.resize_plane`` against ``mc_tpu.resize_plane_tpu`` (every
  denominator 9..16, odd and chroma widths), and the planner's copied
  helpers against their originals;
- the recon program of a super-res inter frame (``scaled``, ``comp`` with
  "s" sides, ``obmc`` with "s" laps) and its filter program (``sres`` of
  the planes and of the pre-CDEF snapshot, then loop restoration), run
  through the port's executor and the JAX package's interpreter;
- streams with super-res and scaled references, and keyframe intrabc,
  against the JAX package's host reference path; the committed 1080p
  super-res stream against its generator (its md5 is asserted on the GPU
  by chip_smoke.py);
- ``Decoder.apply_grain`` against the JAX package's on the same
  pictures, at an odd and an even size."""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import dav1d_mirror_tpu.api as japi  # noqa: E402
import test_e2e_inter  # noqa: E402
import test_e2e_intra  # noqa: E402
import torch_streams as ts  # noqa: E402
from dav1d_mirror_tpu.models import frame_exec as jfe  # noqa: E402
from dav1d_mirror_tpu.models import ref_decoder as jrd  # noqa: E402
from dav1d_mirror_tpu.models import tpu_inter as jti  # noqa: E402
from dav1d_mirror_tpu.ops import mc_tpu as jmc  # noqa: E402
from dav1d_mirror_tpu.output import MD5Muxer as JMD5Muxer  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
from dav1d_mirror_tpu_torch.models import inter as tinter  # noqa: E402
from dav1d_mirror_tpu_torch.ops import mc  # noqa: E402
from dav1d_mirror_tpu_torch.output import MD5Muxer  # noqa: E402

MINI_SR = dict(ts.SUPERRES, w=128, h=64)
# keyframe intrabc (test_e2e_intra.CONFIGS), seed 3: md5 of the JAX host
# reference path, which the port's native pass 2 decodes
INTRABC = {
    "8bit": (dict(w=64, h=64, q=100, scc=1, intrabc=True, txsw=True),
             "f5e243c06c7dffe4e502567f5f8056fa"),
    "10bit": (dict(w=64, h=64, q=100, scc=1, intrabc=True, bitdepth=10,
                   txsw=True), "9fb50b7c6a9bcf608ab8438e25837c90"),
}
FG = test_e2e_inter.CONFIGS[18]["fg"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _decode(api, mux, settings, data, post=None):
    _, _, _, frames = parse_ivf(data)
    dec = api.Decoder(settings)
    m = mux()
    for fr in frames:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            m.write(pic if post is None else post(dec, pic))
    return m.digest(), m.n


def _port(data, **kw):
    return _decode(tapi, MD5Muxer, tapi.Settings(device="cpu", **kw), data)


def _jax_host(data, **kw):
    return _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False, **kw), data)


# ---------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("prep", [False, True])
@pytest.mark.parametrize("uw,uh", [(2, 2), (4, 4), (8, 8), (16, 8)])
def test_mc_scaled_batch_matches_jax(bd, prep, uw, uh):
    """16x8 is an OBMC lap's size (one unit per lap). Rows 0-3 step 2048
    (a reference twice as wide: the window's limit); windows start above,
    left of, below and right of the reference; the last 5 rows repeat the
    row before them (pad rows)."""
    rng = np.random.default_rng(bd * 100 + uw * 10 + uh + prep)
    R, H, W = 2, 40, 52
    ref = rng.integers(0, 1 << bd, (R, H, W)).astype(np.int32)
    B = 48
    dx = rng.integers(512, 2049, B)
    dy = rng.integers(512, 2049, B)
    dx[:4] = dy[:4] = 2048
    top = rng.integers(-6, H + 6, B)
    left = rng.integers(-6, W + 6, B)
    top[4:8] = (-20, H + 3, 5, 9)
    left[4:8] = (7, 11, -25, W + 2)
    args = np.stack([rng.integers(0, R, B), top, left,
                     rng.integers(0, 1024, B), rng.integers(0, 1024, B),
                     dx, dy, rng.integers(0, 9, B), np.zeros(B)],
                    1).astype(np.int32)
    args[-5:] = args[-6]
    args[8:12, 3] = 0      # copy columns at x = 0 (subx == 0)
    args[8:12, 5] = 1024   # ... and at every x
    want = jmc.mc_scaled_batch(ref, args, uw, uh, 2 * uw + 10, 2 * uh + 10,
                               bd, prep)
    got = mc.mc_scaled_batch(_t(ref), _t(args), uw, uh, 2 * uw + 10,
                             2 * uh + 10, bd, prep)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("denom", range(9, 17))
def test_resize_plane_matches_jax(bd, denom):
    """Luma widths 1920, 131 (odd) and 66, and their 4:2:0 chroma widths,
    at the frame's own parameters (ref_decoder._resize_params)."""
    rng = np.random.default_rng(bd * 17 + denom)
    for w1 in (1920, 131, 66):
        for ss in (0, 1):
            w0 = max((w1 * 8 + (denom >> 1)) // denom, min(16, w1))
            in_w, out_w = (w0 + ss) >> ss, (w1 + ss) >> ss
            step, x0 = jrd._resize_params(in_w, out_w)
            src_w = (4 * (((w0 + 7) >> 3) << 1) + ss) >> ss
            src = rng.integers(0, 1 << bd, (5, src_w + 9)).astype(np.int32)
            want = jmc.resize_plane_tpu(src, out_w, src_w, step, x0, bd)
            got = mc.resize_plane(_t(src), out_w, src_w, step, x0, bd)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resize_params_and_scale_helpers_match_jax():
    rng = np.random.default_rng(7)
    for _ in range(300):
        out_w = int(rng.integers(16, 8192))
        in_w = int(rng.integers(max(1, out_w // 2), out_w + 1))
        assert tinter._resize_params(in_w, out_w) == \
            jrd._resize_params(in_w, out_w)
        a, b = int(rng.integers(-10 ** 6, 10 ** 6)), int(rng.integers(1, 99))
        b = b if rng.integers(2) else -b
        assert tinter._ctrunc_div(a, b) == jrd._ctrunc_div(a, b)
        ref, cur = int(rng.integers(16, 8192)), int(rng.integers(16, 8192))
        assert tinter._scale_fac(ref, cur) == jti._scale_fac(ref, cur)
        v, sc = int(rng.integers(-1 << 20, 1 << 20)), \
            int(rng.integers(1 << 13, 1 << 15))
        assert tinter._scale_mv(v, sc) == jti._scale_mv(v, sc)


def test_scaled_rows_match_jax():
    rng = np.random.default_rng(11)
    for _ in range(200):
        ssh, ssv = int(rng.integers(2)), int(rng.integers(2))
        dims = (int(rng.choice([1, 2, 4, 8, 16, 32])),
                int(rng.choice([1, 2, 4, 8, 16, 32])))
        bx, by = int(rng.integers(0, 480)), int(rng.integers(0, 270))
        mv = (int(rng.integers(-2000, 2000)), int(rng.integers(-2000, 2000)))
        sx, sy = jti._scale_fac(int(rng.integers(960, 3841)), 1920), \
            jti._scale_fac(int(rng.integers(540, 2161)), 1080)
        step = ((sx + 8) >> 4, (sy + 8) >> 4)
        split = bool(rng.integers(2))
        args = (ssh, ssv, dims, bx, by, mv, int(rng.integers(9)),
                int(rng.integers(7)), (sx, sy), step)
        assert tinter._scaled_rows(*args, split=split) == \
            jti._scaled_rows(*args, split=split)


# ---------------------------------------------------------------------
# one super-res frame's programs, through both executors
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def sr_programs():
    """The programs the port executes for frames 0-1 of a 128x64 10-bit
    super-res stream with loop restoration on every plane, compound
    blocks and OBMC (frame 1: denominator 16, every reference scaled by
    2)."""
    cfg = dict(MINI_SR, bitdepth=10, lr=(2, 3, 1))
    _, data, _ = ts.build_superres_stream(cfg, 8)
    _, _, _, frames = parse_ivf(data)
    seen = []
    orig = tfe.execute_program

    def spy(sig, desc, desc16, desc8, refsrc):
        seen.append((sig, desc.numpy().copy(), desc16.numpy().copy(),
                     desc8.numpy().copy(),
                     tuple(r.numpy().copy() for r in refsrc)))
        return orig(sig, desc, desc16, desc8, refsrc)

    tfe.execute_program = spy
    try:
        dec = tapi.Decoder(tapi.Settings(device="cpu"))
        for fr in frames[:2]:
            dec.send_data(fr.data)
    finally:
        tfe.execute_program = orig
    assert len(seen) == 4
    return {"recon": seen[2], "filters": seen[3]}


def _kinds(sig):
    kinds = set()
    for op in sig[0]:
        kinds.add(op[0])
        if op[0] == "comp":
            kinds.update(f"comp {s[0]}" for side in op[5] for s in side)
        elif op[0] == "obmc":
            kinds.update(f"obmc {s[0]}" for s in op[7])
        elif op[0] == "sres":
            kinds.add(f"sres {op[1]}")
    return kinds


@pytest.mark.parametrize("which", ["recon", "filters"])
def test_superres_programs_match_jax_interpreter(sr_programs, which):
    sig, desc, desc16, desc8, refsrc = sr_programs[which]
    want_kinds = {"recon": {"scaled", "comp s", "obmc s"},
                  "filters": {"sres None", "sres precdef", "lrw",
                              "lrs"}}[which]
    assert want_kinds <= _kinds(sig)
    if which == "recon":
        assert sig[5] and all(i < 0 for _, slots in sig[4] for i in slots)
    j_planes, j_hres = jfe._interpreter(sig)(desc, desc16, desc8, refsrc)
    t_planes, t_hres = tfe.execute_program(
        sig, *tfe.frame_program_to_torch(desc, desc16, desc8, refsrc,
                                         "cpu"))
    assert len(t_planes) == len(j_planes) and len(t_hres) == len(j_hres)
    for t, j in zip(t_planes + t_hres, j_planes + j_hres):
        j = np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_array_equal(t.numpy().astype(np.int32),
                                      j.astype(np.int32))


# ---------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------
def _e2e_inter(ci):
    return test_e2e_inter.build_stream(test_e2e_inter.CONFIGS[ci], 5)[1]


SR_STREAMS = {
    # test_e2e_inter.CONFIGS' two super-res configurations
    "inter sr12": lambda: _e2e_inter(40),
    "inter sr16 comp": lambda: _e2e_inter(41),
    # a super-res keyframe, and one with loop restoration at 10 bit
    "intra sr12": lambda: test_e2e_intra.build_stream(
        dict(w=64, h=64, q=100, sr=12, txsw=True), 3)[2],
    "intra sr12 10bit lr": lambda: test_e2e_intra.build_stream(
        dict(w=64, h=64, q=100, sr=12, bitdepth=10, lr=(1, 1, 1)), 3)[2],
    # inter frames with super-res and loop restoration at 10 bit, and
    # with film grain
    "inter sr13 10bit lr": lambda: test_e2e_inter.build_stream(
        dict(w=96, h=64, sr=13, bitdepth=10, lr=(2, 3, 1), txsw=True,
             lf=(18, 18, 12, 12, 0)), 5)[1],
    "inter sr11 grain": lambda: test_e2e_inter.build_stream(
        dict(w=64, h=64, sr=11, txsw=True, fg=FG), 5)[1],
    # the new 1080p stream's settings at 128x64
    "superres 128x64": lambda: ts.build_superres_stream(MINI_SR, 9)[1],
}


@pytest.mark.parametrize("name", sorted(SR_STREAMS))
def test_superres_stream_matches_jax_host_reference(name):
    data = SR_STREAMS[name]()
    want = _jax_host(data)
    assert want[1] >= 1
    assert _port(data) == want


@pytest.mark.parametrize("name", sorted(INTRABC))
def test_intrabc_stream_matches_jax_host_reference(name):
    cfg, md5 = INTRABC[name]
    _, fhdr, data = test_e2e_intra.build_stream(cfg, 3)
    assert fhdr.allow_intrabc
    assert _port(data) == _jax_host(data) == (md5, 1)


def test_committed_superres_stream_is_the_generator_output():
    """tests/streams_torch/e2e_1080p_superres.ivf: the keyframe and the
    first inter frame are what build_superres_stream makes from its
    configuration, seed and first denominator; every frame's coded width
    is the one its denominator gives."""
    data = (ts.DIR / "e2e_1080p_superres.ivf").read_bytes()
    _, _, _, frames = parse_ivf(data)
    assert len(frames) == ts.STREAMS["e2e_1080p_superres.ivf"][1]
    _, made, _ = ts.build_superres_stream(
        dict(ts.SUPERRES, n_inter=1), ts.SUPERRES_SEED,
        ts.SUPERRES_DENOMS[:1])
    _, _, _, made_frames = parse_ivf(made)
    assert [hashlib.md5(f.data).digest() for f in frames[:2]] == \
        [hashlib.md5(f.data).digest() for f in made_frames]


def test_chip_smoke_asserts_the_recorded_superres_hashes():
    import chip_smoke
    name = "e2e_1080p_superres.ivf"
    assert chip_smoke.SUPERRES_STREAM == name
    assert chip_smoke.TOOLS_STREAMS[name] == ts.STREAMS[name]
    assert (Path(chip_smoke.TOOLS_DIR) / name).is_file()
    corpus = dict(line.split()[::-1] for line in (
        Path(__file__).parent / "streams" / "md5.txt").read_text()
        .splitlines())
    assert chip_smoke.SUPERRES_CORPUS == ("inter_superres.ivf",)
    assert "inter_superres.ivf" in corpus


# ---------------------------------------------------------------------
# Decoder.apply_grain
# ---------------------------------------------------------------------
@pytest.mark.parametrize("w,h", [(65, 35), (64, 64)])
def test_apply_grain_matches_jax(w, h):
    """Decoded without grain, each picture grained by Decoder.apply_grain:
    the port's equals the JAX package's on the same pictures, and a
    decode with grain on. 65x35 has odd luma dimensions (the grain pass
    reads a padded luma column and row)."""
    _, data, _ = test_e2e_inter.build_stream(
        dict(w=w, h=h, txsw=True, fg=FG, n_inter=2), 7)

    def grained(dec, pic):
        out = dec.apply_grain(pic)
        assert out is not pic and out.planes[0].shape == (h, w)
        return out

    want = _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False, apply_grain=False),
        data, grained)
    got = _decode(tapi, MD5Muxer,
                  tapi.Settings(device="cpu", apply_grain=False), data,
                  grained)
    assert got == want
    assert got == _port(data)


def test_get_event_flags_match_jax():
    """dav1d_get_event_flags: a new sequence header sets NEW_SEQUENCE and
    NEW_OP_PARAMS_INFO once; reading clears them."""
    _, data, _ = ts.build_superres_stream(MINI_SR, 9)
    _, _, _, frames = parse_ivf(data)
    got = []
    for api, settings in ((tapi, tapi.Settings(device="cpu")),
                          (japi, japi.Settings(use_tpu_inter=False,
                                               use_tpu_filters=False))):
        dec = api.Decoder(settings)
        flags = [dec.get_event_flags()]
        for fr in frames[:2]:
            dec.send_data(fr.data)
            flags += [dec.get_event_flags(), dec.get_event_flags()]
        got.append(flags)
    assert got[0] == got[1] == [0, tapi.EVENT_FLAG_NEW_SEQUENCE |
                                tapi.EVENT_FLAG_NEW_OP_PARAMS_INFO, 0, 0, 0]
