"""The PyTorch port's device intra engine (dav1d_mirror_tpu_torch/models/
intra.py) on the CPU, exact against the JAX package:

- the planner's wave plans against tpu_intra.build_intra_plan's on the
  same entropy decode;
- the wave scan against tpu_intra.intra_scan_impl on one plan, from
  random planes and residuals made from a seed with numpy;
- the keyframe driver (recon_intra_frame) against the JAX package's host
  reconstruction (ref_decoder.recon_frame, as test_ipred_tpu._ab_case
  runs it), at 4:2:0, 4:2:2, 4:4:4, monochrome, 10 and 12 bit, with
  palette and filter-intra blocks;
- the engine route, Decoder(Settings(device="cpu", intra_engine=True)),
  on corpus streams against tests/streams/md5.txt (its eligible inter
  frames full-device), and on a mini stream whose inter-intra frames
  take the hybrid route against the JAX package's host reference path;
- the executor's engine op kinds: the planners emit only handled kinds,
  and embed and crop move planes into and out of the padded layout."""
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import jax.numpy as jnp  # noqa: E402
import dav1d_mirror_tpu.api as japi  # noqa: E402
import torch_streams as ts  # noqa: E402
from dav1d_mirror_tpu.host.ivf import split_obus  # noqa: E402
from dav1d_mirror_tpu.models import ref_decoder as rd  # noqa: E402
from dav1d_mirror_tpu.models import tpu_intra as JI  # noqa: E402
from dav1d_mirror_tpu.output import MD5Muxer as JMD5Muxer  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
from dav1d_mirror_tpu_torch.models import intra as TI  # noqa: E402
from dav1d_mirror_tpu_torch.models.frame_buffers import (  # noqa: E402
    FrameBuffers)
from dav1d_mirror_tpu_torch.output import MD5Muxer  # noqa: E402
from test_e2e_intra import build_stream  # noqa: E402
from test_torch_ipred import (CASES, port_frame, port_plan,  # noqa: E402
                              subsampling)

STREAMS = Path(__file__).parent / "streams"
PORT = Path(__file__).parent.parent / "dav1d_mirror_tpu_torch"


def _jax_plan(name):
    seq, fhdr, coders = port_frame(name)
    bw, bh = coders[0].bw, coders[0].bh
    done = [np.zeros((bh, bw), np.int32) for _ in range(3)]
    plan = JI.IntraPlan()
    for c in coders:
        JI.build_intra_plan(seq, fhdr, c, done, plan)
    return plan


@pytest.mark.parametrize("name", sorted(CASES))
def test_intra_plan_matches_jax(name):
    """The port's wave rows are the reference's padded (n_waves, K,
    NPARAMS) plans without their padding."""
    main, filt, n_waves = _jax_plan(name).finalize()
    for (rows, offs), dense in zip(port_plan(name).wave_rows(),
                                   (main, filt)):
        assert len(offs) == n_waves + 1 and offs[-1] == len(rows)
        for w in range(n_waves):
            k = offs[w + 1] - offs[w]
            np.testing.assert_array_equal(rows[offs[w]:offs[w + 1]],
                                          dense[w, :k])
            assert not dense[w, k:].any()


@pytest.mark.parametrize("name", ["fi", "ief"])
def test_scan_matches_jax(name):
    seq, _, coders = port_frame(name)
    ssh, ssv = subsampling(seq)
    bd = seq.bitdepth
    main, filt, _ = _jax_plan(name).finalize()
    (mrows, moffs), (frows, foffs) = port_plan(name).wave_rows()
    assert len(frows) > 0 or name != "fi"     # "fi" runs filter cells
    bw, bh = coders[0].bw, coders[0].bh
    Hp, Wp = bh * 4 + TI.PADT + TI.PAD, bw * 4 + TI.PADT + TI.PAD
    rng = np.random.default_rng(11)
    planes = rng.integers(0, 1 << bd, (3, Hp, Wp)).astype(np.int32)
    res = rng.integers(-64, 64, (3, Hp, Wp)).astype(np.int32)
    want = JI.intra_scan_impl(tuple(jnp.asarray(p) for p in planes),
                              tuple(jnp.asarray(r) for r in res), main,
                              filt, bd, ssh, ssv, 3)
    got = TI.intra_scan(torch.from_numpy(planes), torch.from_numpy(res),
                        torch.from_numpy(mrows), moffs,
                        torch.from_numpy(frows), foffs, bd, ssh, ssv,
                        TI.wave_families(mrows, moffs))
    for i in range(3):
        # the reference drops masked lanes onto each plane's last element
        # (index -1); the port onto a sink past the planes
        w = np.asarray(want[i]).reshape(-1)[:-1]
        g = got[i].numpy().reshape(-1)[:-1]
        np.testing.assert_array_equal(g, w)


def _jax_host_recon(cfg, seed):
    """The JAX package's host reconstruction of the stream's keyframe
    (before the in-loop filters): (planes, bw, bh, ss_hor, ss_ver)."""
    _, _, ivf = build_stream(cfg, seed)
    _, _, _, frames = parse_ivf(ivf)
    box = {}
    orig = rd.recon_frame

    def spy(s_, f_, coders, bufs, *a, **k):
        box.update(coders=coders, seq=s_, fhdr=f_)
        return orig(s_, f_, coders, bufs, *a, **k)

    rd.recon_frame = spy
    try:
        d = japi.Decoder(japi.Settings(use_tpu_inter=False,
                                       use_tpu_filters=False))
        for fr in frames:
            d.send_obus([o for _, o in split_obus(fr.data)])
    finally:
        rd.recon_frame = orig
    bufs = rd.FrameBuffers(box["seq"], box["fhdr"])
    rd.recon_frame(box["seq"], box["fhdr"], box["coders"], bufs)
    c = box["coders"][0]
    return bufs.planes, c.bw, c.bh, bufs.ss_hor, bufs.ss_ver


@pytest.mark.parametrize("name", ["dir_mix", "rect_odd", "fi", "palette",
                                  "422", "444", "mono", "bd12"])
def test_recon_intra_frame_matches_jax_host(name):
    want, bw, bh, ssh, ssv = _jax_host_recon(*CASES[name])
    seq, fhdr, coders = port_frame(name)
    bufs = TI.recon_intra_frame(seq, fhdr, coders, FrameBuffers(seq, fhdr),
                                "cpu")
    assert len(bufs.dev_planes) == len(want)
    for i, (g, w) in enumerate(zip(bufs.dev_planes, want)):
        ph = (bh * 4) >> (ssv if i else 0)
        pw = (bw * 4) >> (ssh if i else 0)
        np.testing.assert_array_equal(
            g.numpy()[:ph, :pw].astype(np.int32),
            w[:ph, :pw].astype(np.int32), err_msg=f"plane {i}")


def _md5_txt():
    return dict(line.split()[::-1]
                for line in (STREAMS / "md5.txt").read_text().splitlines())


class _Routes:
    """Records, per decoded frame, which route it took: "intra" (the
    engine's own program), "mixed" (the engine inside an inter frame's
    program, with built.full_device) or "hybrid"."""

    def __init__(self, monkeypatch):
        self.frames = []
        orig_b, orig_i = tapi.build_frame_program, tapi.build_intra_frame

        def build(*a, **k):
            built = orig_b(*a, **k)
            self.frames.append(("mixed" if built.intra_engine else "hybrid",
                                built.full_device))
            return built

        def build_intra(*a, **k):
            self.frames.append(("intra", True))
            return orig_i(*a, **k)

        monkeypatch.setattr(tapi, "build_frame_program", build)
        monkeypatch.setattr(tapi, "build_intra_frame", build_intra)


def _decode(api, mux, settings, data):
    dec = api.Decoder(settings)
    m = mux()
    for fr in parse_ivf(data)[3]:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            m.write(pic)
    return m.digest(), m.n


@pytest.mark.parametrize("name", ["intra_420_8bit", "intra_filter_pal",
                                  "inter_basic"])
def test_engine_route_md5(name, monkeypatch):
    routes = _Routes(monkeypatch)
    data = (STREAMS / f"{name}.ivf").read_bytes()
    got, _ = _decode(tapi, MD5Muxer, tapi.Settings(
        device="cpu", intra_engine=True, apply_grain=False), data)
    assert got == _md5_txt()[f"{name}.ivf"]
    assert routes.frames[0] == ("intra", True)
    # every inter frame of these streams is eligible, and full-device
    assert all(r == ("mixed", True) for r in routes.frames[1:]), \
        routes.frames


def test_engine_route_lossless(monkeypatch):
    """Lossless (WHT) residual planes: resrawc, on every frame."""
    name = "lossless_128x64.ivf"
    kinds = set()
    orig = tfe.execute_program

    def spy(sig, *a):
        kinds.update(op[0] for op in sig[0])
        return orig(sig, *a)

    monkeypatch.setattr(tfe, "execute_program", spy)
    routes = _Routes(monkeypatch)
    got = _decode(tapi, MD5Muxer, tapi.Settings(device="cpu",
                                                intra_engine=True),
                  (ts.DIR / name).read_bytes())
    assert got == ts.STREAMS[name]
    assert routes.frames[0] == ("intra", True) and "resrawc" in kinds


def test_inter_intra_frames_take_the_hybrid_route(monkeypatch):
    cfg = dict(ts.CONFIG2, w=128, h=64, n_inter=3, interintra=1)
    _, data, n_frames = ts.build_tools_stream(cfg, 9, False)
    want = _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False), data)
    routes = _Routes(monkeypatch)
    got = _decode(tapi, MD5Muxer, tapi.Settings(device="cpu",
                                                intra_engine=True), data)
    assert got == want and want[1] == n_frames
    kinds = [r[0] for r in routes.frames]
    assert kinds[0] == "intra" and "hybrid" in kinds, kinds


def test_settings_intra_engine_defaults_to_the_hybrid_route(monkeypatch):
    routes = _Routes(monkeypatch)
    data = (STREAMS / "inter_basic.ivf").read_bytes()
    for engine in (None, False):
        routes.frames.clear()
        _decode(tapi, MD5Muxer, tapi.Settings(device="cpu",
                                              intra_engine=engine), data)
        assert {r[0] for r in routes.frames} == {"hybrid"}
    assert tapi.Settings().intra_engine is None


def test_planners_emit_only_handled_op_kinds():
    """frame_exec.LATER holds only forms that no planner of the port
    emits; every kind a planner emits is HANDLED."""
    emitted = set()
    for f in (PORT / "models").glob("*.py"):
        emitted |= set(re.findall(r'op\(\s*"(\w+)"', f.read_text()))
    assert emitted, "no prog.op call found"
    assert not emitted & set(tfe.LATER), emitted & set(tfe.LATER)
    assert emitted <= set(tfe.HANDLED), emitted - set(tfe.HANDLED)
    assert {"embed", "palset", "newres", "resrawmc", "resrawc",
            "intrascan", "crop"} <= emitted


def test_embed_and_crop_round_trip():
    """embed re-homes a plane into the engine's padded layout and crop
    brings it back into the frame's (larger, zero-filled) shape."""
    prog = tfe.FrameProgram(1, 8, [(4, 6)], plane_inputs=True)
    prog.op("embed", 0, 12, 14, 4, 6, 2)
    prog.op("crop", 0, 2, 2, 4, 6, 5, 8)
    src = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    out, _ = tfe.run_frame_program(prog, (src,), "cpu")
    assert out[0].shape == (5, 8)
    assert torch.equal(out[0][:4, :6], src)
    assert not out[0][4:].any() and not out[0][:, 6:].any()
