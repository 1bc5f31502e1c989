"""The PyTorch port's compound, warp, OBMC, inter-intra and lossless paths
on the CPU, exact against the JAX package:

- one frame program with warp, comp (average, distance-weighted, wedge
  and seg joins), obmc and residc ops, packed by the port's planner, run
  through the port's executor and through the JAX package's interpreter;
- the corpus streams with these tools (and inter_basic, multitile_2x2)
  against tests/streams/md5.txt;
- 128x64 mini streams (inter-intra; lossless; every tool at 8 and 10
  bit) against the JAX package's host reference path, and the committed
  tests/streams_torch streams against their recorded hashes (the 1080p
  one is decoded on the GPU only, by chip_smoke.py);
- references made a size other than the frame's (scaled MC of every tool)
  and the super-res corpus stream decode as the JAX package decodes them
  (tests/test_torch_superres.py holds the rest of that slice)."""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import dav1d_mirror_tpu.api as japi  # noqa: E402
import dav1d_mirror_tpu.models.ref_decoder as jref  # noqa: E402
import torch_streams as ts  # noqa: E402
from dav1d_mirror_tpu.models import frame_exec as jfe  # noqa: E402
from dav1d_mirror_tpu.output import MD5Muxer as JMD5Muxer  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
from dav1d_mirror_tpu_torch.output import MD5Muxer  # noqa: E402

STREAMS = Path(__file__).parent / "streams"
MINI = dict(ts.TOOLS, w=128, h=64, n_inter=3)
MINI_STREAMS = {
    "interintra": (dict(ts.CONFIG2, w=128, h=64, n_inter=3, interintra=1),
                   9, False),
    "tools_8bit": (MINI, 9, True),
    "tools_10bit": (dict(MINI, bitdepth=10), 9, True),
}


def _decode(api, mux, settings, data):
    _, _, _, frames = parse_ivf(data)
    dec = api.Decoder(settings)
    m = mux()
    for fr in frames:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            m.write(pic)
    return m.digest(), m.n


def _port(data):
    return _decode(tapi, MD5Muxer, tapi.Settings(device="cpu"), data)


def _jax_host(data):
    # the JAX host path caches global-motion warp parameters by
    # id(frame header): a header freed by an earlier decode can hand its
    # id, and its stale entry, to this one
    jref._GMV_WARP_CACHE.clear()
    return _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False), data)


def _op_kinds(sig):
    kinds = set()
    for op in sig[0]:
        kinds.add(op[0])
        if op[0] == "comp":
            kinds.update("join " + j[0] for j in op[6])
    return kinds


def test_tools_program_matches_jax_interpreter():
    """Frame 1 of a lossless 128x64 stream with every tool: its recon
    program holds all four compound joins, warps, OBMC laps of both
    phases and WHT residual buckets."""
    _, data, _ = ts.build_tools_stream(dict(MINI, q=0), 5)
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
    sig, desc, desc16, desc8, refsrc = seen[2]     # frame 1's recon
    assert {"warp", "comp", "obmc", "residc", "join wavg", "join segl",
            "join segc", "join wedge"} <= _op_kinds(sig)
    assert {op[5] for op in sig[0] if op[0] == "obmc"} == {False, True}
    j_planes, j_hres = jfe._interpreter(sig)(desc, desc16, desc8, refsrc)
    t_planes, t_hres = tfe.execute_program(
        sig, *tfe.frame_program_to_torch(desc, desc16, desc8, refsrc,
                                         "cpu"))
    assert len(t_planes) == len(j_planes) and len(t_hres) == len(j_hres)
    for t, j in zip(t_planes + t_hres, j_planes + j_hres):
        np.testing.assert_array_equal(t.numpy().astype(np.int32),
                                      np.asarray(j).astype(np.int32))


def _md5_txt():
    return dict(line.split()[::-1]
                for line in (STREAMS / "md5.txt").read_text().splitlines())


@pytest.mark.parametrize("name", ["inter_compound_oh", "inter_warp_obmc",
                                  "inter_masked", "inter_444_masked",
                                  "inter_tmvs_skip", "inter_basic",
                                  "multitile_2x2"])
def test_corpus_stream_md5_matches_md5_txt(name):
    data = (STREAMS / f"{name}.ivf").read_bytes()
    got, _ = _decode(tapi, MD5Muxer,
                     tapi.Settings(device="cpu", apply_grain=False), data)
    assert got == _md5_txt()[f"{name}.ivf"]


@pytest.mark.parametrize("name", sorted(MINI_STREAMS))
def test_mini_stream_md5_matches_jax_host_reference(name):
    cfg, seed, gmv = MINI_STREAMS[name]
    _, data, n_frames = ts.build_tools_stream(cfg, seed, gmv)
    want = _jax_host(data)
    assert want[1] == n_frames == 4
    assert _port(data) == want


def test_lossless_stream_matches_recorded_md5():
    """The committed lossless stream: its recorded md5 (the JAX host
    reference path's), and the port's decode of it."""
    data = (ts.DIR / "lossless_128x64.ivf").read_bytes()
    _, want, n_frames = ts.build_tools_stream(ts.LOSSLESS, ts.LOSSLESS_SEED,
                                              False)
    assert data == want
    md5, n = ts.STREAMS["lossless_128x64.ivf"]
    assert _jax_host(data) == (md5, n) == _port(data)


def test_committed_tools_stream_is_the_generator_output():
    """tests/streams_torch/e2e_1080p_inter_tools.ivf is what
    build_tools_stream makes from its configuration and seed (its md5 is
    asserted on the GPU by chip_smoke.py)."""
    import hashlib
    data = (ts.DIR / "e2e_1080p_inter_tools.ivf").read_bytes()
    _, _, _, frames = parse_ivf(data)
    assert len(frames) == ts.STREAMS["e2e_1080p_inter_tools.ivf"][1]
    _, made, _ = ts.build_tools_stream(dict(ts.TOOLS, n_inter=1),
                                       ts.TOOLS_SEED)
    _, _, _, made_frames = parse_ivf(made)
    # the keyframe and the first inter frame of the full build
    assert [hashlib.md5(f.data).digest() for f in frames[:2]] == \
        [hashlib.md5(f.data).digest() for f in made_frames]


def test_chip_smoke_asserts_the_recorded_tools_hashes():
    import chip_smoke
    for name, (md5, n) in ts.STREAMS.items():
        assert chip_smoke.TOOLS_STREAMS[name] == (md5, n)
        assert (Path(chip_smoke.TOOLS_DIR) / name).is_file()
    assert Path(chip_smoke.TOOLS_DIR) == ts.DIR
    md5 = _md5_txt()
    for name in chip_smoke.TOOLS_CORPUS:
        assert name in md5 and (STREAMS / name).is_file()


def _narrowed_refs_decode(api, mux, settings, frames):
    """Decode frames[0], make every reference 16 columns narrower than
    the frame, and decode frames[1]: every inter block of it, warp,
    compound and OBMC ones too, reads a scaled reference."""
    dec = api.Decoder(settings)
    m = mux()
    for i, fr in enumerate(frames[:2]):
        if i:
            for k, rb in enumerate(dec._refs):
                if rb is not None:
                    dec._refs[k] = copy.copy(rb)
                    dec._refs[k].width -= 16
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            m.write(pic)
    return m.digest(), m.n


def test_scaled_reference_matches_jax_host_reference():
    """Scaled MC on a frame of every tool decodes as the JAX host
    reference path decodes it, given the same narrowed references."""
    _, data, _ = ts.build_tools_stream(MINI, 9)
    _, _, _, frames = parse_ivf(data)
    want = _narrowed_refs_decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False), frames)
    got = _narrowed_refs_decode(tapi, MD5Muxer,
                                tapi.Settings(device="cpu"), frames)
    assert got == want and got[1] == 2


def test_super_res_frame_matches_md5_txt():
    """The super-res corpus stream decodes to its md5.txt hash."""
    data = (STREAMS / "inter_superres.ivf").read_bytes()
    assert _port(data) == (_md5_txt()["inter_superres.ivf"], 4)


def test_gmv_warp_cache_ignores_a_reused_id():
    """_gmv_warp_params caches per frame header, keyed by its id; Python
    gives a freed header's id to a new object, so an entry that another
    header left under that id must not answer (a second decode of one
    stream in a process read such entries)."""
    from dav1d_mirror_tpu.testing.streamgen import make_random_gmv
    from dav1d_mirror_tpu_torch.host import headers as th
    from dav1d_mirror_tpu_torch.models import frame_buffers as fb
    hdr = th.FrameHeader()
    hdr.force_integer_mv = 0
    hdr.gmv[2] = make_random_gmv(np.random.default_rng(3),
                                 th.WM_TYPE_AFFINE)
    fb._GMV_WARP_CACHE[(id(hdr), 2, False)] = (th.FrameHeader(), None)
    wm = fb._gmv_warp_params(hdr, 2, False)
    assert wm is not None and list(wm.matrix) == list(hdr.gmv[2].matrix)
    assert fb._gmv_warp_params(hdr, 2, False) is wm
