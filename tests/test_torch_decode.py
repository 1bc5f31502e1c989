"""The PyTorch port end to end on the CPU, with
``Decoder(Settings(device="cpu"))``:

- miniature config 2 (1080p 8-bit inter + deblock + CDEF) and config 3
  (1080p 10-bit, Wiener loop restoration and film grain) streams, cut to
  128x64 and 4 frames, must give the md5 of the JAX package's host
  reference path, config 3 with and without grain;
- the corpus streams with loop restoration, and ``inter_grain`` without
  grain, must give their ``tests/streams/md5.txt`` hashes; ``inter_grain``
  with grain, the JAX package's.

The full-size config 3 stream's hashes (decoded by the JAX package's host
reference path) and config 4's hash are asserted on the GPU by
``chip_smoke.py``."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

import bench  # noqa: E402
import dav1d_mirror_tpu.api as japi  # noqa: E402
from dav1d_mirror_tpu.output import MD5Muxer as JMD5Muxer  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.output import MD5Muxer  # noqa: E402
from test_e2e_inter import build_stream  # noqa: E402

STREAMS = Path(__file__).parent / "streams"
CONFIG2 = bench.E2E_CONFIGS["e2e_1080p_inter_cdef"]
CONFIG3 = bench.E2E_CONFIGS["e2e_1080p_10bit_grain_lr"]
# bench_cache/e2e_1080p_10bit_grain_lr_6d42abf87190.ivf, 5 frames
CONFIG3_MD5 = {True: "76e6cf803e84aaf3a9089fe53894d4d4",
               False: "6e6909b95f07928266f8c2157ff65a58"}
# bench_cache/e2e_4k_10bit_multitile_479aaf4a51e3.ivf (4K 10-bit, 2x2
# tiles), 3 frames: ROADMAP queue 1, item 0's hash, which the port's CPU
# decode gives too
CONFIG4_MD5 = "c00e0479951b96933a8284c9b4ab0366"
MINI = {
    "config2": dict(CONFIG2, w=128, h=64, n_inter=3),
    # the same stream shape at 10 bit: uint16 planes through the port
    "config2_10bit": dict(CONFIG2, w=128, h=64, n_inter=3, bitdepth=10),
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


@pytest.mark.parametrize("name", sorted(MINI))
def test_mini_stream_md5_matches_jax_host_reference(name):
    _, data, n_frames = build_stream(MINI[name], 9)
    want = _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False), data)
    got = _decode(tapi, MD5Muxer, tapi.Settings(device="cpu"), data)
    assert want[1] == n_frames == 4
    assert got == want


@pytest.mark.parametrize("grain", [True, False])
def test_mini_config3_md5_matches_jax_host_reference(grain):
    _, data, n_frames = build_stream(dict(CONFIG3, w=128, h=64, n_inter=3),
                                     9)
    want = _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False, apply_grain=grain), data)
    got = _decode(tapi, MD5Muxer,
                  tapi.Settings(device="cpu", apply_grain=grain), data)
    assert want[1] == n_frames == 4
    assert got == want


def test_grained_8bit_mini_stream_md5_matches_jax_host_reference():
    """Config 2 with config 3's grain parameters: grain at 8 bit, with
    and without synthesis."""
    cfg = dict(MINI["config2"], fg=CONFIG3["fg"])
    _, data, _ = build_stream(cfg, 9)
    for grain in (True, False):
        want = _decode(japi, JMD5Muxer, japi.Settings(
            use_tpu_inter=False, use_tpu_filters=False, apply_grain=grain),
            data)
        got = _decode(tapi, MD5Muxer,
                      tapi.Settings(device="cpu", apply_grain=grain), data)
        assert got == want


def _md5_txt():
    return dict(line.split()[::-1]
                for line in (STREAMS / "md5.txt").read_text().splitlines())


@pytest.mark.parametrize("name", ["inter_10bit_lr", "intra_sb128_lr",
                                  "inter_grain"])
def test_corpus_stream_md5_matches_md5_txt(name):
    """md5.txt hashes come from dav1d's md5 muxer, which leaves grain
    off."""
    data = (STREAMS / f"{name}.ivf").read_bytes()
    got, _ = _decode(tapi, MD5Muxer,
                     tapi.Settings(device="cpu", apply_grain=False), data)
    assert got == _md5_txt()[f"{name}.ivf"]


def test_inter_grain_with_grain_matches_jax_host_reference():
    data = (STREAMS / "inter_grain.ivf").read_bytes()
    want = _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False), data)
    got = _decode(tapi, MD5Muxer, tapi.Settings(device="cpu"), data)
    assert got == want
    assert got[0] != _md5_txt()["inter_grain.ivf"]


def test_chip_smoke_asserts_the_recorded_config3_hashes():
    """The full-size config 3 stream decodes on the GPU only: the hashes
    recorded here are the ones chip_smoke.py asserts, for that stream."""
    import chip_smoke
    assert chip_smoke.CONFIG3_MD5 == CONFIG3_MD5
    assert Path(chip_smoke.STREAM3).name == \
        "e2e_1080p_10bit_grain_lr_6d42abf87190.ivf"
    assert Path(chip_smoke.STREAM3).is_file()


def test_chip_smoke_asserts_the_recorded_config4_hash():
    import chip_smoke
    assert chip_smoke.CONFIG4_MD5 == CONFIG4_MD5
    assert Path(chip_smoke.STREAM4).name == \
        "e2e_4k_10bit_multitile_479aaf4a51e3.ivf"
    assert Path(chip_smoke.STREAM4).is_file()
