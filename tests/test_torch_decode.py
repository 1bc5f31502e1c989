"""The PyTorch port end to end on the CPU: a miniature config 2 stream
(1080p 8-bit inter + deblock + CDEF, cut to 128x64 and 4 frames) decoded
by the JAX package's host reference path and by the port's
``Decoder(Settings(device="cpu"))`` must give the same md5."""
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

CONFIG2 = bench.E2E_CONFIGS["e2e_1080p_inter_cdef"]
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


def test_film_grain_raises_instead_of_skipping():
    cfg = dict(MINI["config2"],
               fg=bench.E2E_CONFIGS["e2e_1080p_10bit_grain_lr"]["fg"])
    _, data, _ = build_stream(cfg, 9)
    with pytest.raises(NotImplementedError, match="film grain"):
        _decode(tapi, MD5Muxer, tapi.Settings(device="cpu"), data)
    # without grain synthesis the same stream decodes, bit-exact
    want = _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False, apply_grain=False),
        data)
    got = _decode(tapi, MD5Muxer,
                  tapi.Settings(device="cpu", apply_grain=False), data)
    assert got == want
