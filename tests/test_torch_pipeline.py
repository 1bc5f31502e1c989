"""The pipelined Decoder of the PyTorch port (Settings.n_threads > 1 or
max_frame_delay > 1: entropy || build || pixels || download) on the CPU:

- on inter_basic and the multi-tile multitile_2x2, with n_threads=4 and
  with max_frame_delay=3, the serial port's md5 and frame count, which
  are tests/streams/md5.txt's;
- on fuzzed copies of a stream (the mutation loop of
  test_error_containment.test_truncated_obus_fuzz_no_crash), every call
  has the JAX package's pipelined host path's outcome
  (Settings(use_tpu_inter=False, use_tpu_filters=False, n_threads=4)):
  which send_obus and get_picture calls raised, and the md5 of every
  picture;
- an error of the pixel stage surfaces at get_picture, and the worker
  threads end with close()."""
import hashlib
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import dav1d_mirror_tpu.api as japi  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.demux import open_demuxer  # noqa: E402
from dav1d_mirror_tpu_torch.output import MD5Muxer  # noqa: E402
from test_e2e_inter import build_stream  # noqa: E402

STREAMS = Path(__file__).parent / "streams"
MD5 = dict(reversed(line.split()) for line in
           (STREAMS / "md5.txt").read_text().splitlines())
PIPELINED = [dict(n_threads=4), dict(max_frame_delay=3)]


def _decode(data, **kw):
    dec = tapi.Decoder(tapi.Settings(device="cpu", logger=None, **kw))
    mux = MD5Muxer()
    for obus in open_demuxer(data)[1]:
        dec.send_obus(obus)
        while (pic := dec.get_picture()) is not None:
            mux.write(pic)
    dec.drain()
    while (pic := dec.get_picture()) is not None:
        mux.write(pic)
    dec.close()
    return mux.digest(), mux.n


@pytest.mark.parametrize("kw", PIPELINED, ids=["threads4", "delay3"])
@pytest.mark.parametrize("name", ["inter_basic.ivf", "multitile_2x2.ivf"])
def test_pipelined_decode_equals_the_serial_one(name, kw):
    data = (STREAMS / name).read_bytes()
    serial = _decode(data)
    assert serial[0] == MD5[name]
    assert _decode(data, **kw) == serial


def _mutated(units, rng, tiles_only=False):
    """One fuzzed copy of the stream's temporal units (the mutation of
    test_error_containment.py:51: truncations and bit flips). With
    tiles_only, only the last OBU of each temporal unit (its frame's
    tile data) is mutated, so most frames parse and reach the pixel
    stage."""
    out = []
    for obus in units:
        mut = []
        for j, o in enumerate(obus):
            o = bytearray(o)
            if tiles_only and j != len(obus) - 1:
                mut.append(bytes(o))
                continue
            if len(o) and rng.random() < 0.5:
                if rng.random() < 0.5 and len(o) > 2:
                    o = o[:rng.integers(1, len(o))]
                else:
                    o[rng.integers(0, len(o))] ^= 1 << rng.integers(0, 8)
            mut.append(bytes(o))
        out.append(mut)
    return out


def _outcome(dec, err, units):
    """Every call's outcome: ("send", i, raised), ("get", i, md5 of the
    picture's planes or "raise")."""
    ev = []
    try:
        for i, obus in enumerate(units):
            try:
                dec.send_obus(obus)
                ev.append(("send", i, False))
            except err:
                ev.append(("send", i, True))
            while True:
                try:
                    pic = dec.get_picture()
                except err:
                    ev.append(("get", i, "raise"))
                    continue
                if pic is None:
                    break
                h = hashlib.md5()
                for p in pic.planes:
                    h.update(np.ascontiguousarray(p).tobytes())
                ev.append(("get", i, h.hexdigest()))
    finally:
        dec.close()
    return ev


@pytest.fixture(scope="module")
def fuzz_units():
    _, ivf, _ = build_stream(dict(comp=True), seed=72)
    return list(open_demuxer(ivf)[1])


@pytest.mark.parametrize("trial", range(6))
@pytest.mark.parametrize("tiles_only", [False, True], ids=["all", "tiles"])
def test_fuzzed_outcomes_equal_the_jax_pipelined_host_path(fuzz_units,
                                                           tiles_only,
                                                           trial):
    units = _mutated(fuzz_units, np.random.default_rng(1000 + trial),
                     tiles_only)
    want = _outcome(japi.Decoder(japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False, n_threads=4,
        logger=None)), japi.DecodeError, units)
    got = _outcome(tapi.Decoder(tapi.Settings(
        device="cpu", n_threads=4, logger=None)), tapi.DecodeError, units)
    assert got == want


def test_a_pixel_stage_error_surfaces_at_get_picture(monkeypatch):
    """As in the reference (api.py:419-431): send_obus returns, the
    picture's get_picture raises DecodeError, and the decoder goes on."""
    data = (STREAMS / "inter_basic.ivf").read_bytes()
    units = list(open_demuxer(data)[1])
    dec = tapi.Decoder(tapi.Settings(device="cpu", n_threads=4,
                                     logger=None))
    dec.send_obus(units[0])
    assert dec.get_picture() is not None
    orig = tapi.Decoder._pixels

    def boom(self, *a, **k):
        raise RuntimeError("pixel stage failed")

    monkeypatch.setattr(tapi.Decoder, "_pixels", boom)
    dec.send_obus(units[1])                 # no error here
    with pytest.raises(tapi.DecodeError, match="pixel stage failed"):
        dec.get_picture()
    monkeypatch.setattr(tapi.Decoder, "_pixels", orig)
    dec.flush()
    dec.send_obus(units[0])
    assert dec.get_picture() is not None
    dec.close()


def test_close_ends_the_worker_threads():
    before = {t.ident for t in threading.enumerate()}
    _decode((STREAMS / "inter_basic.ivf").read_bytes(), n_threads=4)
    left = [t for t in threading.enumerate() if t.ident not in before and
            t.name.startswith("dav1d-")]
    for t in left:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in left)
