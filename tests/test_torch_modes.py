"""The PyTorch port's decode modes on the CPU, each against the JAX
package's host reference path on the same stream and settings (md5 and
picture count, or per temporal unit which units raised a contained
error):

- the eight segmentation cases of test_e2e_segmentation.CASES (fresh,
  inherited, unchanged and temporally predicted maps, every feature);
- Settings.inloop_filters 0-7 and decode_frame_type 0-3;
- output_invisible_frames on a stream with a hidden frame shown later
  by show_existing_frame, and frame_size_limit under and over the
  frame's size;
- operating points 0 and 1 of a stream with two temporal layers;
- a stream joined mid-GOP (its first keyframe's temporal unit dropped),
  with and without its sequence header, in strict mode and not."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

import dav1d_mirror_tpu.api as japi  # noqa: E402
import test_e2e_inter  # noqa: E402
import test_e2e_segmentation  # noqa: E402
import test_temporal_layers  # noqa: E402
from dav1d_mirror_tpu.host import headers as h  # noqa: E402
from dav1d_mirror_tpu.output import MD5Muxer as JMD5Muxer  # noqa: E402
from dav1d_mirror_tpu.testing.streamgen import (  # noqa: E402
    RandomPolicy, gen_intra_frame, gen_inter_frame, gen_ivf,
    make_inter_frame_hdr, make_key_frame_hdr, make_seq_hdr)
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.demux import open_demuxer  # noqa: E402
from dav1d_mirror_tpu_torch.output import MD5Muxer  # noqa: E402


class _Built(Exception):
    """Raised by the patched gen_ivf with the stream it was given."""


def _segmentation_stream(ci):
    """The stream test_e2e_segmentation builds for CASES[ci]: its _run
    is stopped at the stream's bytes, before it asks for the oracle."""
    tag, seed, kw = test_e2e_segmentation.CASES[ci]
    orig = test_e2e_segmentation.gen_ivf

    def built(*args):
        raise _Built(orig(*args))

    test_e2e_segmentation.gen_ivf = built
    try:
        test_e2e_segmentation._run(None, None, tag, seed, **kw)
    except _Built as b:
        return b.args[0]
    finally:
        test_e2e_segmentation.gen_ivf = orig
    raise AssertionError("the segmentation stream was not built")


def _units(data):
    return list(open_demuxer(data)[1])


def _outcome(api, mux, settings, units):
    """Per temporal unit "E" (a contained error) or its picture count,
    then (md5, pictures)."""
    dec = api.Decoder(settings)
    m = mux()
    per_tu = []
    for obus in units:
        try:
            dec.send_obus(obus)
            err = False
        except api.DecodeError:
            err = True
        n = 0
        while (pic := dec.get_picture()) is not None:
            m.write(pic)
            n += 1
        per_tu.append("E" if err else n)
    return tuple(per_tu), m.digest(), m.n


def _both(units, **settings):
    """The outcome of the port on the CPU and of the JAX host path."""
    got = _outcome(tapi, MD5Muxer, tapi.Settings(
        device="cpu", logger=None, **settings), units)
    want = _outcome(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False, logger=None,
        **settings), units)
    return got, want


def _inter_stream(seed=77):
    """A 64x64 stream of test_e2e_inter's: loop filter, CDEF and loop
    restoration on every plane, a keyframe and 3 inter frames."""
    cfg = dict(lf=(24, 24, 16, 16, 1), lr=(1, 3, 2), txsw=True,
               cdef=dict(damping=4, n_bits=1, y_strength=[6, 11],
                         uv_strength=[3, 5]))
    return test_e2e_inter.build_stream(cfg, seed)[1]


@pytest.mark.parametrize("ci", range(len(test_e2e_segmentation.CASES)))
def test_segmentation_case_matches_jax_host_reference(ci):
    got, want = _both(_units(_segmentation_stream(ci)))
    assert "E" not in want[0]
    assert got == want


@pytest.mark.parametrize("mask", range(8))
def test_inloop_filters_mask_matches_jax_host_reference(mask):
    got, want = _both(_units(_inter_stream()), inloop_filters=mask)
    assert want[2] == 4
    assert got == want


@pytest.mark.parametrize("ftype", range(4))
def test_decode_frame_type_matches_jax_host_reference(ftype):
    got, want = _both(_units(_inter_stream()), decode_frame_type=ftype)
    assert got == want


def _hidden_frame_stream(seed=23):
    """A keyframe, a hidden inter frame (show_frame 0, showable), a
    show_existing_frame of it, and a shown inter frame."""
    seq = make_seq_hdr(64, 64)
    kf = make_key_frame_hdr(seq, qidx=100, txfm_mode=h.TX_SWITCHABLE,
                            loopfilter=(24, 24, 16, 16, 1))
    frames = [(kf, gen_intra_frame(seq, kf, RandomPolicy(seed))[0])]
    hidden = make_inter_frame_hdr(seq, qidx=100, txfm_mode=h.TX_SWITCHABLE,
                                  refidx=[0] * 7, refresh=1 << 1)
    hidden.show_frame, hidden.showable_frame = 0, 1
    frames.append((hidden, gen_inter_frame(seq, hidden,
                                           RandomPolicy(seed + 1))[0]))
    shown = h.FrameHeader()
    shown.show_existing_frame = 1
    shown.existing_frame_idx = 1
    frames.append((shown, None))
    last = make_inter_frame_hdr(seq, qidx=100, txfm_mode=h.TX_SWITCHABLE,
                                refidx=[1] * 7)
    frames.append((last, gen_inter_frame(seq, last,
                                         RandomPolicy(seed + 2))[0]))
    return gen_ivf(seq, frames)


@pytest.mark.parametrize("invisible", [False, True])
def test_output_invisible_frames_matches_jax_host_reference(invisible):
    got, want = _both(_units(_hidden_frame_stream()),
                      output_invisible_frames=invisible)
    assert want[2] == (4 if invisible else 3)
    assert got == want


@pytest.mark.parametrize("limit", [64 * 64, 64 * 64 - 1])
def test_frame_size_limit_matches_jax_host_reference(limit):
    got, want = _both(_units(_inter_stream()), frame_size_limit=limit)
    assert ("E" in want[0]) == (limit < 64 * 64)
    assert got == want


@pytest.mark.parametrize("oppoint,n_pictures", [(0, 4), (1, 3)])
def test_operating_point_matches_jax_host_reference(oppoint, n_pictures):
    got, want = _both(_units(test_temporal_layers._layered_stream()),
                      operating_point=oppoint)
    assert want[2] == n_pictures
    assert got == want


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("with_seq_hdr", [False, True])
def test_stream_joined_mid_gop_matches_jax_host_reference(with_seq_hdr,
                                                          strict):
    """Two GOPs, the first joined after its keyframe's temporal unit:
    with_seq_hdr keeps the sequence header OBU in front of the first
    inter frame. The second GOP decodes."""
    units = _units(_inter_stream())
    rest = [list(u) for u in units[1:]] + _units(_inter_stream(78))
    if with_seq_hdr:
        seq_obu = next(o for o in units[0] if (o[0] >> 3) & 15 ==
                       h.OBU_SEQ_HDR)
        rest[0].insert(0, seq_obu)
    got, want = _both(rest, strict_std_compliance=strict)
    assert want[0][3:] == (1, 1, 1, 1)
    assert got == want

