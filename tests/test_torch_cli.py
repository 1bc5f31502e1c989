"""The PyTorch port's CLI, muxers and public API on the CPU:

- test_cli_api's cases that need no oracle (flush/seek, settings
  variants, the xxh3 muxer, get_frame_delay), on the port;
- every muxer writes the bytes the JAX package's muxer writes for the
  same pictures; parse_sequence_header returns the JAX package's header
  on every corpus stream;
- `python -m dav1d_mirror_tpu_torch.cli ... --verify` exits 0, and
  --intraengine reaches the device intra engine;
- send_obus contains every exception a frame's pixel stage raises
  (dav1d abort_frame), NotImplementedError included."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import dav1d_mirror_tpu.api as japi  # noqa: E402
import dav1d_mirror_tpu.output as joutput  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch import output as toutput  # noqa: E402
from dav1d_mirror_tpu_torch.cli import main as cli_main  # noqa: E402
from dav1d_mirror_tpu_torch.errors import DecodeError  # noqa: E402
from dav1d_mirror_tpu_torch.host.demux import open_demuxer  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
from dav1d_mirror_tpu_torch.output import MD5Muxer  # noqa: E402
from dav1d_mirror_tpu.testing.streamgen import gen_ivf  # noqa: E402
from test_cli_api import _make_stream  # noqa: E402

REPO = Path(__file__).parent.parent
STREAMS = Path(__file__).parent / "streams"
CORPUS = sorted(line.split()[1] for line in
                (STREAMS / "md5.txt").read_text().splitlines())


def _settings(**kw):
    return tapi.Settings(device="cpu", **kw)


def _pictures(data, **kw):
    dec = tapi.Decoder(_settings(**kw))
    out = []
    for fr in parse_ivf(data)[3]:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            out.append(pic)
    return out


# ---- test_cli_api's oracle-free cases, on the port ----
def test_api_flush_seek():
    seq, frames = _make_stream(seed=99, n_inter=2)
    fr = parse_ivf(gen_ivf(seq, frames))[3]
    dec = tapi.Decoder(_settings())
    dec.send_data(fr[0].data)
    assert dec.get_picture() is not None
    # flush mid-stream, re-feed from the keyframe: same output
    dec.flush()
    m = MD5Muxer()
    for f in fr:
        dec.send_data(f.data)
        while (pic := dec.get_picture()) is not None:
            m.write(pic)
    dec2 = tapi.Decoder(_settings())
    m2 = MD5Muxer()
    for f in fr:
        dec2.send_data(f.data)
        while (pic := dec2.get_picture()) is not None:
            m2.write(pic)
    assert m.n == m2.n == 3 and m.digest() == m2.digest()


def test_api_settings_variants():
    fg = dict(seed=1234, num_y_points=3,
              y_points=[(0, 40), (80, 90), (255, 20)], ar_coeff_lag=1,
              ar_coeffs_y=[3, -7, 12, 5], scaling_shift=8, overlap_flag=1)
    seq, frames = _make_stream(seed=55, fg=fg)
    ivf = gen_ivf(seq, frames)
    grain = _pictures(ivf, apply_grain=True)
    nograin = _pictures(ivf, apply_grain=False)
    assert any(not np.array_equal(a.planes[0], b.planes[0])
               for a, b in zip(grain, nograin))
    nofilters = _pictures(ivf, inloop_filters=0)
    assert any(not np.array_equal(a.planes[0], b.planes[0])
               for a, b in zip(grain, nofilters))
    sh = tapi.parse_sequence_header(parse_ivf(ivf)[3][0].data)
    assert sh.max_width == 96 and sh.max_height == 64


def test_cli_xxh3_muxer(tmp_path):
    # xxh3 muxer (tools/output/xxhash.c): canonical 32-hex digest of the
    # same plane-row byte stream as md5; --verify is case-insensitive.
    import xxhash
    seq, frames = _make_stream(n_inter=0)
    ivf = gen_ivf(seq, frames)
    p = tmp_path / "t.ivf"
    p.write_bytes(ivf)
    out = tmp_path / "o.xxh3"
    assert cli_main(["-i", str(p), "--muxer", "xxh3", "--device", "cpu",
                     "-o", str(out), "-q"]) == 0
    got = out.read_text().strip()
    # recompute independently from the decoded planes
    hh = xxhash.xxh3_128()
    d = tapi.Decoder(_settings())
    for unit in open_demuxer(ivf)[1]:
        d.send_obus(unit)
        while (pic := d.get_picture()) is not None:
            for pl in pic.planes:
                dt = np.uint8 if pic.bitdepth == 8 else np.dtype("<u2")
                hh.update(np.ascontiguousarray(pl.astype(dt)).tobytes())
    assert got == hh.hexdigest()
    assert cli_main(["-i", str(p), "--muxer", "xxh3", "-o", "-", "-q",
                     "--device", "cpu", "--verify", got.upper()]) == 0
    assert cli_main(["-i", str(p), "--muxer", "xxh3", "-o", "-", "-q",
                     "--device", "cpu", "--verify", "0" * 32]) == 1


def test_get_frame_delay():
    # dav1d_get_frame_delay (include/dav1d/dav1d.h:323): frames the
    # decoder may buffer before the first get_picture success.
    gfd = tapi.get_frame_delay
    assert gfd() == 1
    assert gfd(tapi.Settings(n_threads=1)) == 1
    assert gfd(tapi.Settings(n_threads=2)) == 2
    assert gfd(tapi.Settings(max_frame_delay=5)) == 5
    with pytest.raises(ValueError):
        gfd(tapi.Settings(n_threads=512))
    for kw in (dict(n_threads=512), dict(max_frame_delay=-1)):
        with pytest.raises(ValueError):
            tapi.Decoder(_settings(**kw))
    for n in range(0, 300, 7):     # the JAX package's rule, everywhere
        for d in (-1, 0, 1, 2, 9, 257):
            try:
                want = japi.get_frame_delay(japi.Settings(
                    n_threads=n, max_frame_delay=d))
            except ValueError:
                want = ValueError
            try:
                got = gfd(tapi.Settings(n_threads=n, max_frame_delay=d))
            except ValueError:
                got = ValueError
            assert got == want, (n, d)


# ---- muxers and parse_sequence_header against the JAX package ----
@pytest.mark.parametrize("muxer", ["md5", "xxh3", "yuv", "y4m2", "null"])
@pytest.mark.parametrize("stream", ["intra_420_8bit", "intra_444_10bit",
                                    "inter_basic"])
def test_muxer_bytes_equal_the_jax_muxers(muxer, stream, tmp_path):
    pics = _pictures((STREAMS / f"{stream}.ivf").read_bytes(),
                     apply_grain=False)
    outs = []
    for mod in (toutput, joutput):
        path = tmp_path / f"{mod.__name__}.out"
        m = mod.open_muxer(muxer, str(path), fps=(25, 1))
        for pic in pics:
            m.write(pic)
        digest = m.finish()
        assert m.n == len(pics)
        outs.append((digest, path.read_bytes() if path.exists() else None))
    assert outs[0] == outs[1]
    if muxer in ("yuv", "y4m2"):
        assert len(outs[0][1]) > 0


def test_xxh3_muxer_without_xxhash_raises_a_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "xxhash", None)   # import fails
    with pytest.raises(RuntimeError, match="xxhash"):
        toutput.open_muxer("xxh3", "-")


@pytest.mark.parametrize("name", CORPUS)
def test_parse_sequence_header_matches_jax(name):
    data = (STREAMS / name).read_bytes()
    first = parse_ivf(data)[3][0].data
    got = tapi.parse_sequence_header(first)
    want = japi.parse_sequence_header(first)
    assert _fields(got) == _fields(want)


def _fields(x):
    """A header as plain data: its fields, recursively (the two packages'
    header classes are different classes with the same fields)."""
    if hasattr(x, "__dict__"):
        return {k: _fields(v) for k, v in vars(x).items()}
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    return x


def test_parse_sequence_header_raises_without_one():
    with pytest.raises(DecodeError):
        tapi.parse_sequence_header(b"")


# ---- the CLI ----
def test_cli_module_verifies_a_corpus_stream():
    r = subprocess.run(
        [sys.executable, "-m", "dav1d_mirror_tpu_torch.cli", "-i",
         "tests/streams/intra_420_8bit.ivf", "--muxer", "md5", "--verify",
         "187253db4a93d5cf39ddc3b6940fc0a0", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "Verified." in r.stderr


def test_cli_threads_reach_the_pipeline(monkeypatch, tmp_path):
    """--threads 4 pipelines the decode (the build stage runs on a
    worker thread) and --verify holds."""
    import threading
    names = []
    orig = tapi.build_frame_program

    def spy(*a, **k):
        names.append(threading.current_thread().name)
        return orig(*a, **k)

    monkeypatch.setattr(tapi, "build_frame_program", spy)
    assert cli_main(["-i", str(STREAMS / "inter_basic.ivf"), "--muxer",
                     "md5", "--verify", "65007e9bf3721006921fe0d91ae20d86",
                     "--threads", "4", "--device", "cpu", "-q", "-o",
                     str(tmp_path / "o.md5")]) == 0
    assert names and all(n.startswith("dav1d-build") for n in names)


@pytest.mark.parametrize("flag, engine", [("--intraengine", True),
                                          ("--no-intraengine", False),
                                          (None, False)])
def test_cli_intraengine_reaches_the_engine(flag, engine, monkeypatch,
                                            tmp_path):
    calls = []
    orig = tapi.build_intra_frame

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tapi, "build_intra_frame", spy)
    argv = ["-i", str(STREAMS / "intra_filter_pal.ivf"), "--muxer", "md5",
            "--verify", "3100692804dd29c7aa78ff45db91aea7", "--device",
            "cpu", "-q", "-o", str(tmp_path / "o.md5")]
    assert cli_main(argv + ([flag] if flag else [])) == 0
    assert bool(calls) == engine


def test_cli_profile_and_tracestats(tmp_path, capsys):
    assert cli_main(["-i", str(STREAMS / "intra_420_8bit.ivf"), "--muxer",
                     "md5", "--device", "cpu", "--profile",
                     str(tmp_path / "prof"), "--tracestats", "-o",
                     str(tmp_path / "o.md5")]) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    err = capsys.readouterr().err
    assert "host-entropy" in err and "filters" in err


# ---- error containment ----
def test_send_obus_contains_an_error_of_the_pixel_stage(monkeypatch):
    """An op kind the executor refuses (NotImplementedError) inside an
    inter frame's program is contained like any other error: DecodeError,
    the frame's refresh slots poisoned, and a later keyframe decodes."""
    frames = parse_ivf((STREAMS / "inter_basic.ivf").read_bytes())[3]
    dec = tapi.Decoder(_settings(logger=None, apply_grain=False))
    dec.send_data(frames[0].data)
    key = dec.get_picture()
    assert key is not None
    headers = []
    orig = tapi.build_frame_program

    def spy(seq, fhdr, *a, **k):
        headers.append(fhdr)
        return orig(seq, fhdr, *a, **k)

    monkeypatch.setattr(tapi, "build_frame_program", spy)
    # "out" ends every program of a frame's pixel stage
    monkeypatch.setattr(tfe, "HANDLED", tuple(k for k in tfe.HANDLED
                                              if k != "out"))
    with pytest.raises(DecodeError):
        dec.send_data(frames[1].data)
    assert isinstance(dec.last_error, NotImplementedError)
    flags = headers[-1].refresh_frame_flags
    assert flags and dec._errored_slots == {i for i in range(8)
                                            if flags >> i & 1}
    assert dec._st.frame_hdr is None and not dec._st.tiles
    monkeypatch.undo()
    dec.send_data(frames[0].data)          # a keyframe resumes decoding
    again = dec.get_picture()
    assert again is not None and not dec._errored_slots
    for a, b in zip(again.planes, key.planes):
        np.testing.assert_array_equal(a, b)
