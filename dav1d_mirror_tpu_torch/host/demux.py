# Copied from dav1d_mirror_tpu/host/demux.py.
"""Input demuxers with content probing (dav1d tools/input/*).

Supported containers, mirroring tools/input/input.c's probe registry:
  * IVF (tools/input/ivf.c)
  * Annex-B length-delimited streams (tools/input/annexb.c)
  * Section-5 raw OBU streams (tools/input/section5.c)

Each demuxer yields temporal units as lists of complete OBUs (with size
fields for ivf/section5; Annex-B OBUs carry no size field, which
parse_obus handles via the buffer bound)."""
from __future__ import annotations

from .ivf import parse_ivf, split_obus
from . import headers as h
from .getbits import GetBits


def _read_uleb(data, pos):
    v = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7


def probe_ivf(data: bytes) -> bool:
    return data[:4] == b"DKIF"


def probe_annexb(data: bytes) -> bool:
    """tools/input/annexb.c annexb_probe: a plausible chain of
    temporal/frame/obu length fields starting with a TD or SEQ OBU."""
    try:
        tu_size, pos = _read_uleb(data, 0)
        fu_size, pos2 = _read_uleb(data, pos)
        obu_size, pos3 = _read_uleb(data, pos2)
        if obu_size + (pos3 - pos2) > fu_size or \
                fu_size + (pos2 - pos) > tu_size:
            return False
        hdr = data[pos3]
        obu_type = (hdr >> 3) & 0xF
        has_size = (hdr >> 1) & 1
        return (not has_size and
                obu_type in (h.OBU_TD, h.OBU_SEQ_HDR))
    except (IndexError, ValueError):
        return False


def probe_section5(data: bytes) -> bool:
    """First OBU must be a TD with size field 0, or a SEQ_HDR."""
    try:
        hdr = data[0]
        if hdr & 0x80:
            return False
        obu_type = (hdr >> 3) & 0xF
        has_size = (hdr >> 1) & 1
        if not has_size:
            return False
        return obu_type in (h.OBU_TD, h.OBU_SEQ_HDR)
    except IndexError:
        return False


def demux_ivf(data: bytes):
    _, _, _, frames = parse_ivf(data)
    for fr in frames:
        yield [o for _, o in split_obus(fr.data)]


def demux_annexb(data: bytes):
    pos = 0
    n = len(data)
    while pos < n:
        tu_size, pos = _read_uleb(data, pos)
        tu_end = pos + tu_size
        obus = []
        while pos < tu_end:
            fu_size, pos = _read_uleb(data, pos)
            fu_end = pos + fu_size
            while pos < fu_end:
                obu_size, pos = _read_uleb(data, pos)
                obus.append(data[pos:pos + obu_size])
                pos += obu_size
        yield obus


def demux_section5(data: bytes):
    """Temporal units delimited by TD OBUs (tools/input/section5.c)."""
    pos = 0
    n = len(data)
    cur = []
    while pos < n:
        gb = GetBits(data[pos:pos + 32])
        gb.get_bit()
        obu_type = gb.get_bits(4)
        has_ext = gb.get_bit()
        has_size = gb.get_bit()
        gb.get_bit()
        if has_ext:
            gb.get_bits(8)
        if not has_size:
            raise ValueError("section5 OBU without size field")
        ln = gb.get_uleb128()
        total = gb.byte_position() + ln
        obu = data[pos:pos + total]
        pos += total
        if obu_type == h.OBU_TD and cur:
            yield cur
            cur = []
        cur.append(obu)
    if cur:
        yield cur


def open_demuxer(data: bytes):
    """Probe and return (name, iterator of temporal units)."""
    if probe_ivf(data):
        return "ivf", demux_ivf(data)
    if probe_annexb(data):
        return "annexb", demux_annexb(data)
    if probe_section5(data):
        return "section5", demux_section5(data)
    raise ValueError("unrecognised container")


def container_fps(data: bytes):
    """Frame rate from the container timing, if any (IVF header
    rate/scale, like the reference's demuxer fps reporting)."""
    if probe_ivf(data):
        _, _, fps, _ = parse_ivf(data)
        if fps[0] and fps[1]:
            return fps
    return (30, 1)
