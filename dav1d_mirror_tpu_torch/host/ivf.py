# Copied from dav1d_mirror_tpu/host/ivf.py.
"""IVF container demuxer (reference parity: tools/input/ivf.c)."""
from __future__ import annotations

import struct
from dataclasses import dataclass


@dataclass
class IvfFrame:
    data: bytes
    pts: int


def probe_ivf(data: bytes) -> bool:
    return len(data) >= 32 and data[:4] == b"DKIF" and data[8:12] == b"AV01"


def parse_ivf(data: bytes):
    """Returns (width, height, fps, [IvfFrame])."""
    if not probe_ivf(data):
        raise ValueError("not an IVF/AV01 file")
    (_, _, hdr_sz, _, w, hgt, fps_num, fps_den, _n) = \
        struct.unpack_from("<4sHH4sHHIII", data, 0)
    pos = hdr_sz
    frames = []
    while pos + 12 <= len(data):
        sz, pts = struct.unpack_from("<IQ", data, pos)
        pos += 12
        if pos + sz > len(data):
            break
        frames.append(IvfFrame(bytes(data[pos:pos + sz]), pts))
        pos += sz
    return w, hgt, (fps_num, fps_den), frames


def split_obus(frame_data: bytes):
    """Split a temporal unit into OBUs (requires obu_has_size_field)."""
    from .getbits import GetBits
    out = []
    pos = 0
    while pos < len(frame_data):
        gb = GetBits(frame_data, pos)
        gb.get_bit()
        obu_type = gb.get_bits(4)
        has_ext = gb.get_bit()
        has_len = gb.get_bit()
        gb.get_bit()
        if has_ext:
            gb.get_bits(8)
        if not has_len:
            out.append((obu_type, frame_data[pos:]))
            break
        ln = gb.get_uleb128()
        end = gb.byte_position() + ln
        out.append((obu_type, frame_data[pos:end]))
        pos = end
    return out
