# Copied from dav1d_mirror_tpu/models/ref_decoder.py (FrameBuffers :34,
# _gmv_warp_params :299, _tile_payload :1079).
"""Frame plane buffers and the two frame-level helpers the planner and the
decoder share with the reference decoder."""
from __future__ import annotations

import numpy as np

from ..host import headers as h


class FrameBuffers:
    def __init__(self, seq: h.SequenceHeader, fhdr: h.FrameHeader,
                 width=None):
        self.seq = seq
        self.fhdr = fhdr
        self.bitdepth = seq.bitdepth
        dt = np.uint8 if self.bitdepth == 8 else np.uint16
        self.ss_hor = 1 if seq.layout != h.PIXEL_LAYOUT_I444 else 0
        self.ss_ver = 1 if seq.layout == h.PIXEL_LAYOUT_I420 else 0
        w, hgt = width if width is not None else fhdr.width[0], fhdr.height
        aw = (w + 127) & ~127
        ah = (hgt + 127) & ~127
        self.width, self.height = w, hgt
        # device-resident copies of the (padded) planes as torch tensors,
        # set by the device path so reference frames are read on the
        # device without a re-upload; None until then
        self.dev_planes = None
        self.planes = [np.zeros((ah, aw), dt)]
        if seq.layout != h.PIXEL_LAYOUT_I400:
            cw = aw >> self.ss_hor
            ch = ah >> self.ss_ver
            self.planes += [np.zeros((ch, cw), dt), np.zeros((ch, cw), dt)]

    def visible(self):
        w, hgt = self.width, self.height
        out = [self.planes[0][:hgt, :w]]
        if len(self.planes) > 1:
            cw = (w + self.ss_hor) >> self.ss_hor
            ch = (hgt + self.ss_ver) >> self.ss_ver
            out += [p[:ch, :cw] for p in self.planes[1:]]
        return out


_GMV_WARP_CACHE = {}


def _gmv_warp_params(fhdr, ref_i, scaled):
    """dav1d decode.c:3528-3531 gmv_warp_allowed + shear computation.
    Returns a WarpParams or None if warp is not allowed for this gmv."""
    from ..host.warpmv import WarpParams, get_shear_params
    key = (id(fhdr), ref_i, scaled)
    hit = _GMV_WARP_CACHE.get(key)
    # an entry holds its header: Python reuses the id of a freed header
    # (a later frame, or another decode's), so only the same object hits
    if hit is not None and hit[0] is fhdr:
        return hit[1]
    g = fhdr.gmv[ref_i]
    out = None
    if g.type > 1 and not fhdr.force_integer_mv and not scaled:
        wm = WarpParams()
        wm.matrix = list(g.matrix)
        if not get_shear_params(wm):
            wm.type = g.type
            out = wm
    _GMV_WARP_CACHE[key] = (fhdr, out)
    if len(_GMV_WARP_CACHE) > 256:
        _GMV_WARP_CACHE.clear()
    return out


def _tile_payload(st, tile_idx, fhdr):
    """Extract tile #tile_idx's msac payload from the tile groups."""
    for tg in st.tiles:
        if not (tg.start <= tile_idx <= tg.end):
            continue
        data = tg.data
        pos = 0
        for ti in range(tg.start, tg.end + 1):
            is_last = ti == tg.end
            if is_last:
                sz = len(data) - pos
            else:
                n_bytes = fhdr.tiling.n_bytes
                sz = int.from_bytes(data[pos:pos + n_bytes], "little") + 1
                pos += n_bytes
            if ti == tile_idx:
                return data[pos:pos + sz], 0, sz
            pos += sz
    raise ValueError(f"tile {tile_idx} not found")
