# Copied from dav1d_mirror_tpu/host/lf.py (its native path only).
"""Deblocking edge/level map construction (dense-array formulation of dav1d
src/lf_mask.c mask_edges_intra/chroma + level cache fill).

native/lf.cpp replays the tile's decoded blocks in order, producing
per-4x4-edge filter size indices and per-4x4 levels that
ops/loopfilter.py consumes.
"""
from __future__ import annotations

import numpy as np

from . import headers as h


class LfArrays:
    def __init__(self, w4, h4, cw4, ch4):
        self.edge_v_y = np.full((h4, w4), -1, np.int8)
        self.edge_h_y = np.full((h4, w4), -1, np.int8)
        self.edge_v_uv = np.full((ch4, cw4), -1, np.int8)
        self.edge_h_uv = np.full((ch4, cw4), -1, np.int8)
        self.lvl_y = np.zeros((h4, w4, 2), np.uint8)
        self.lvl_uv = np.zeros((ch4, cw4, 2), np.uint8)


_lf_native_checked = False
_LF_TABS = None


def _lf_native():
    """The native map construction (native/lf.cpp), or None."""
    global _lf_native_checked
    from .native import LIB
    if LIB is None or not hasattr(LIB, "lf_build"):
        return None
    if not _lf_native_checked:
        import ctypes as ct
        LIB.lf_build.restype = None
        LIB.lf_build.argtypes = [ct.c_void_p] * 4
        LIB.lf_cfg_size.restype = ct.c_int
        _lf_native_checked = True
    return LIB


def _build_lf_arrays_native(LIB, seq, coders, w4, h4, cw4, ch4, ss_hor,
                            ss_ver, monochrome) -> LfArrays:
    """One native call per tile over the dense block records, sharing
    the frame-global maps/edge arrays exactly like the Python walk."""
    from ..data.tables import TABLES
    lf = LfArrays(w4, h4, cw4, ch4)
    txw_map = np.full((h4 + 32, w4 + 32), 2, np.uint8)
    txh_map = np.full((h4 + 32, w4 + 32), 2, np.uint8)
    ctxw_map = np.full((ch4 + 32, cw4 + 32), 1, np.uint8)
    ctxh_map = np.full((ch4 + 32, cw4 + 32), 1, np.uint8)
    global _LF_TABS
    if _LF_TABS is None:
        keep = [np.ascontiguousarray(TABLES["block_dimensions"],
                                     np.uint8),
                np.ascontiguousarray(TABLES["txfm_dimensions"],
                                     np.uint8)]
        _LF_TABS = (np.array([a.ctypes.data for a in keep], np.uint64),
                    keep)
    tabs = _LF_TABS[0]
    outp = np.array([a.ctypes.data for a in
                     (lf.edge_v_y, lf.edge_h_y, lf.edge_v_uv,
                      lf.edge_h_uv, lf.lvl_y, lf.lvl_uv, txw_map,
                      txh_map, ctxw_map, ctxh_map)], np.uint64)
    for coder in coders:
        blk = coder.native_arrays[0]
        cfg = np.array([w4, h4, cw4, ch4, ss_hor, ss_ver,
                        int(monochrome), blk.shape[0]], np.int32)
        assert cfg.shape[0] == LIB.lf_cfg_size()
        LIB.lf_build(cfg.ctypes.data, tabs.ctypes.data, blk.ctypes.data,
                     outp.ctypes.data)
    return lf


def build_lf_arrays(seq, fhdr, coders, width, height) -> LfArrays:
    ss_hor = 1 if seq.layout != h.PIXEL_LAYOUT_I444 else 0
    ss_ver = 1 if seq.layout == h.PIXEL_LAYOUT_I420 else 0
    w4 = (width + 3) >> 2
    h4 = (height + 3) >> 2
    cw4 = (w4 + ss_hor) >> ss_hor
    ch4 = (h4 + ss_ver) >> ss_ver
    monochrome = seq.layout == h.PIXEL_LAYOUT_I400
    LIB = _lf_native()
    if LIB is None or not all(getattr(c, "native_arrays", None) is not None
                              for c in coders):
        raise RuntimeError("deblock maps need the native library and the "
                           "native tile walk's dense records")
    return _build_lf_arrays_native(LIB, seq, coders, w4, h4, cw4, ch4,
                                   ss_hor, ss_ver, monochrome)
