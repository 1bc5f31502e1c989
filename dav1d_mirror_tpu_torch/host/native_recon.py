# Copied from dav1d_mirror_tpu/host/native_recon.py.
"""Glue for the native decode-order intra reconstruction pass
(native/recon.cpp — the "host pass 2" of models/tpu_inter).

The native walk consumes the dense block/coef records the native tile
walk already produced (``coder.native_arrays``) plus the device-computed
residual buffers, and performs edge prep + all intra predictors + CFL +
palette + residual add in C++ (dav1d src/recon_tmpl.c:1195-1596 and
src/ipred_tmpl.c:93-720 equivalents), keyframe intrabc blocks
included. It refuses (rc -1), before touching any pixel, when a block of
an inter frame needs host inter work, i.e. the planner did not send its
prediction to the device; this package has no Python walk, so callers
raise then. Inter-intra blocks (flagged 2) get their inter prediction
from the device and their intra blend here.

The RC_* config layout and return codes mirror native/recon.cpp.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from ..data.tables import TABLES
from .native import LIB
from .native_tile import (B_BS, B_INTERINTRA_MODE, B_INTERINTRA_TYPE,
                          B_WEDGE_IDX)

_checked = False
_TABS = None


def available() -> bool:
    global _checked
    if LIB is None or not hasattr(LIB, "recon_intra_pass"):
        return False
    if not _checked:
        LIB.recon_intra_pass.restype = ct.c_int
        LIB.recon_intra_pass.argtypes = [ct.c_void_p] * 12
        LIB.recon_cfg_size.restype = ct.c_int
        _checked = True
    return True


def _tabs():
    """uint64 pointer table: block_dimensions, txfm_dimensions,
    sm_weights, dr_intra_derivative, filter_intra_taps (deinterleaved
    int32, from ops/ref/ipred.py)."""
    global _TABS
    if _TABS is None:
        from ..ops.spec_consts import FILTER_INTRA_TAPS
        keep = [np.ascontiguousarray(TABLES["block_dimensions"], np.uint8),
                np.ascontiguousarray(TABLES["txfm_dimensions"], np.uint8),
                np.ascontiguousarray(TABLES["sm_weights"], np.uint8),
                np.ascontiguousarray(TABLES["dr_intra_derivative"],
                                     np.uint16),
                np.ascontiguousarray(FILTER_INTRA_TAPS, np.int32)]
        _TABS = (np.array([a.ctypes.data for a in keep], np.uint64), keep)
    return _TABS[0]


def pack_residuals(coders, hres_meta, hres):
    """Flatten the device-returned residual buckets into one int32
    buffer + per-coder per-coef-record offset arrays (-1 = no residual).
    Buckets are either lists of (cf, y_px, x_px, coder_idx, coef_idx)
    tuples (per-block planner) or plan_vec.ResidBucket arrays."""
    from ..models.plan_vec import ResidBucket
    offs = [np.full(len(c.coefs), -1, np.int64) for c in coders]
    chunks = []
    base = 0
    for (pl, lst), res in zip(hres_meta, hres):
        n = len(lst)
        res = np.ascontiguousarray(np.asarray(res)[:n], np.int32)
        sz = res.shape[1] * res.shape[2]
        chunks.append(res.reshape(-1))
        if isinstance(lst, ResidBucket):
            flat = base + np.arange(n, dtype=np.int64) * sz
            for c_i in np.unique(lst.ci):
                m = lst.ci == c_i
                offs[int(c_i)][lst.cj[m]] = flat[m]
        else:
            for i, e in enumerate(lst):
                offs[e[3]][e[4]] = base + i * sz
        base += n * sz
    res_buf = np.concatenate(chunks) if chunks else np.zeros(1, np.int32)
    return res_buf, offs


_II_EMPTY = (np.zeros(1, np.uint8), np.full(1, -1, np.int64))


def _pack_ii_masks(coder, blk, device_done, ss_hor, ss_ver, has_chroma):
    """Flatten inter-intra blend masks (ops/wedge.ii_mask) for blocks
    flagged 2 in device_done. Returns (mask_buf u8, offsets
    (n_blocks, 2) int64 with -1 = none)."""
    if not (device_done == 2).any():
        return _II_EMPTY
    from ..ops.wedge import ii_mask
    T_BD = TABLES["block_dimensions"]
    offs = np.full((len(device_done), 2), -1, np.int64)
    chunks = []
    base = 0
    for bi in np.nonzero(device_done == 2)[0]:
        r = blk[bi]
        bs = int(r[B_BS])
        itype = int(r[B_INTERINTRA_TYPE])
        imode = int(r[B_INTERINTRA_MODE])
        widx = int(r[B_WEDGE_IDX])
        bw4, bh4 = int(T_BD[bs][0]), int(T_BD[bs][1])
        m = np.ascontiguousarray(
            ii_mask(0, bs, itype, imode, widx)[:bh4 * 4, :bw4 * 4],
            np.uint8)
        chunks.append(m.reshape(-1))
        offs[bi, 0] = base
        base += m.size
        if has_chroma:
            cbw4 = (bw4 + ss_hor) >> ss_hor
            cbh4 = (bh4 + ss_ver) >> ss_ver
            cm = np.ascontiguousarray(
                ii_mask(ss_hor + ss_ver, bs, itype, imode, widx)
                [:cbh4 * 4, :cbw4 * 4], np.uint8)
            chunks.append(cm.reshape(-1))
            offs[bi, 1] = base
            base += cm.size
    return np.concatenate(chunks), offs


def recon_tile_native(seq, fhdr, coder, bufs, device_done, res_buf,
                      offs) -> int:
    """Run the native pass-2 walk for one tile. Returns the native rc:
    0 ok; -1 an inter block's prediction was not sent to the device
    (nothing written);
    -2/-3/-4 internal ordering/residual/mask errors (callers must fall
    back)."""
    blk, coef, pal, palidx = coder.native_arrays
    n_blocks, n_coefs = blk.shape[0], coef.shape[0]
    planes = bufs.planes
    strides = [p.shape[1] for p in planes] + [0] * (3 - len(planes))
    keyframe = 1 if fhdr.frame_type in (0, 2) else 0
    cfg = np.array([
        seq.bitdepth, bufs.ss_hor, bufs.ss_ver, len(planes), seq.layout,
        keyframe, seq.intra_edge_filter, coder.sb_step, coder.bw,
        coder.bh, coder.col_start, coder.col_end, coder.row_start,
        coder.row_end, strides[0], strides[1], strides[2], n_blocks,
        n_coefs,
    ], np.int32)
    assert cfg.shape[0] == LIB.recon_cfg_size()
    pptr = np.zeros(3, np.uint64)
    for i, p in enumerate(planes):
        pptr[i] = p.ctypes.data
    dd = np.ascontiguousarray(device_done, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    ii_buf, ii_off = _pack_ii_masks(coder, blk, dd, bufs.ss_hor,
                                    bufs.ss_ver, len(planes) > 1)
    return LIB.recon_intra_pass(
        cfg.ctypes.data, _tabs().ctypes.data, pptr.ctypes.data,
        blk.ctypes.data, coef.ctypes.data, pal.ctypes.data,
        palidx.ctypes.data, res_buf.ctypes.data, offs.ctypes.data,
        dd.ctypes.data, ii_buf.ctypes.data, ii_off.ctypes.data)
