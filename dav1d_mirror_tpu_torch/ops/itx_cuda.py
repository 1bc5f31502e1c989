"""Wrapper of the hand-written CUDA inverse-transform kernel
(``csrc/itx.cu``): one launch per residual bucket, from the compact
coefficients to the plane.

``itx_bucket`` takes the arguments of its plain version
``ops/itx.itx_bucket`` (modes "add", "raw" and "hres"; compact or dense
coefficients). A tensor on the CPU goes to the plain version; a CUDA
tensor goes to the kernel, or the call raises. The library is built and
loaded by ``ops/cuda_build.py``. ``ITX_LAUNCHES`` counts the launches.
The wrapper reads no device tensor back to the host.
"""
from __future__ import annotations

import ctypes as ct
import threading

import torch

from . import itx
from .cuda_build import check, cuda_device, load, raise_on
from .itx_meta import TX_INFO, WHT_WHT
from .spec_consts import clip_ranges

ITX_LAUNCHES = 0

_count_lock = threading.Lock()
_MODES = {"add": 0, "raw": 1, "hres": 2}
_DST_KINDS = {torch.int32: 0, torch.int16: 1, torch.uint8: 2}


def _bind(lib):
    vp = ct.c_void_p
    lib.itx_launch.restype = ct.c_int
    lib.itx_launch.argtypes = [vp] * 7 + [ct.c_int] * 15 + [vp]


def _ptr(t):
    return None if t is None else t.data_ptr()


def itx_bucket(mode: str, vals, pos, sel, tx: int, bitdepth: int,
               plane=None, ys=None, xs=None, out_dtype=torch.int32):
    """One residual bucket; see ``ops/itx.itx_bucket`` for the arguments.
    Returns the plane (add, raw; updated in place) or the new (B, h, w)
    residuals (hres)."""
    global ITX_LAUNCHES
    if vals.device.type == "cpu":
        return itx.itx_bucket(mode, vals, pos, sel, tx, bitdepth, plane,
                              ys, xs, out_dtype)
    dev = cuda_device(vals, "itx_bucket")
    if mode not in _MODES:
        raise ValueError(f"itx_bucket: mode {mode!r}")
    if tx not in TX_INFO:
        raise ValueError(f"itx_bucket: tx {tx}")
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    w, h, _ = TX_INFO[tx]
    check(vals, "vals", torch.int32, 2, dev)
    B, K = vals.shape
    if pos is None:
        if K != min(w, 32) * min(h, 32):
            raise ValueError(f"vals: dense width {K} for a {w}x{h} block")
    else:
        check(pos, "pos", torch.int32, 2, dev)
        if tuple(pos.shape) != (B, K):
            raise ValueError(f"pos: shape {tuple(pos.shape)} != {(B, K)}")
    row_sel = col_sel = None
    wht = False
    if isinstance(sel, tuple):
        row_sel, col_sel = sel
        for nm, t in (("row_sel", row_sel), ("col_sel", col_sel)):
            check(t, nm, torch.int32, 1, dev)
            if t.shape[0] != B:
                raise ValueError(f"{nm}: {t.shape[0]} rows, expected {B}")
        row_fix = col_fix = 0
    else:
        wht = int(sel) == WHT_WHT
        if wht and tx != 0:
            raise ValueError("WHT_WHT is a 4x4 transform")
        row_fix, col_fix = (0, 0) if wht else itx.itx_multi_sel(tx, sel)
    if mode == "hres":
        if out_dtype not in (torch.int16, torch.int32):
            raise TypeError(f"out_dtype {out_dtype}")
        dst = torch.empty((B, h, w), dtype=out_dtype, device=dev)
        H = W = 0
        ys_p = xs_p = None
    else:
        check(plane, "plane", tuple(_DST_KINDS), 2, dev)
        for nm, t in (("ys", ys), ("xs", xs)):
            check(t, nm, torch.int32, 1, dev)
            if t.shape[0] != B:
                raise ValueError(f"{nm}: {t.shape[0]} rows, expected {B}")
        dst = plane
        H, W = plane.shape
        ys_p, xs_p = ys.data_ptr(), xs.data_ptr()
    if B == 0:
        return dst
    row_min, row_max, col_min, col_max = clip_ranges(bitdepth)
    with torch.cuda.device(dev):
        lib = load("itx", _bind)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.itx_launch(
            vals.data_ptr(), _ptr(pos), _ptr(row_sel), _ptr(col_sel), ys_p,
            xs_p, dst.data_ptr(), K, row_fix, col_fix,
            _DST_KINDS[dst.dtype], H, W, B, tx, _MODES[mode], int(wht),
            row_min, row_max, col_min, col_max, (1 << bitdepth) - 1, stream)
    raise_on(lib, "itx", rc)
    with _count_lock:
        ITX_LAUNCHES += 1
    return dst

