"""Wrapper of the hand-written CUDA inverse-transform kernel
(``csrc/itx.cu``): one launch per run of a frame's residual records (a
work list of buckets, ``ops/itx.build_table``), from the compact
coefficients to the planes.

``itx_run`` takes the arguments of its plain version ``ops/itx.itx_run``:
the run's table (a slice of the frame's int32 descriptor buffer), its
work counts, the int32 and int16 descriptor buffers the table's offsets
count from, and the destination planes or the hres views. ``itx_bucket``
takes those of ``ops/itx.itx_bucket`` (one bucket, modes "add", "raw" and
"hres"; compact or dense coefficients) and runs it as a one-entry list
through the same kernel (the parallel paths call it). A tensor on the CPU
goes to the plain version; a CUDA tensor goes to the kernel, or the call
raises. The library is built and loaded by ``ops/cuda_build.py``.
``ITX_LAUNCHES`` counts the launches, ``ITX_ENTRIES`` the table entries
they ran. The wrapper reads no device tensor back to the host.
"""
from __future__ import annotations

import ctypes as ct
import functools
import threading

import torch

from . import itx
from .cuda_build import check, cuda_device, load, raise_on
from .itx_meta import TX_INFO, WHT_WHT
from .spec_consts import clip_ranges

ITX_LAUNCHES = 0
ITX_ENTRIES = 0

_count_lock = threading.Lock()
_MODES = {"add": 0, "raw": 1, "hres": 2}
_DST_KINDS = {torch.int32: 0, torch.int16: 1, torch.uint8: 2}
MAX_PLANES = 3
# CTAs a launch: at most this many an SM, walking the work items
CTAS_PER_SM = 8
# the base pointers the entry offsets count from (csrc/itx.cu B_*)
(B_VALS32, B_VALS16, B_POS32, B_POS16, B_RSEL, B_CSEL, B_YS,
 B_XS) = range(8)


class RunArgs(ct.Structure):
    """csrc/itx.cu ItxRunArgs."""
    _fields_ = [("tab", ct.c_void_p), ("map", ct.c_void_p),
                ("base", ct.c_void_p * 8),
                ("dst", ct.c_void_p * MAX_PLANES), ("hres", ct.c_void_p),
                ("n_work", ct.c_int), ("mode", ct.c_int),
                ("hres_kind", ct.c_int), ("H", ct.c_int * MAX_PLANES),
                ("W", ct.c_int * MAX_PLANES), ("kind", ct.c_int * MAX_PLANES),
                ("row_min", ct.c_int), ("row_max", ct.c_int),
                ("col_min", ct.c_int), ("col_max", ct.c_int),
                ("pix_max", ct.c_int), ("one", ct.c_int * itx.ENTRY)]


def _bind(lib):
    lib.itx_run_launch.restype = ct.c_int
    lib.itx_run_launch.argtypes = [ct.POINTER(RunArgs), ct.c_int,
                                   ct.c_void_p]
    lib.itx_args_size.restype = ct.c_int
    lib.itx_args_size.argtypes = []
    if lib.itx_args_size() != ct.sizeof(RunArgs):
        raise RuntimeError(f"itx: ItxRunArgs is {lib.itx_args_size()} "
                           f"bytes, its ctypes mirror {ct.sizeof(RunArgs)}")


@functools.lru_cache(maxsize=None)
def _max_ctas(index):
    return CTAS_PER_SM * torch.cuda.get_device_properties(
        index).multi_processor_count


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _args(mode, bitdepth, planes=(), hres=None):
    a = RunArgs()
    a.mode = _MODES[mode]
    a.row_min, a.row_max, a.col_min, a.col_max = clip_ranges(bitdepth)
    a.pix_max = (1 << bitdepth) - 1
    for i, p in enumerate(planes):
        a.dst[i] = p.data_ptr()
        a.H[i], a.W[i] = p.shape
        a.kind[i] = _DST_KINDS[p.dtype]
    if hres is not None:
        a.hres = hres.data_ptr()
        a.hres_kind = _DST_KINDS[hres.dtype]
    return a


def _launch(dev, a, work):
    """One launch over `work` = (entries, work items); counts it and its
    entries."""
    global ITX_LAUNCHES, ITX_ENTRIES
    a.n_work = work[1]
    with torch.cuda.device(dev):
        lib = load("itx", _bind)
        rc = lib.itx_run_launch(
            ct.byref(a), min(work[1], _max_ctas(dev.index)),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "itx", rc)
    with _count_lock:
        ITX_LAUNCHES += 1
        ITX_ENTRIES += work[0]


def _check_planes(planes, dev):
    if len(planes) > MAX_PLANES:
        raise ValueError(f"itx: {len(planes)} planes, at most {MAX_PLANES}")
    for i, p in enumerate(planes):
        check(p, f"planes[{i}]", tuple(_DST_KINDS), 2, dev)


def itx_run(mode: str, tab, work, desc, desc16, bitdepth: int, planes=(),
            hres_views=(), hres_dtype=torch.int32):
    """One run's work list; see ``ops/itx.itx_run`` for the arguments.
    Returns the hres views (hres mode; views into one flat output
    allocated here) or None (the planes updated in place)."""
    if tab.device.type == "cpu":
        return itx.itx_run(mode, tab, work, desc, desc16, bitdepth, planes,
                           hres_views, hres_dtype)
    dev = cuda_device(tab, "itx_run")
    if mode not in _MODES:
        raise ValueError(f"itx_run: mode {mode!r}")
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    n_entries, n_items = work
    check(tab, "tab", torch.int32, 1, dev)
    if tab.shape[0] != n_entries * itx.ENTRY + n_items:
        raise ValueError(f"tab: {tab.shape[0]} ints for work {work}")
    check(desc, "desc", torch.int32, 1, dev)
    check(desc16, "desc16", torch.int16, 1, dev)
    views = hres = None
    if mode == "hres":
        if hres_dtype not in (torch.int16, torch.int32):
            raise TypeError(f"hres_dtype {hres_dtype}")
        if len(hres_views) != n_entries:
            raise ValueError(f"hres_views: {len(hres_views)} for "
                             f"{n_entries} entries")
        hres, views = itx.hres_flat(hres_views, hres_dtype, dev)
    else:
        _check_planes(planes, dev)
    if n_items == 0:
        return views
    a = _args(mode, bitdepth, planes, hres)
    a.tab = tab.data_ptr()
    a.map = tab.data_ptr() + 4 * n_entries * itx.ENTRY
    b32, b16 = desc.data_ptr(), desc16.data_ptr()
    for i, b in enumerate((b32, b16, b32, b16, b32, b32, b32, b32)):
        a.base[i] = b
    _launch(dev, a, work)
    return views


def itx_bucket(mode: str, vals, pos, sel, tx: int, bitdepth: int,
               plane=None, ys=None, xs=None, out_dtype=torch.int32):
    """One residual bucket; see ``ops/itx.itx_bucket`` for the arguments.
    Returns the plane (add, raw; updated in place) or the new (B, h, w)
    residuals (hres)."""
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
    flags = 0
    if pos is None:
        if K != min(w, 32) * min(h, 32):
            raise ValueError(f"vals: dense width {K} for a {w}x{h} block")
        flags |= itx.F_DENSE
    else:
        check(pos, "pos", torch.int32, 2, dev)
        if tuple(pos.shape) != (B, K):
            raise ValueError(f"pos: shape {tuple(pos.shape)} != {(B, K)}")
    row_sel = col_sel = None
    if isinstance(sel, tuple):
        row_sel, col_sel = sel
        for nm, t in (("row_sel", row_sel), ("col_sel", col_sel)):
            check(t, nm, torch.int32, 1, dev)
            if t.shape[0] != B:
                raise ValueError(f"{nm}: {t.shape[0]} rows, expected {B}")
        rsel = csel = 0
    elif int(sel) == WHT_WHT:
        if tx != 0:
            raise ValueError("WHT_WHT is a 4x4 transform")
        flags |= itx.F_WHT | itx.F_FIXED
        rsel = csel = 0
    else:
        flags |= itx.F_FIXED
        rsel, csel = itx.itx_multi_sel(tx, sel)
    if mode == "hres":
        if out_dtype not in (torch.int16, torch.int32):
            raise TypeError(f"out_dtype {out_dtype}")
        dst = torch.empty((B, h, w), dtype=out_dtype, device=dev)
        planes = ()
    else:
        check(plane, "plane", tuple(_DST_KINDS), 2, dev)
        for nm, t in (("ys", ys), ("xs", xs)):
            check(t, nm, torch.int32, 1, dev)
            if t.shape[0] != B:
                raise ValueError(f"{nm}: {t.shape[0]} rows, expected {B}")
        dst = plane
        planes = (plane,)
    if B == 0:
        return dst
    a = _args(mode, bitdepth, planes, dst if mode == "hres" else None)
    for i, t in ((B_VALS32, vals), (B_POS32, pos), (B_RSEL, row_sel),
                 (B_CSEL, col_sel), (B_YS, ys), (B_XS, xs)):
        a.base[i] = _ptr(t)
    one = [0] * itx.ENTRY
    one[itx.E_TX], one[itx.E_FLAGS] = tx, flags
    one[itx.E_K], one[itx.E_B], one[itx.E_NREAL] = K, B, B
    one[itx.E_RSEL], one[itx.E_CSEL] = rsel, csel
    a.one[:] = one
    _launch(dev, a, (1, -(-B // itx.cta_geometry(tx)[1])))
    return dst
