"""Wrappers of the three hand-written CUDA kernels of the inter tools, each
one launch a record (or sub-op) of the frame program:

- ``warp_plane`` / ``warp_slots``: ``csrc/warp.cu``, the affine warp of a
  batch of 8x8 units (a ``warp`` record into the plane, or a "w" sub-op
  of a compound side into its slots of the frame's arena);
- ``comp_record``: ``csrc/comp.cu``, every join of a ``comp`` record
  (average, distance-weighted, wedge and seg masks) over its real slots,
  stored straight into the plane; seg luma joins write their chroma masks
  into the frame's seg-mask arena, where the chroma joins read them;
- ``obmc_plane``: ``csrc/obmc.cu``, the OBMC blend of an ``obmc``
  record's laps, in place on the plane.

Each takes the arguments of its plain version in ``ops/mc.py`` and
updates its destination in place. A tensor on the CPU goes to the plain
version; a CUDA tensor to the kernel, or the call raises (no fallback).
Descriptors are int32 views of the frame's buffers, read in place. The
libraries are built and loaded by ``ops/cuda_build.py``; the warp filter
table sits in the warp library's ``__constant__`` memory (int8, uploaded
once per device), and the OBMC kernel reads the one table the plain
version slices (``mc.obmc_mask_table``). ``WARP_LAUNCHES``,
``COMP_LAUNCHES`` and ``OBMC_LAUNCHES`` count the launches. No wrapper
reads a device tensor back to the host.
"""
from __future__ import annotations

import ctypes as ct
import threading

import numpy as np
import torch

from . import mc
from .cuda_build import check, cuda_device, load, load_on, raise_on

WARP_LAUNCHES = 0
COMP_LAUNCHES = 0
OBMC_LAUNCHES = 0

_count_lock = threading.Lock()
# the warp filter table as the kernel keeps it (csrc/warp.cu c_warp)
WARP_TABLE = np.ascontiguousarray(mc.WARP_FILTER, np.int8)
assert (WARP_TABLE == mc.WARP_FILTER).all()

_P, _I, _L = ct.c_void_p, ct.c_int, ct.c_longlong


class WarpArgs(ct.Structure):
    """csrc/warp.cu WarpArgs."""
    _fields_ = [(n, _P) for n in ("rows", "ys", "xs", "base", "ref",
                                  "dst")] + \
        [(n, _L) for n in ("ref_pstride", "dst_n")] + \
        [(n, _I) for n in ("ref_rstride", "ref_n", "ref_h", "ref_w",
                           "dst_h", "dst_w", "dst_rstride", "row_w", "B",
                           "ib", "bias", "bd_max", "prep")]


class CompArgs(ct.Structure):
    """csrc/comp.cu CompArgs."""
    _fields_ = [(n, _P) for n in ("tmp0", "tmp1", "tab", "dy", "dx",
                                  "masks", "desc", "plane")] + \
        [(n, _L) for n in ("masks_n", "desc_n")] + \
        [(n, _I) for n in ("plane_h", "plane_w", "plane_rstride", "n",
                           "bhp", "bwp", "ch", "cv", "bd", "ib", "bias",
                           "bd_max")]


class ObmcArgs(ct.Structure):
    """csrc/obmc.cu ObmcArgs."""
    _fields_ = [(n, _P) for n in ("plane", "laps", "ys", "xs", "masks")] + \
        [(n, _I) for n in ("plane_h", "plane_w", "plane_rstride", "n",
                           "lap_h", "lap_w", "region", "vert")]


def _binder(name, args_t):
    def bind(lib):
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ct.c_int
        fn.argtypes = [ct.POINTER(args_t), ct.c_void_p]
        size = getattr(lib, f"{name}_args_size")
        size.restype = ct.c_int
        size.argtypes = []
        if size() != ct.sizeof(args_t):
            raise RuntimeError(f"{name}: its argument struct is {size()} "
                               f"bytes, the ctypes mirror "
                               f"{ct.sizeof(args_t)}")
    return bind


def _launch(name, a, dev):
    """One launch of library `name`'s kernel on the argument struct `a`;
    counts it."""
    global WARP_LAUNCHES, COMP_LAUNCHES, OBMC_LAUNCHES
    bind = _binder(name, type(a))
    with torch.cuda.device(dev):
        lib = load_on(name, bind, dev, WARP_TABLE) if name == "warp" else \
            load(name, bind)
        rc = getattr(lib, f"{name}_launch")(
            ct.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, name, rc)
    with _count_lock:
        if name == "warp":
            WARP_LAUNCHES += 1
        elif name == "comp":
            COMP_LAUNCHES += 1
        else:
            OBMC_LAUNCHES += 1


def _plane(a, plane, dev, prefix):
    """The (H, W) int32 plane at its row stride (unit column stride)."""
    check(plane, "plane", torch.int32, 2, dev, contiguous=False)
    if plane.stride(1) != 1:
        raise ValueError("plane: columns not contiguous")
    h, w = plane.shape
    setattr(a, f"{prefix}_h", h)
    setattr(a, f"{prefix}_w", w)
    setattr(a, f"{prefix}_rstride", plane.stride(0))


def _column(t, name, n, dev):
    check(t, name, torch.int32, 1, dev)
    if t.shape[0] < n:
        raise ValueError(f"{name}: {t.shape[0]} rows, expected {n}")
    return t.data_ptr()


def _bd(a, bitdepth):
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    a.ib = mc.ibits(bitdepth)
    a.bias = 0 if bitdepth == 8 else 8192
    a.bd_max = (1 << bitdepth) - 1


def _warp_args(ref_stack, rows, bitdepth, prep, dev):
    check(ref_stack, "ref_stack", torch.int32, 3, dev, contiguous=False)
    if ref_stack.stride(2) != 1:
        raise ValueError("ref_stack: columns not contiguous")
    check(rows, "rows", torch.int32, 2, dev)
    if rows.shape[1] != 10:
        raise ValueError(f"rows: shape {tuple(rows.shape)}, expected "
                         f"(B, 10)")
    a = WarpArgs()
    a.rows, a.ref = rows.data_ptr(), ref_stack.data_ptr()
    a.ref_pstride, a.ref_rstride = ref_stack.stride(0), ref_stack.stride(1)
    a.ref_n, a.ref_h, a.ref_w = ref_stack.shape
    a.B, a.prep = rows.shape[0], int(bool(prep))
    _bd(a, bitdepth)
    return a


def warp_plane(plane, ref_stack, rows, ys, xs, bitdepth: int):
    """plane (H, W) int32 (unit column stride); ref_stack (R, H', W')
    int32 (unit column stride); rows (B, 10) int32; ys, xs (B,) int32.
    See ``ops/mc.warp_plane``."""
    if plane.device.type == "cpu":
        return mc.warp_plane(plane, ref_stack, rows, ys, xs, bitdepth)
    dev = cuda_device(plane, "warp_plane")
    a = _warp_args(ref_stack, rows, bitdepth, False, dev)
    a.ys = _column(ys, "ys", a.B, dev)
    a.xs = _column(xs, "xs", a.B, dev)
    _plane(a, plane, dev, "dst")
    a.dst = plane.data_ptr()
    if a.B:
        _launch("warp", a, dev)
    return plane


def warp_slots(buf, ref_stack, rows, base, bitdepth: int, prep: bool):
    """buf (N, bhp, bwp) int32, contiguous; base (B,) int32 flat offsets.
    See ``ops/mc.warp_slots``."""
    if buf.device.type == "cpu":
        return mc.warp_slots(buf, ref_stack, rows, base, bitdepth, prep)
    dev = cuda_device(buf, "warp_slots")
    check(buf, "buf", torch.int32, 3, dev)
    a = _warp_args(ref_stack, rows, bitdepth, prep, dev)
    a.base = _column(base, "base", a.B, dev)
    a.dst, a.dst_n, a.row_w = buf.data_ptr(), buf.numel(), buf.shape[2]
    if a.B:
        _launch("warp", a, dev)
    return buf


def comp_record(plane, tmp0, tmp1, tab, dy, dx, masks, desc, ss_hor: int,
                ss_ver: int, bitdepth: int):
    """plane (H, W) int32 (unit column stride); tmp0, tmp1 (N, bhp, bwp)
    int32, contiguous; tab (n, mc.CJ_COLS) int32; dy, dx (>= n,) int32;
    masks: the flat int32 seg-mask arena or None; desc: the flat int32
    descriptor buffer. See ``ops/mc.comp_record``. A slot whose mask
    span lies outside its buffer is dropped."""
    if plane.device.type == "cpu":
        return mc.comp_record(plane, tmp0, tmp1, tab, dy, dx, masks, desc,
                              ss_hor, ss_ver, bitdepth)
    dev = cuda_device(plane, "comp_record")
    check(tmp0, "tmp0", torch.int32, 3, dev)
    check(tmp1, "tmp1", torch.int32, 3, dev)
    if tmp0.shape != tmp1.shape:
        raise ValueError(f"sides {tuple(tmp0.shape)}, {tuple(tmp1.shape)}")
    check(tab, "tab", torch.int32, 2, dev)
    if tab.shape[1] != mc.CJ_COLS or tab.shape[0] > tmp0.shape[0]:
        raise ValueError(f"tab: shape {tuple(tab.shape)} for "
                         f"{tmp0.shape[0]} slots")
    a = CompArgs()
    a.n, a.bhp, a.bwp = tab.shape[0], tmp0.shape[1], tmp0.shape[2]
    # a thread a cell of the seg chroma mask: 2x2, 1x2 or 1x1 pixels
    a.ch, a.cv = int(bool(ss_hor)), int(bool(ss_hor and ss_ver))
    if a.bhp % (1 << a.cv) or a.bwp % (1 << a.ch):
        raise ValueError(f"slots {a.bwp}x{a.bhp} for layout "
                         f"({ss_hor}, {ss_ver})")
    a.tmp0, a.tmp1, a.tab = tmp0.data_ptr(), tmp1.data_ptr(), tab.data_ptr()
    a.dy = _column(dy, "dy", a.n, dev)
    a.dx = _column(dx, "dx", a.n, dev)
    if masks is not None:
        check(masks, "masks", torch.int32, 1, dev)
        a.masks, a.masks_n = masks.data_ptr(), masks.numel()
    check(desc, "desc", torch.int32, 1, dev)
    a.desc, a.desc_n = desc.data_ptr(), desc.numel()
    _plane(a, plane, dev, "plane")
    a.plane = plane.data_ptr()
    _bd(a, bitdepth)
    a.bd = bitdepth
    if a.n:
        _launch("comp", a, dev)
    return plane


def obmc_plane(plane, laps, ys, xs, region: int, vert: bool):
    """plane (H, W) int32 (unit column stride); laps (nL, lap_h, lap_w)
    int32, contiguous; ys, xs (nL,) int32. See ``ops/mc.obmc_plane``."""
    if plane.device.type == "cpu":
        return mc.obmc_plane(plane, laps, ys, xs, region, vert)
    dev = cuda_device(plane, "obmc_plane")
    check(laps, "laps", torch.int32, 3, dev)
    a = ObmcArgs()
    a.n, a.lap_h, a.lap_w = laps.shape
    n_mask = (region * 3) >> 2
    if region < 0 or region + n_mask > len(mc.OBMC_MASKS) or \
            n_mask > (a.lap_w if vert else a.lap_h):
        raise ValueError(f"region {region} for laps {a.lap_w}x{a.lap_h}")
    a.region, a.vert = region, int(bool(vert))
    a.ys = _column(ys, "ys", a.n, dev)
    a.xs = _column(xs, "xs", a.n, dev)
    a.laps, a.masks = laps.data_ptr(), mc.obmc_mask_table(dev).data_ptr()
    _plane(a, plane, dev, "plane")
    a.plane = plane.data_ptr()
    if a.n:
        _launch("obmc", a, dev)
    return plane
