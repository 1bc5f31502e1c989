"""Wrappers of the two hand-written CUDA kernels of unit MC with the
destination write fused:

- ``mc_units_plane`` / ``mc_units_slots``: ``csrc/mc_units.cu``,
  translational unit MC (any of the four (has_h, has_v) cases, put or
  prep) written into a plane or into whole slots of a slot buffer;
- ``mc_scaled_plane`` / ``mc_scaled_slots``: ``csrc/mc_scaled.cu``,
  scaled-reference unit MC written into a plane or at flat offsets of a
  slot buffer; its rows must keep AV1's scale limits (phases 0..1023,
  steps 1..2048), as the planner makes them.

Each takes the arguments of its plain version in ``ops/mc.py`` and
updates its destination in place. A destination on the CPU goes to the
plain version; on a CUDA device to the kernel, or the call raises.
Descriptors are read in place as int16 or int32 (the frame's descriptor
buffers). The libraries are built and loaded by ``ops/cuda_build.py``;
each keeps the subpel table in ``__constant__`` memory, uploaded once per
device. ``UNITS_LAUNCHES`` and ``SCALED_LAUNCHES`` count the launches.
No wrapper reads a device tensor back to the host.
"""
from __future__ import annotations

import ctypes as ct
import threading

import torch

from . import mc
from .cuda_build import check, cuda_device, load_on, raise_on

UNITS_LAUNCHES = 0
SCALED_LAUNCHES = 0

_count_lock = threading.Lock()
_DESC = (torch.int16, torch.int32)
# csrc/mc_units.cu flags: which descriptors are int16
ARR16, YS16, XS16 = 1, 2, 4


class UnitsArgs(ct.Structure):
    """csrc/mc_units.cu McuArgs."""
    _fields_ = [("ref", ct.c_void_p), ("arr", ct.c_void_p),
                ("ys", ct.c_void_p), ("xs", ct.c_void_p),
                ("dst", ct.c_void_p), ("ref_pstride", ct.c_longlong)] + [
        (n, ct.c_int) for n in (
            "ref_rstride", "H", "W", "B", "uw", "uh", "has_h", "has_v", "ib",
            "bias", "bd_max", "prep", "flags", "dst_h", "dst_w",
            "dst_rstride")]


class ScaledArgs(ct.Structure):
    """csrc/mc_scaled.cu McsArgs."""
    _fields_ = [("ref", ct.c_void_p), ("rows", ct.c_void_p),
                ("ys", ct.c_void_p), ("xs", ct.c_void_p),
                ("dst", ct.c_void_p), ("ref_pstride", ct.c_longlong),
                ("dst_n", ct.c_longlong)] + [
        (n, ct.c_int) for n in (
            "ref_rstride", "H", "W", "B", "uw", "uh", "ib", "bias", "bd_max",
            "prep", "dst_h", "dst_w", "dst_rstride", "row_w")]


def _bind(lib, name, args_t):
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ct.c_int
    fn.argtypes = [ct.POINTER(args_t), ct.c_void_p]
    size = getattr(lib, f"{name}_args_size")
    size.restype = ct.c_int
    size.argtypes = []
    if size() != ct.sizeof(args_t):
        raise RuntimeError(f"{name}: its argument struct is {size()} "
                           f"bytes, the ctypes mirror {ct.sizeof(args_t)}")


def _ref_fields(a, ref_stack, dev):
    """The reference stack (R, H, W) int32 with unit column stride: a
    strided view (a scaled reference's crop) is read in place."""
    check(ref_stack, "ref_stack", torch.int32, 3, dev, contiguous=False)
    if ref_stack.stride(2) != 1:
        raise ValueError("ref_stack: columns not contiguous")
    a.ref = ref_stack.data_ptr()
    a.ref_pstride, a.ref_rstride = ref_stack.stride(0), ref_stack.stride(1)
    _, a.H, a.W = ref_stack.shape


def _plane_fields(a, plane, dev):
    check(plane, "plane", torch.int32, 2, dev, contiguous=False)
    if plane.stride(1) != 1:
        raise ValueError("plane: columns not contiguous")
    a.dst = plane.data_ptr()
    a.dst_h, a.dst_w = plane.shape
    a.dst_rstride = plane.stride(0)


def _column(t, name, B, dev, dtype=_DESC):
    """Check a (B,) descriptor column; 1 if it is int16."""
    check(t, name, dtype, 1, dev)
    if t.shape[0] != B:
        raise ValueError(f"{name}: {t.shape[0]} rows, expected {B}")
    return int(t.dtype == torch.int16)


def _bd_fields(a, bitdepth, prep):
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    a.ib = mc.ibits(bitdepth)
    a.bias = 0 if bitdepth == 8 else 8192
    a.bd_max = (1 << bitdepth) - 1
    a.prep = int(bool(prep))


def _launch(name, a, dev):
    """One launch of library `name`'s kernel on the argument struct `a`
    (none for an empty bucket); counts it."""
    global UNITS_LAUNCHES, SCALED_LAUNCHES
    if a.B == 0:
        return
    with torch.cuda.device(dev):
        lib = load_on(name, lambda lib: _bind(lib, name, type(a)), dev,
                      mc.SUBPEL)
        rc = getattr(lib, f"{name}_launch")(
            ct.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, name, rc)
    with _count_lock:
        if name == "mc_units":
            UNITS_LAUNCHES += 1
        else:
            SCALED_LAUNCHES += 1


def _units_args(ref_stack, arr, uw, uh, has_h, has_v, bitdepth, prep, dev):
    a = UnitsArgs()
    _ref_fields(a, ref_stack, dev)
    check(arr, "arr", _DESC, 2, dev)
    if arr.shape[1] != 6:
        raise ValueError(f"arr: shape {tuple(arr.shape)}, expected (B, 6)")
    if uw < 1 or uh < 1:
        raise ValueError(f"unit {uw}x{uh}")
    a.arr = arr.data_ptr()
    a.B, a.uw, a.uh = arr.shape[0], uw, uh
    a.has_h, a.has_v = int(bool(has_h)), int(bool(has_v))
    a.flags = ARR16 if arr.dtype == torch.int16 else 0
    _bd_fields(a, bitdepth, prep)
    return a


def mc_units_plane(plane, ref_stack, arr, ys, xs, uw: int, uh: int,
                   has_h: bool, has_v: bool, bitdepth: int,
                   prep: bool = False):
    """plane (H, W) int32 (unit column stride); ref_stack (R, H', W')
    int32; arr (B, 6) int16 or int32 rows (ref, oy, ox, mx, my, f2d);
    ys, xs (B,) int16 or int32. See ``ops/mc.mc_units_plane``."""
    if plane.device.type == "cpu":
        return mc.mc_units_plane(plane, ref_stack, arr, ys, xs, uw, uh,
                                 has_h, has_v, bitdepth, prep)
    dev = cuda_device(plane, "mc_units_plane")
    a = _units_args(ref_stack, arr, uw, uh, has_h, has_v, bitdepth, prep,
                    dev)
    _plane_fields(a, plane, dev)
    a.flags |= YS16 * _column(ys, "ys", a.B, dev) | \
        XS16 * _column(xs, "xs", a.B, dev)
    a.ys, a.xs = ys.data_ptr(), xs.data_ptr()
    _launch("mc_units", a, dev)
    return plane


def mc_units_slots(buf, ref_stack, arr, slots, has_h: bool, has_v: bool,
                   bitdepth: int, prep: bool):
    """buf (N, bhp, bwp) int32, contiguous; slots (B,) int16 or int32.
    See ``ops/mc.mc_units_slots``."""
    if buf.device.type == "cpu":
        return mc.mc_units_slots(buf, ref_stack, arr, slots, has_h, has_v,
                                 bitdepth, prep)
    dev = cuda_device(buf, "mc_units_slots")
    check(buf, "buf", torch.int32, 3, dev)
    N, uh, uw = buf.shape
    a = _units_args(ref_stack, arr, uw, uh, has_h, has_v, bitdepth, prep,
                    dev)
    a.flags |= YS16 * _column(slots, "slots", a.B, dev)
    a.ys, a.xs, a.dst, a.dst_h = slots.data_ptr(), None, buf.data_ptr(), N
    _launch("mc_units", a, dev)
    return buf


def _scaled_args(ref_stack, rows, uw, uh, bitdepth, prep, dev):
    a = ScaledArgs()
    _ref_fields(a, ref_stack, dev)
    check(rows, "rows", torch.int32, 2, dev)
    if rows.shape[1] != 9:
        raise ValueError(f"rows: shape {tuple(rows.shape)}, expected (B, 9)")
    if uw < 1 or uh < 1:
        raise ValueError(f"unit {uw}x{uh}")
    a.rows = rows.data_ptr()
    a.B, a.uw, a.uh = rows.shape[0], uw, uh
    _bd_fields(a, bitdepth, prep)
    return a


def mc_scaled_plane(plane, ref_stack, rows, ys, xs, uw: int, uh: int,
                    bitdepth: int, prep: bool = False):
    """plane (H, W) int32 (unit column stride); ref_stack (R, H', W')
    int32 (unit column stride, rows and planes read at their strides);
    rows (B, 9) int32; ys, xs (B,) int32. See ``ops/mc.mc_scaled_plane``."""
    if plane.device.type == "cpu":
        return mc.mc_scaled_plane(plane, ref_stack, rows, ys, xs, uw, uh,
                                  bitdepth, prep)
    dev = cuda_device(plane, "mc_scaled_plane")
    a = _scaled_args(ref_stack, rows, uw, uh, bitdepth, prep, dev)
    _plane_fields(a, plane, dev)
    _column(ys, "ys", a.B, dev, torch.int32)
    _column(xs, "xs", a.B, dev, torch.int32)
    a.ys, a.xs = ys.data_ptr(), xs.data_ptr()
    _launch("mc_scaled", a, dev)
    return plane


def mc_scaled_slots(buf, ref_stack, rows, base, uw: int, uh: int,
                    bitdepth: int, prep: bool):
    """buf (N, bhp, bwp) int32, contiguous; base (B,) int32 flat offsets.
    See ``ops/mc.mc_scaled_slots``."""
    if buf.device.type == "cpu":
        return mc.mc_scaled_slots(buf, ref_stack, rows, base, uw, uh,
                                  bitdepth, prep)
    dev = cuda_device(buf, "mc_scaled_slots")
    check(buf, "buf", torch.int32, 3, dev)
    a = _scaled_args(ref_stack, rows, uw, uh, bitdepth, prep, dev)
    _column(base, "base", a.B, dev, torch.int32)
    a.ys, a.xs, a.dst = base.data_ptr(), None, buf.data_ptr()
    a.dst_n, a.row_w = buf.numel(), buf.shape[2]
    _launch("mc_scaled", a, dev)
    return buf
