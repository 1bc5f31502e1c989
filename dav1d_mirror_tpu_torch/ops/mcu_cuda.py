"""Wrappers of the two hand-written CUDA kernels of unit MC with the
destination write fused, each a work-list kernel (one launch a run):

- ``mc_units_run``: ``csrc/mc_units.cu``, translational unit MC (any of
  the four (has_h, has_v) cases, put or prep) of every entry of a run's
  table (``ops/mc.mc_build_table``: a frame's put records and "t"
  sub-ops), written into the planes or into whole slots of the frame's
  slot arena;
- ``mc_scaled_run``: ``csrc/mc_scaled.cu``, scaled-reference unit MC of
  a run's entries (the frame's scaled records and "s" sub-ops), written
  into the planes or at flat offsets of the arena's slot buffers; its
  rows must keep AV1's scale limits (phases 0..1023, steps 1..2048), as
  the planner makes them.

Each takes the arguments of its plain version in ``ops/mc.py`` and
updates its destinations in place. The one-bucket forms
``mc_units_plane``, ``mc_units_slots``, ``mc_scaled_plane`` and
``mc_scaled_slots`` (the tile-sharded decode's calls) take those of
their plain versions and run as one-entry lists through the same
kernels. A tensor on the CPU goes to the plain version; a CUDA tensor to
the kernel, or the call raises. Descriptors are read in place as int16
or int32 (the frame's descriptor buffers). The libraries are built and
loaded by ``ops/cuda_build.py``; each keeps the subpel table in
``__constant__`` memory, uploaded once per device. ``UNITS_LAUNCHES`` and
``SCALED_LAUNCHES`` count the launches, ``UNITS_ENTRIES`` and
``SCALED_ENTRIES`` the entries they ran. No wrapper reads a device
tensor back to the host.
"""
from __future__ import annotations

import ctypes as ct
import threading

import torch

from . import mc
from .cuda_build import check, cuda_device, load_on, raise_on

UNITS_LAUNCHES = 0
SCALED_LAUNCHES = 0
UNITS_ENTRIES = 0
SCALED_ENTRIES = 0

_count_lock = threading.Lock()
_DESC = (torch.int16, torch.int32)
# the reference stacks and planes a run can name (csrc/mc_units.cu
# MU_REFS, MU_PLANES; csrc/mc_scaled.cu MS_REFS: srefspec views a frame)
UNITS_REFS = 3
SCALED_REFS = 24
MAX_PLANES = 3


def _fields(n_refs, base_t):
    P, I, L = ct.c_void_p, ct.c_int, ct.c_longlong
    return ([("tab", P), ("map", P)] + base_t +
            [("ref", P * n_refs), ("plane", P * MAX_PLANES), ("arena", P),
             ("ref_pstride", L * n_refs), ("arena_n", L),
             ("ref_rstride", I * n_refs), ("ref_h", I * n_refs),
             ("ref_w", I * n_refs), ("plane_h", I * MAX_PLANES),
             ("plane_w", I * MAX_PLANES), ("plane_rstride", I * MAX_PLANES)] +
            [(n, I) for n in ("n_items", "stage_ints", "mid_ints", "ib",
                              "bias", "bd_max")] +
            [("one", I * mc.MENTRY)])


class UnitsArgs(ct.Structure):
    """csrc/mc_units.cu McuRunArgs."""
    _fields_ = _fields(UNITS_REFS, [("base32", ct.c_void_p * 3),
                                    ("base16", ct.c_void_p * 3)])


class ScaledArgs(ct.Structure):
    """csrc/mc_scaled.cu McsRunArgs."""
    _fields_ = _fields(SCALED_REFS, [("base", ct.c_void_p * 3)])


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


def _refs(a, refs, n_max, dev):
    """The reference stacks (R, H, W) int32 with unit column stride: a
    strided view (a scaled reference's crop) is read in place."""
    if len(refs) > n_max:
        raise ValueError(f"{len(refs)} reference stacks, at most {n_max}")
    for i, r in enumerate(refs):
        check(r, f"refs[{i}]", torch.int32, 3, dev, contiguous=False)
        if r.stride(2) != 1:
            raise ValueError(f"refs[{i}]: columns not contiguous")
        a.ref[i] = r.data_ptr()
        a.ref_pstride[i], a.ref_rstride[i] = r.stride(0), r.stride(1)
        _, a.ref_h[i], a.ref_w[i] = r.shape


def _planes(a, planes, dev):
    if len(planes) > MAX_PLANES:
        raise ValueError(f"{len(planes)} planes, at most {MAX_PLANES}")
    for i, p in enumerate(planes):
        check(p, f"planes[{i}]", torch.int32, 2, dev, contiguous=False)
        if p.stride(1) != 1:
            raise ValueError(f"planes[{i}]: columns not contiguous")
        a.plane[i] = p.data_ptr()
        a.plane_h[i], a.plane_w[i] = p.shape
        a.plane_rstride[i] = p.stride(0)


def _arena(a, arena, dev):
    if arena is not None:
        check(arena, "arena", torch.int32, 1, dev)
        a.arena, a.arena_n = arena.data_ptr(), arena.numel()


def _bd_fields(a, bitdepth):
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    a.ib = mc.ibits(bitdepth)
    a.bias = 0 if bitdepth == 8 else 8192
    a.bd_max = (1 << bitdepth) - 1


def _launch(name, a, dev, n_entries):
    """One launch of library `name`'s kernel on the argument struct `a`
    (none for an empty list); counts it and its entries."""
    global UNITS_LAUNCHES, SCALED_LAUNCHES, UNITS_ENTRIES, SCALED_ENTRIES
    if a.n_items == 0:
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
            UNITS_ENTRIES += n_entries
        else:
            SCALED_LAUNCHES += 1
            SCALED_ENTRIES += n_entries


def _run_args(args_t, tab, work, dev, bitdepth):
    """The argument struct of a run: its table and item map, counts and
    bit depth."""
    check(tab, "tab", torch.int32, 1, dev)
    n_entries, n_items, stage, mid = work
    if tab.shape[0] != n_entries * mc.MENTRY + 2 * n_items:
        raise ValueError(f"tab: {tab.shape[0]} ints for work {work}")
    a = args_t()
    a.tab = tab.data_ptr()
    a.map = tab.data_ptr() + 4 * n_entries * mc.MENTRY
    a.n_items, a.stage_ints, a.mid_ints = n_items, stage, mid
    _bd_fields(a, bitdepth)
    return a


def mc_units_run(tab, work, desc, desc16, planes, refs, arena,
                 bitdepth: int):
    """One run's work list of translational unit MC; see
    ``ops/mc.mc_units_run`` for the arguments (arena may be None when no
    entry writes slots). Updates planes and arena in place."""
    if tab.device.type == "cpu":
        return mc.mc_units_run(tab, work, desc, desc16, planes, refs, arena,
                               bitdepth)
    dev = cuda_device(tab, "mc_units_run")
    a = _run_args(UnitsArgs, tab, work, dev, bitdepth)
    check(desc, "desc", torch.int32, 1, dev)
    check(desc16, "desc16", torch.int16, 1, dev)
    for i in range(3):
        a.base32[i], a.base16[i] = desc.data_ptr(), desc16.data_ptr()
    _refs(a, refs, UNITS_REFS, dev)
    _planes(a, planes, dev)
    _arena(a, arena, dev)
    _launch("mc_units", a, dev, work[0])


def mc_scaled_run(tab, work, desc, planes, srefs, arena, bitdepth: int):
    """One run's work list of scaled unit MC; see ``ops/mc.mc_scaled_run``
    for the arguments. Updates planes and arena in place."""
    if tab.device.type == "cpu":
        return mc.mc_scaled_run(tab, work, desc, planes, srefs, arena,
                                bitdepth)
    dev = cuda_device(tab, "mc_scaled_run")
    a = _run_args(ScaledArgs, tab, work, dev, bitdepth)
    check(desc, "desc", torch.int32, 1, dev)
    for i in range(3):
        a.base[i] = desc.data_ptr()
    _refs(a, srefs, SCALED_REFS, dev)
    _planes(a, planes, dev)
    _arena(a, arena, dev)
    _launch("mc_scaled", a, dev, work[0])


# ---------------------------------------------------------------------
# the one-bucket forms: one-entry lists through the same kernels
# ---------------------------------------------------------------------
def _column(t, name, B, dev, dtype=_DESC):
    """Check a (B,) descriptor column; 1 if it is int16."""
    check(t, name, dtype, 1, dev)
    if t.shape[0] != B:
        raise ValueError(f"{name}: {t.shape[0]} rows, expected {B}")
    return int(t.dtype == torch.int16)


def _one(args_t, scaled, ref_stack, desc, n_cols, uw, uh, flags, bitdepth,
         dev):
    """The argument struct of a one-entry list over the (B, n_cols) rows
    `desc` from reference stack `ref_stack`; its entry's flags and
    geometry set, its pointers the caller's."""
    check(desc, "rows" if scaled else "arr",
          torch.int32 if scaled else _DESC, 2, dev)
    if desc.shape[1] != n_cols:
        raise ValueError(f"descriptors: shape {tuple(desc.shape)}, "
                         f"expected (B, {n_cols})")
    B = desc.shape[0]
    tiles, g, win, mid = mc.mc_geometry(scaled, uw, uh, flags & mc.MF_H,
                                        flags & mc.MF_V)
    a = args_t()
    a.one[mc.M_UW], a.one[mc.M_UH], a.one[mc.M_B] = uw, uh, B
    a.one[mc.M_NREAL], a.one[mc.M_G] = B, g
    a.one[mc.M_FLAGS] = flags | (mc.MF_DESC16 if desc.dtype == torch.int16
                                 else 0)
    a.n_items = -(-B // g) * tiles
    a.stage_ints, a.mid_ints = min(g, max(B, 1)) * win, min(g, max(B, 1)) * mid
    _refs(a, [ref_stack], 1, dev)
    _bd_fields(a, bitdepth)
    return a


def _unit_flags(has_h, has_v, prep):
    return (mc.MF_H * bool(has_h) | mc.MF_V * bool(has_v) |
            mc.MF_PREP * bool(prep))


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
    a = _one(UnitsArgs, False, ref_stack, arr, 6, uw, uh,
             _unit_flags(has_h, has_v, prep), bitdepth, dev)
    B = arr.shape[0]
    a.one[mc.M_FLAGS] |= mc.MF_YS16 * _column(ys, "ys", B, dev) | \
        mc.MF_XS16 * _column(xs, "xs", B, dev)
    for i, t in enumerate((arr, ys, xs)):
        a.base32[i] = a.base16[i] = t.data_ptr()
    _planes(a, [plane], dev)
    _launch("mc_units", a, dev, 1)
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
    _, uh, uw = buf.shape
    a = _one(UnitsArgs, False, ref_stack, arr, 6, uw, uh,
             _unit_flags(has_h, has_v, prep) | mc.MF_ARENA, bitdepth, dev)
    a.one[mc.M_FLAGS] |= mc.MF_YS16 * _column(slots, "slots", arr.shape[0],
                                              dev)
    a.one[mc.M_DSTN] = buf.numel()
    for i, t in enumerate((arr, slots)):
        a.base32[i] = a.base16[i] = t.data_ptr()
    _arena(a, buf.view(-1), dev)
    _launch("mc_units", a, dev, 1)
    return buf


def mc_scaled_plane(plane, ref_stack, rows, ys, xs, uw: int, uh: int,
                    bitdepth: int, prep: bool = False):
    """plane (H, W) int32 (unit column stride); ref_stack (R, H', W')
    int32 (unit column stride, rows and planes read at their strides);
    rows (B, 9) int32; ys, xs (B,) int32. See ``ops/mc.mc_scaled_plane``."""
    if plane.device.type == "cpu":
        return mc.mc_scaled_plane(plane, ref_stack, rows, ys, xs, uw, uh,
                                  bitdepth, prep)
    dev = cuda_device(plane, "mc_scaled_plane")
    a = _one(ScaledArgs, True, ref_stack, rows, 9, uw, uh,
             _unit_flags(0, 0, prep), bitdepth, dev)
    _column(ys, "ys", rows.shape[0], dev, torch.int32)
    _column(xs, "xs", rows.shape[0], dev, torch.int32)
    for i, t in enumerate((rows, ys, xs)):
        a.base[i] = t.data_ptr()
    _planes(a, [plane], dev)
    _launch("mc_scaled", a, dev, 1)
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
    a = _one(ScaledArgs, True, ref_stack, rows, 9, uw, uh,
             _unit_flags(0, 0, prep) | mc.MF_ARENA, bitdepth, dev)
    _column(base, "base", rows.shape[0], dev, torch.int32)
    a.one[mc.M_DSTN], a.one[mc.M_ROWW] = buf.numel(), buf.shape[2]
    for i, t in enumerate((rows, base)):
        a.base[i] = t.data_ptr()
    _arena(a, buf.view(-1), dev)
    _launch("mc_scaled", a, dev, 1)
    return buf
