"""Wrappers of the three hand-written CUDA kernels of the inter tools:

- ``warp_run``: ``csrc/warp.cu``, the affine warp of a frame's 8x8 warp
  units, one launch a frame over its work list (the ``warprun`` record:
  every ``warp`` record, into the planes, and every "w" sub-op of a
  compound side, into its slots of the frame's arena);
- ``comp_run``: ``csrc/comp.cu``, every join (average,
  distance-weighted, wedge and seg masks) of a frame's compound records
  over their real slots, one launch a frame over its work list (the
  ``comprun`` record: every ``comp`` record, of every plane), stored
  straight into the planes; a seg chroma join derives its mask from its
  luma slot's sides in the frame's arena;
- ``obmc_run``: ``csrc/obmc.cu``, the OBMC blend of one phase's laps
  (the ``obmcrun`` record: every ``obmc`` record of the phase, of every
  plane), in place on the planes, one launch a phase.

Each takes the arguments of its plain version in ``ops/mc.py`` and
updates its destinations in place. A tensor on the CPU goes to the plain
version; a CUDA tensor to the kernel, or the call raises (no fallback).
Descriptors and work-list tables are views of the frame's buffers, read
in place (int16 or int32). The libraries are built and loaded by
``ops/cuda_build.py``; the warp filter table sits in the warp library's
device memory (int8, uploaded once per device), and the OBMC
kernel reads the one table the plain version slices
(``mc.obmc_mask_table``). ``WARP_LAUNCHES``, ``COMP_LAUNCHES`` and
``OBMC_LAUNCHES`` count the launches. No wrapper reads a device tensor
back to the host.
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
# the warp filter table as the kernel keeps it (csrc/warp.cu g_warp)
WARP_TABLE = np.ascontiguousarray(mc.WARP_FILTER, np.int8)
assert (WARP_TABLE == mc.WARP_FILTER).all()

_P, _I, _L = ct.c_void_p, ct.c_int, ct.c_longlong


# the planes and reference stacks a warp, comp or OBMC run can name
# (csrc/warp.cu WP_PLANES, csrc/comp.cu CP_PLANES, csrc/obmc.cu OB_PLANES)
MAX_PLANES = 3


class WarpArgs(ct.Structure):
    """csrc/warp.cu WarpRunArgs."""
    _fields_ = [(n, _P) for n in ("tab", "desc", "desc16")] + \
        [("ref", _P * MAX_PLANES), ("plane", _P * MAX_PLANES),
         ("arena", _P), ("ref_pstride", _L * MAX_PLANES), ("arena_n", _L)] + \
        [(n, _I * MAX_PLANES) for n in ("ref_rstride", "ref_n", "ref_h",
                                        "ref_w", "plane_h", "plane_w",
                                        "plane_rstride")] + \
        [(n, _I) for n in ("n_entries", "n_units", "ib", "bias", "bd_max")]


class CompArgs(ct.Structure):
    """csrc/comp.cu CompRunArgs."""
    _fields_ = [(n, _P) for n in ("tab", "desc", "arena")] + \
        [("plane", _P * MAX_PLANES), ("arena_n", _L), ("desc_n", _L)] + \
        [(n, _I * MAX_PLANES) for n in ("plane_h", "plane_w",
                                        "plane_rstride")] + \
        [(n, _I) for n in ("n_entries", "n_rows", "n_items", "bd", "ib",
                           "bias", "bd_max")]


class ObmcArgs(ct.Structure):
    """csrc/obmc.cu ObmcRunArgs."""
    _fields_ = [(n, _P) for n in ("tab", "desc", "arena", "masks")] + \
        [("plane", _P * MAX_PLANES), ("arena_n", _L)] + \
        [(n, _I * MAX_PLANES) for n in ("plane_h", "plane_w",
                                        "plane_rstride")] + \
        [(n, _I) for n in ("n_entries", "n_pixels")]


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


def _planes(a, planes, dev):
    """The destination planes, (H, W) int32 at their row strides."""
    if len(planes) > MAX_PLANES:
        raise ValueError(f"{len(planes)} planes, at most {MAX_PLANES}")
    for i, p in enumerate(planes):
        check(p, f"planes[{i}]", torch.int32, 2, dev, contiguous=False)
        if p.stride(1) != 1:
            raise ValueError(f"planes[{i}]: columns not contiguous")
        a.plane[i] = p.data_ptr()
        a.plane_h[i], a.plane_w[i] = p.shape
        a.plane_rstride[i] = p.stride(0)


def _bd(a, bitdepth):
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    a.ib = mc.ibits(bitdepth)
    a.bias = 0 if bitdepth == 8 else 8192
    a.bd_max = (1 << bitdepth) - 1


def _table(a, tab, work, width, dev):
    """The run's table: `width` ints an entry; its counts."""
    check(tab, "tab", torch.int32, 1, dev)
    n_entries, n_work = work
    if tab.shape[0] != n_entries * width:
        raise ValueError(f"tab: {tab.shape[0]} ints for work {work}")
    a.tab, a.n_entries = tab.data_ptr(), n_entries
    return n_work


def _arena(a, arena, dev):
    if arena is not None:
        check(arena, "arena", torch.int32, 1, dev)
        a.arena, a.arena_n = arena.data_ptr(), arena.numel()


def warp_run(tab, work, desc, desc16, planes, refs, arena, bitdepth: int):
    """A frame's warp work list; see ``ops/mc.warp_run`` for the
    arguments (arena may be None when no entry writes slots). planes and
    refs: at most MAX_PLANES each, refs[i] the (R, H, W) int32 stack of
    planes[i] (unit column stride). Updates planes and arena in place;
    one launch (none for a list without units)."""
    if tab.device.type == "cpu":
        return mc.warp_run(tab, work, desc, desc16, planes, refs, arena,
                           bitdepth)
    a = warp_args(tab, work, desc, desc16, planes, refs, arena, bitdepth)
    if a.n_units:
        _launch("warp", a, tab.device)


def warp_args(tab, work, desc, desc16, planes, refs, arena, bitdepth: int):
    """The checked WarpArgs struct of a warp_run call on CUDA tensors."""
    dev = cuda_device(tab, "warp_run")
    a = WarpArgs()
    a.n_units = _table(a, tab, work, mc.WENTRY, dev)
    check(desc, "desc", torch.int32, 1, dev)
    check(desc16, "desc16", torch.int16, 1, dev)
    a.desc, a.desc16 = desc.data_ptr(), desc16.data_ptr()
    if len(refs) > MAX_PLANES:
        raise ValueError(f"{len(refs)} reference stacks, at most "
                         f"{MAX_PLANES}")
    for i, r in enumerate(refs):
        check(r, f"refs[{i}]", torch.int32, 3, dev, contiguous=False)
        if r.stride(2) != 1:
            raise ValueError(f"refs[{i}]: columns not contiguous")
        a.ref[i] = r.data_ptr()
        a.ref_pstride[i], a.ref_rstride[i] = r.stride(0), r.stride(1)
        a.ref_n[i], a.ref_h[i], a.ref_w[i] = r.shape
    _planes(a, planes, dev)
    _arena(a, arena, dev)
    _bd(a, bitdepth)
    return a


def comp_run(tab, work, desc, planes, arena, bitdepth: int):
    """A frame's compound joins; see ``ops/mc.comp_run`` for the
    arguments. planes: at most MAX_PLANES (H, W) int32 planes (unit
    column stride). Updates the planes in place; one launch (none for a
    list without work items). A slot whose mask or sides lie outside
    their buffer is dropped."""
    if tab.device.type == "cpu":
        return mc.comp_run(tab, work, desc, planes, arena, bitdepth)
    a = comp_args(tab, work, desc, planes, arena, bitdepth)
    if a.n_items:
        _launch("comp", a, tab.device)


def comp_args(tab, work, desc, planes, arena, bitdepth: int):
    """The checked CompArgs struct of a comp_run call on CUDA tensors."""
    dev = cuda_device(tab, "comp_run")
    a = CompArgs()
    check(tab, "tab", torch.int32, 1, dev)
    a.n_entries, a.n_rows, a.n_items = work
    if tab.shape[0] != a.n_entries * mc.CENTRY + a.n_rows * mc.CROW:
        raise ValueError(f"tab: {tab.shape[0]} ints for work {work}")
    a.tab = tab.data_ptr()
    check(desc, "desc", torch.int32, 1, dev)
    a.desc, a.desc_n = desc.data_ptr(), desc.numel()
    _planes(a, planes, dev)
    if arena is None:
        raise ValueError("comp_run: no arena")
    _arena(a, arena, dev)
    _bd(a, bitdepth)
    a.bd = bitdepth
    return a


def obmc_run(tab, work, desc, planes, arena):
    """One phase's OBMC work list; see ``ops/mc.obmc_run`` for the
    arguments. planes: at most MAX_PLANES (H, W) int32 planes (unit
    column stride). Updates the planes in place; one launch (none for a
    list without pixels)."""
    if tab.device.type == "cpu":
        return mc.obmc_run(tab, work, desc, planes, arena)
    dev = cuda_device(tab, "obmc_run")
    a = ObmcArgs()
    a.n_pixels = _table(a, tab, work, mc.OENTRY, dev)
    check(desc, "desc", torch.int32, 1, dev)
    a.desc, a.masks = desc.data_ptr(), mc.obmc_mask_table(dev).data_ptr()
    _planes(a, planes, dev)
    _arena(a, arena, dev)
    if a.n_pixels:
        _launch("obmc", a, dev)
