"""Wrapper of the hand-written CUDA deblock kernel (``csrc/deblock.cu``):
one launch a pass (vertical or horizontal edges) over one plane.

``deblock_plane`` and ``apply_pass`` take the arguments of their plain
versions in ``ops/loopfilter.py``. A tensor on the CPU goes to the plain
version; a CUDA tensor goes to the kernel, or the call raises. The
kernel reads the plane and the maps through their strides and element
widths (int8, int16 or int32 maps and LUTs; the horizontal pass reads
the plane's transpose and the maps' transposes as views) and writes a
new tensor, so ``deblock_plane`` is two launches and no copy, and
``apply_pass`` (which updates its rows in place, as the plain version
does) one launch and a copy back. The library is built and loaded by
``ops/cuda_build.py``. ``DEBLOCK_LAUNCHES`` counts the launches. The
wrapper reads no device tensor back to the host.
"""
from __future__ import annotations

import ctypes as ct
import threading

import torch

from . import loopfilter
from .cuda_build import check, cuda_device, load, raise_on

DEBLOCK_LAUNCHES = 0

_count_lock = threading.Lock()
_MAP_DTYPES = (torch.int8, torch.int16, torch.int32)
# view rows x view columns of a CTA's tile (csrc/deblock.cu TR, TC): the
# vertical pass (view columns unit-stride) and the horizontal one (view
# rows unit-stride, ROWS_FAST)
TILE = {False: (4, 244), True: (32, 64)}


class DbkArgs(ct.Structure):
    """csrc/deblock.cu DbkArgs."""
    _fields_ = [(n, ct.c_void_p) for n in ("inp", "out", "edge", "lvl",
                                           "lvlp", "elut", "ilut")] + \
        [(n, ct.c_longlong) for n in ("in_sr", "in_sc", "out_sr", "out_sc",
                                      "edge_s0", "edge_s1", "lvl_s0",
                                      "lvl_s1", "lvlp_s0", "lvlp_s1")] + \
        [(n, ct.c_int) for n in ("edge_es", "lvl_es", "lvlp_es", "elut_es",
                                 "ilut_es", "rows", "W", "n_er", "n_e",
                                 "base", "first_edge", "luma", "bd")]


def _bind(lib):
    lib.deblock_pass_launch.restype = ct.c_int
    lib.deblock_pass_launch.argtypes = [ct.POINTER(DbkArgs), ct.c_void_p]
    lib.deblock_args_size.restype = ct.c_int
    lib.deblock_args_size.argtypes = []
    if lib.deblock_args_size() != ct.sizeof(DbkArgs):
        raise RuntimeError(f"deblock: DbkArgs is {lib.deblock_args_size()} "
                           f"bytes, its ctypes mirror {ct.sizeof(DbkArgs)}")


def pass_args(src, dst, rows, edge_idx, lvl_cur, lvl_prev, e_lut, i_lut,
              luma, bitdepth, base=0, first_edge=0):
    """The kernel's arguments for one pass: read the view `src` (view rows
    x W view columns, at its strides), write the view `dst` (same shape,
    its strides); view rows below 4 * edge_idx.shape[0] up to `rows` are
    copied. Tensors may lie on any device (the CPU tests pack them)."""
    a = DbkArgs()
    a.inp, a.out = src.data_ptr(), dst.data_ptr()
    a.in_sr, a.in_sc = src.stride()
    a.out_sr, a.out_sc = dst.stride()
    for nm, t in (("edge", edge_idx), ("lvl", lvl_cur), ("lvlp", lvl_prev)):
        setattr(a, nm, t.data_ptr())
        s0, s1 = t.stride()
        setattr(a, f"{nm}_s0", s0)
        setattr(a, f"{nm}_s1", s1)
        setattr(a, f"{nm}_es", t.element_size())
    a.elut, a.elut_es = e_lut.data_ptr(), e_lut.element_size()
    a.ilut, a.ilut_es = i_lut.data_ptr(), i_lut.element_size()
    a.rows, a.W = rows, src.shape[1]
    a.n_er, a.n_e = edge_idx.shape
    a.base, a.first_edge = base, first_edge
    a.luma, a.bd = int(bool(luma)), bitdepth
    return a


def _check(src, edge_idx, lvl_cur, lvl_prev, e_lut, i_lut, bitdepth, base,
           dev):
    """Raise unless the pass is one the kernel computes as the plain
    version does: pixel bit depth, map shapes and dtypes, and a view wide
    enough that every edge's taps stay within one wrap of it."""
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    check(src, "plane", torch.int32, 2, dev, contiguous=False)
    for nm, t in (("edge_idx", edge_idx), ("lvl_cur", lvl_cur),
                  ("lvl_prev", lvl_prev)):
        check(t, nm, _MAP_DTYPES, 2, dev, contiguous=False)
        if t.shape != edge_idx.shape:
            raise ValueError(f"{nm}: shape {tuple(t.shape)}, expected "
                             f"{tuple(edge_idx.shape)}")
    for nm, t in (("e_lut", e_lut), ("i_lut", i_lut)):
        check(t, nm, _MAP_DTYPES, 1, dev)
        if t.shape[0] < 64:
            raise ValueError(f"{nm}: {t.shape[0]} entries, expected 64")
    if max(src.numel(), edge_idx.numel()) >= 1 << 31:
        raise ValueError("deblock pass: the kernel's offsets are 32-bit")
    W = src.shape[1]
    if W < 8 or base < 0 or 4 * edge_idx.shape[1] + base > W:
        raise ValueError(f"deblock pass: {edge_idx.shape[1]} edges from "
                         f"column {base} in a view {W} wide")


def _launch(dev, a):
    global DEBLOCK_LAUNCHES
    lib = load("deblock", _bind)
    with torch.cuda.device(dev):
        rc = lib.deblock_pass_launch(
            ct.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "deblock", rc)
    with _count_lock:
        DEBLOCK_LAUNCHES += 1


def apply_pass(rows, edge_idx, lvl_cur, lvl_prev, e_lut, i_lut, luma,
               bitdepth, base=0):
    """One deblock pass over the columns of `rows` (n, W), updated in
    place and returned; see ``ops/loopfilter._apply_pass``."""
    if rows.device.type == "cpu":
        return loopfilter._apply_pass(rows, edge_idx, lvl_cur, lvl_prev,
                                      e_lut, i_lut, luma, bitdepth, base)
    dev = cuda_device(rows, "apply_pass")
    _check(rows, edge_idx, lvl_cur, lvl_prev, e_lut, i_lut, bitdepth, base,
           dev)
    if rows.shape[0] != 4 * edge_idx.shape[0]:
        raise ValueError(f"apply_pass: {rows.shape[0]} rows for "
                         f"{edge_idx.shape[0]} edge rows")
    out = torch.empty(rows.shape, dtype=torch.int32, device=dev)
    if rows.numel():
        _launch(dev, pass_args(rows, out, rows.shape[0], edge_idx, lvl_cur,
                               lvl_prev, e_lut, i_lut, luma, bitdepth,
                               base))
        rows.copy_(out)
    return rows


def deblock_plane(plane, edge_v, edge_h, lvl_v, lvl_v_prev, lvl_h,
                  lvl_h_prev, e_lut, i_lut, luma, bitdepth):
    """The vertical pass, then the horizontal one, over a plane; see
    ``ops/loopfilter.deblock_plane``. Returns a new int32 plane; the
    input is not modified."""
    if plane.device.type == "cpu":
        return loopfilter.deblock_plane(plane, edge_v, edge_h, lvl_v,
                                        lvl_v_prev, lvl_h, lvl_h_prev,
                                        e_lut, i_lut, luma, bitdepth)
    dev = cuda_device(plane, "deblock_plane")
    if plane.dim() == 2 and plane.dtype != torch.int32:
        plane = plane.to(torch.int32)
    h4, w4 = edge_v.shape
    _check(plane, edge_v, lvl_v, lvl_v_prev, e_lut, i_lut, bitdepth, 0, dev)
    _check(plane.T, edge_h.T, lvl_h.T, lvl_h_prev.T, e_lut, i_lut, bitdepth,
           0, dev)
    if edge_h.shape != edge_v.shape:
        raise ValueError("deblock_plane: the maps differ in shape")
    Hp, Wp = plane.shape
    if Hp < 4 * h4 or Wp < 4 * w4:
        raise ValueError(f"deblock_plane: a {Hp}x{Wp} plane for {h4}x{w4} "
                         "edge cells")
    mid = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    out = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    if plane.numel():
        # vertical edges on the plane, then horizontal ones on its
        # transpose; x = 0 and y = 0 have no neighbour (first_edge 1), and
        # the rows (columns) past the edges' are copied
        _launch(dev, pass_args(plane, mid, Hp, edge_v, lvl_v, lvl_v_prev,
                               e_lut, i_lut, luma, bitdepth, first_edge=1))
        _launch(dev, pass_args(mid.T, out.T, Wp, edge_h.T, lvl_h.T,
                               lvl_h_prev.T, e_lut, i_lut, luma, bitdepth,
                               first_edge=1))
    return out
