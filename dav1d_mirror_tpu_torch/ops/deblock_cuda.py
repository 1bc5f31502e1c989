"""Wrapper of the hand-written CUDA deblock kernels (``csrc/deblock.cu``).

``deblock_frame`` (the decode: the executor's dbkrun record) deblocks a
frame's planes, luma or luma and both chroma planes, in one launch of the
frame kernel: both passes of every plane in shared memory, each edge's
fallback level its neighbour's entry of the same level map (no shifted
maps are built). ``apply_pass`` and ``deblock_plane`` run the pass kernel,
one launch a pass over one plane (the horizontal pass on the plane's and
the maps' transposes, as views): the tile-sharded decode's row bands call
``apply_pass`` (``parallel/filter_shard.band_deblock_plane``), and
``deblock_plane`` takes any fallback level maps. All take the arguments
of their plain versions in ``ops/loopfilter.py``. A tensor on the CPU
goes to the plain version; a CUDA tensor goes to a kernel, or the call
raises. The kernels read the planes and maps through their strides and
element widths (int8, int16 or int32 maps and LUTs) and write new
tensors: ``deblock_frame`` and ``deblock_plane`` copy nothing,
``apply_pass`` (which updates its rows in place, as the plain version
does) copies its output back. The library is built and loaded by
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
# output rows x columns of a CTA of the frame kernel (csrc/deblock.cu
# DBF_TH, DBF_TW; tools/deblock_model.FRAME_TILE)
FRAME_TILE = (64, 64)
MAX_PLANES = 3


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


class DbkPlane(ct.Structure):
    """csrc/deblock.cu DbkPlane."""
    _fields_ = [(n, ct.c_void_p) for n in ("inp", "out", "ev", "eh", "lv",
                                           "lh")] + \
        [(n, ct.c_longlong) for n in ("in_sr", "out_sr", "ev_s0", "ev_s1",
                                      "eh_s0", "eh_s1", "lv_s0", "lv_s1",
                                      "lh_s0", "lh_s1")] + \
        [(n, ct.c_int) for n in ("ev_es", "eh_es", "lv_es", "lh_es", "Hp",
                                 "Wp", "h4", "w4", "luma", "vec", "tiles_x",
                                 "tile0")]


class DbkFrameArgs(ct.Structure):
    """csrc/deblock.cu DbkFrameArgs."""
    _fields_ = [("pl", DbkPlane * MAX_PLANES), ("elut", ct.c_void_p),
                ("ilut", ct.c_void_p)] + \
        [(n, ct.c_int) for n in ("elut_es", "ilut_es", "n_planes",
                                 "n_tiles", "bd")]


def _bind(lib):
    for fn, mirror in (("deblock_pass_launch", DbkArgs),
                       ("deblock_frame_launch", DbkFrameArgs)):
        getattr(lib, fn).restype = ct.c_int
        getattr(lib, fn).argtypes = [ct.POINTER(mirror), ct.c_void_p]
    for fn, mirror in (("deblock_args_size", DbkArgs),
                       ("deblock_frame_args_size", DbkFrameArgs)):
        size = getattr(lib, fn)
        size.restype = ct.c_int
        size.argtypes = []
        if size() != ct.sizeof(mirror):
            raise RuntimeError(f"deblock: {mirror.__name__} is {size()} "
                               f"bytes, its ctypes mirror "
                               f"{ct.sizeof(mirror)}")


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


def _launch(dev, a, entry="deblock_pass_launch"):
    global DEBLOCK_LAUNCHES
    lib = load("deblock", _bind)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
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


def frame_args(planes, outs, edge_v, edge_h, lvl_v, lvl_h, e_lut, i_lut,
               bitdepth):
    """The frame kernel's arguments: plane i of `outs` from plane i of
    `planes` with its maps (tensors on any device; the CPU tests pack
    them). CTAs go to the planes' tiles in plane order."""
    a = DbkFrameArgs()
    tile0 = 0
    th, tw = FRAME_TILE
    for i, (p, o) in enumerate(zip(planes, outs)):
        d = a.pl[i]
        d.inp, d.out = p.data_ptr(), o.data_ptr()
        d.in_sr, d.out_sr = p.stride(0), o.stride(0)
        for nm, t in (("ev", edge_v[i]), ("eh", edge_h[i]), ("lv", lvl_v[i]),
                      ("lh", lvl_h[i])):
            setattr(d, nm, t.data_ptr())
            s0, s1 = t.stride()
            setattr(d, f"{nm}_s0", s0)
            setattr(d, f"{nm}_s1", s1)
            setattr(d, f"{nm}_es", t.element_size())
        d.Hp, d.Wp = p.shape
        d.h4, d.w4 = edge_v[i].shape
        d.luma = int(i == 0)
        d.vec = int(p.data_ptr() % 16 == 0 and p.stride(0) % 4 == 0)
        d.tiles_x = -(-d.Wp // tw)
        d.tile0 = tile0
        tile0 += d.tiles_x * -(-d.Hp // th)
    a.elut, a.elut_es = e_lut.data_ptr(), e_lut.element_size()
    a.ilut, a.ilut_es = i_lut.data_ptr(), i_lut.element_size()
    a.n_planes, a.n_tiles, a.bd = len(planes), tile0, bitdepth
    return a


def deblock_frame(planes, edge_v, edge_h, lvl_v, lvl_h, e_lut, i_lut,
                  bitdepth):
    """Deblock a frame's planes (luma, or luma and both chroma planes)
    in one launch; see ``ops/loopfilter.deblock_frame``. edge_v, edge_h,
    lvl_v and lvl_h hold a map per plane. Returns new int32 planes; the
    inputs are not modified."""
    p0 = planes[0]
    if p0.device.type == "cpu":
        return loopfilter.deblock_frame(planes, edge_v, edge_h, lvl_v,
                                        lvl_h, e_lut, i_lut, bitdepth)
    dev = cuda_device(p0, "deblock_frame")
    n = len(planes)
    if n not in (1, 3) or not all(len(m) == n for m in (edge_v, edge_h,
                                                         lvl_v, lvl_h)):
        raise ValueError(f"deblock_frame: {n} planes, expected 1 or 3 with "
                         "a map of each kind a plane")
    planes = [p if p.dtype == torch.int32 or p.dim() != 2 else
              p.to(torch.int32) for p in planes]
    planes = [p if p.dim() != 2 or p.stride(1) == 1 else p.contiguous()
              for p in planes]
    for i, p in enumerate(planes):
        _check(p, edge_v[i], lvl_v[i], lvl_v[i], e_lut, i_lut, bitdepth, 0,
               dev)
        _check(p.T, edge_h[i].T, lvl_h[i].T, lvl_h[i].T, e_lut, i_lut,
               bitdepth, 0, dev)
        if edge_h[i].shape != edge_v[i].shape:
            raise ValueError(f"deblock_frame: plane {i}'s maps differ in "
                             "shape")
    outs = [torch.empty(p.shape, dtype=torch.int32, device=dev)
            for p in planes]
    a = frame_args(planes, outs, edge_v, edge_h, lvl_v, lvl_h, e_lut, i_lut,
                   bitdepth)
    if a.n_tiles:
        _launch(dev, a, "deblock_frame_launch")
    return tuple(outs)
