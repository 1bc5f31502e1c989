"""Wrapper of the hand-written CUDA CDEF kernels (``csrc/cdef.cu``): the
luma direction search and the primary/secondary filter.

``cdef_dir``, ``cdef_filter_plane`` and ``cdef_frame`` take the arguments
of their plain versions in ``ops/cdef.py``. A tensor on the CPU goes to
the plain version; a CUDA tensor goes to the kernels, or the call raises.
``cdef_frame`` (the decode: the executor's cdef record) is one launch of
the frame kernel: the direction search of each CTA's blocks and the
filter of all the frame's planes, each block's direction and strengths
derived inside the kernel from the frame's inputs (no per-block maps, no
stack of shifted planes). ``cdef_dir`` and ``cdef_filter_plane`` (the
band functions of ``parallel/filter_shard`` call them) are one launch
each. Maps and strength tables are read at their strides and element
widths (int8, int16, int32 or bool). The library is built and loaded by
``ops/cuda_build.py``; its direction table lives in ``__constant__``
memory, uploaded once per device from ``spec_consts.CDEF_DIRECTIONS``
and ``cdef.UV_DIRS_TBL``. ``CDEF_LAUNCHES`` counts the launches. The
wrapper reads no device tensor back to the host.
"""
from __future__ import annotations

import ctypes as ct
import threading

import numpy as np
import torch

from . import cdef
from .cuda_build import check, cuda_device, load_on, raise_on
from .spec_consts import CDEF_DIRECTIONS

CDEF_LAUNCHES = 0

_count_lock = threading.Lock()
MAX_PLANES = 3
_MAP_DTYPES = (torch.int8, torch.int16, torch.int32, torch.bool)
# the __constant__ tables of csrc/cdef.cu (cdef_init): c_dirs[12][2][2],
# then c_uv_dirs[2][8]
TABLE = np.ascontiguousarray(np.concatenate([
    np.asarray(CDEF_DIRECTIONS, np.int32).reshape(-1),
    np.asarray(cdef.UV_DIRS_TBL, np.int32).reshape(-1)]))

_VP, _LL, _INT = ct.c_void_p, ct.c_longlong, ct.c_int


class DirArgs(ct.Structure):
    """csrc/cdef.cu DirArgs."""
    _fields_ = [("src", _VP), ("dir", _VP), ("var", _VP), ("sr", _LL),
                ("sc", _LL), ("h8", _INT), ("w8", _INT), ("bd", _INT)]


class PlaneArgs(ct.Structure):
    """csrc/cdef.cu PlaneArgs."""
    _fields_ = [(n, _VP) for n in ("src", "plane", "out", "top", "bot")] + \
        [(n, _LL) for n in ("src_sr", "src_sc", "pl_sr", "pl_sc", "out_sr",
                            "out_sc", "top_sr", "top_sc", "bot_sr",
                            "bot_sc")] + \
        [(n, _INT) for n in ("Hp", "Wp", "bw", "bh", "damping", "vec")]


class FilterArgs(ct.Structure):
    """csrc/cdef.cu FilterArgs."""
    _fields_ = [("pl", PlaneArgs * MAX_PLANES)] + \
        [(n, _VP) for n in ("m_dir", "m_pri", "m_sec", "m_act", "idx", "ns",
                            "ystr", "uvstr")] + \
        [(n, _LL) for n in ("dir_s0", "dir_s1", "pri_s0", "pri_s1",
                            "sec_s0", "sec_s1", "act_s0", "act_s1",
                            "idx_s0", "idx_s1", "ns_s0", "ns_s1",
                            "ystr_s0", "uvstr_s0")] + \
        [(n, _INT) for n in ("dir_es", "pri_es", "sec_es", "act_es",
                             "idx_es", "ns_es", "ystr_es", "uvstr_es",
                             "hb", "wb", "bh4", "bw4", "uv_row", "bd")]


def _bind(lib):
    for fn, args in (("cdef_dir_launch", [ct.POINTER(DirArgs), _VP]),
                     ("cdef_filter_launch", [ct.POINTER(FilterArgs), _INT,
                                             _VP]),
                     ("cdef_frame_launch", [ct.POINTER(FilterArgs), _INT,
                                            _VP])):
        getattr(lib, fn).restype = ct.c_int
        getattr(lib, fn).argtypes = args
    for fn, mirror in (("cdef_dir_args_size", DirArgs),
                       ("cdef_filter_args_size", FilterArgs)):
        size = getattr(lib, fn)
        size.restype = ct.c_int
        size.argtypes = []
        if size() != ct.sizeof(mirror):
            raise RuntimeError(f"cdef: {mirror.__name__} is {size()} bytes, "
                               f"its ctypes mirror {ct.sizeof(mirror)}")


def _lib_on(dev):
    """The library, its direction table set on `dev`."""
    with torch.cuda.device(dev):
        return load_on("cdef", _bind, dev, TABLE)


def _bump():
    global CDEF_LAUNCHES
    with _count_lock:
        CDEF_LAUNCHES += 1


def _i32(t):
    return t if t.dtype == torch.int32 else t.to(torch.int32)


def _map(a, name, t, dim_names=("s0", "s1")):
    """Set a map's pointer, strides and element width in FilterArgs."""
    setattr(a, name, t.data_ptr())
    for d, s in zip(dim_names, t.stride()):
        setattr(a, f"{name.removeprefix('m_')}_{d}", s)
    setattr(a, f"{name.removeprefix('m_')}_es", t.element_size())


def dir_args(src, dirm, var, h8, w8, bitdepth):
    """The direction search's arguments (tensors on any device)."""
    a = DirArgs()
    a.src, a.dir, a.var = src.data_ptr(), dirm.data_ptr(), var.data_ptr()
    a.sr, a.sc = src.stride()
    a.h8, a.w8, a.bd = h8, w8, bitdepth
    return a


def plane_args(src, plane, out, bw, bh, damping, halo=None):
    """One plane's filter arguments: read `src`, copy `plane`, write
    `out` (all at their strides); `halo` = (top2, bot2) rows or None.
    `vec`: src's rows can be read as 16-byte loads (the frame kernel)."""
    p = PlaneArgs()
    p.src, p.plane, p.out = src.data_ptr(), plane.data_ptr(), out.data_ptr()
    p.src_sr, p.src_sc = src.stride()
    p.pl_sr, p.pl_sc = plane.stride()
    p.out_sr, p.out_sc = out.stride()
    if halo is not None:
        top, bot = halo
        p.top, p.bot = top.data_ptr(), bot.data_ptr()
        p.top_sr, p.top_sc = top.stride()
        p.bot_sr, p.bot_sc = bot.stride()
    p.Hp, p.Wp = out.shape
    p.bw, p.bh, p.damping = bw, bh, damping
    p.vec = int(src.stride(1) == 1 and src.stride(0) % 4 == 0 and
                src.data_ptr() % 16 == 0)
    return p


def _check_bd(bitdepth):
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")


def _launch_dir(dev, lib, src, h8, w8, bitdepth):
    dirm = torch.empty((h8, w8), dtype=torch.int32, device=dev)
    var = torch.empty((h8, w8), dtype=torch.int32, device=dev)
    if h8 * w8:
        rc = lib.cdef_dir_launch(ct.byref(dir_args(src, dirm, var, h8, w8,
                                                   bitdepth)),
                                 torch.cuda.current_stream(dev).cuda_stream)
        raise_on(lib, "cdef", rc)
        _bump()
    return dirm, var


def _launch_filter(dev, lib, a, n_planes, entry="cdef_filter_launch"):
    rc = getattr(lib, entry)(ct.byref(a), n_planes,
                             torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "cdef", rc)
    _bump()


def cdef_dir(plane, h8, w8, bitdepth):
    """Direction and variance of every 8x8 block; see
    ``ops/cdef.cdef_dir``. Returns two new (h8, w8) int32 maps."""
    if plane.device.type == "cpu":
        return cdef.cdef_dir(plane, h8, w8, bitdepth)
    dev = cuda_device(plane, "cdef_dir")
    _check_bd(bitdepth)
    check(plane, "plane", (torch.int32, torch.int16, torch.uint8), 2, dev,
          contiguous=False)
    src = _i32(plane)
    if src.shape[0] < 8 * h8 or src.shape[1] < 8 * w8:
        raise ValueError(f"cdef_dir: a {tuple(src.shape)} plane for "
                         f"{h8}x{w8} blocks")
    lib = _lib_on(dev)
    with torch.cuda.device(dev):
        return _launch_dir(dev, lib, src, h8, w8, bitdepth)


def cdef_filter_plane(plane, src, dir_map, pri_map, sec_map, damping,
                      active, bitdepth, bw, bh, halo=None):
    """The filter over one plane from per-block maps; see
    ``ops/cdef.cdef_filter_plane``. Returns a new int32 plane."""
    if plane.device.type == "cpu":
        return cdef.cdef_filter_plane(plane, src, dir_map, pri_map, sec_map,
                                      damping, active, bitdepth, bw, bh,
                                      halo)
    dev = cuda_device(plane, "cdef_filter_plane")
    _check_bd(bitdepth)
    for nm, t in (("plane", plane), ("src", src)):
        check(t, nm, (torch.int32, torch.int16, torch.uint8), 2, dev,
              contiguous=False)
    plane, src = _i32(plane), _i32(src)
    if bw not in (4, 8) or bh not in (4, 8):
        raise ValueError(f"cdef_filter_plane: {bw}x{bh} blocks (the kernel "
                         "takes 4 or 8 a side)")
    hb, wb = dir_map.shape
    for nm, t in (("dir_map", dir_map), ("pri_map", pri_map),
                  ("sec_map", sec_map), ("active", active)):
        check(t, nm, _MAP_DTYPES, 2, dev, contiguous=False)
        if tuple(t.shape) != (hb, wb):
            raise ValueError(f"{nm}: shape {tuple(t.shape)}, expected "
                             f"{(hb, wb)}")
    H, W = hb * bh, wb * bw
    if min(plane.shape[0], src.shape[0]) < H or \
            min(plane.shape[1], src.shape[1]) < W:
        raise ValueError(f"cdef_filter_plane: {hb}x{wb} blocks of {bw}x{bh} "
                         f"in planes {tuple(plane.shape)}, "
                         f"{tuple(src.shape)}")
    if halo is not None:
        halo = tuple(_i32(h) for h in halo)
        for nm, h in zip(("halo top", "halo bottom"), halo):
            check(h, nm, torch.int32, 2, dev, contiguous=False)
            if h.shape[0] != 2 or h.shape[1] < W:
                raise ValueError(f"{nm}: shape {tuple(h.shape)}, expected "
                                 f"(2, >= {W})")
    out = torch.empty(plane.shape, dtype=torch.int32, device=dev)
    a = FilterArgs()
    a.pl[0] = plane_args(src, plane, out, bw, bh, damping, halo=halo)
    for nm, t in (("m_dir", dir_map), ("m_pri", pri_map), ("m_sec", sec_map),
                  ("m_act", active)):
        _map(a, nm, t)
    a.hb, a.wb, a.bd = hb, wb, bitdepth
    if out.numel():
        lib = _lib_on(dev)
        with torch.cuda.device(dev):
            _launch_filter(dev, lib, a, 1)
    return out


def frame_args(planes, outs, cdef_idx_map, noskip4, y_strengths,
               uv_strengths, damping, bitdepth, ss_hor, ss_ver):
    """The frame kernel's arguments: every plane of `outs` from its plane
    of `planes`, block parameters from the frame's inputs (tensors on any
    device)."""
    bh4, bw4 = noskip4.shape
    a = FilterArgs()
    for i, (p, o) in enumerate(zip(planes, outs)):
        a.pl[i] = plane_args(p, p, o, 8 >> (ss_hor if i else 0),
                             8 >> (ss_ver if i else 0),
                             damping - (1 if i else 0))
    _map(a, "idx", cdef_idx_map)
    _map(a, "ns", noskip4)
    _map(a, "ystr", y_strengths, ("s0",))
    _map(a, "uvstr", uv_strengths, ("s0",))
    a.hb, a.wb = (bh4 + 1) // 2, (bw4 + 1) // 2
    a.bh4, a.bw4 = bh4, bw4
    a.uv_row = 1 if (ss_hor and not ss_ver) else 0
    a.bd = bitdepth
    return a


def cdef_frame(planes, cdef_idx_map, noskip4, y_strengths, uv_strengths,
               damping, bitdepth, ss_hor, ss_ver, monochrome):
    """CDEF over a frame's planes; see ``ops/cdef.cdef_frame``. Returns
    new int32 planes (the luma plane alone when monochrome)."""
    p0 = planes[0]
    if p0.device.type == "cpu":
        return cdef.cdef_frame(planes, cdef_idx_map, noskip4, y_strengths,
                               uv_strengths, damping, bitdepth, ss_hor,
                               ss_ver, monochrome)
    dev = cuda_device(p0, "cdef_frame")
    _check_bd(bitdepth)
    n = 1 if monochrome else 3
    if len(planes) < n:
        raise ValueError(f"cdef_frame: {len(planes)} planes, expected {n}")
    for i, p in enumerate(planes[:n]):
        check(p, f"planes[{i}]", (torch.int32, torch.int16, torch.uint8), 2,
              dev, contiguous=False)
    planes = [_i32(p) for p in planes[:n]]
    check(cdef_idx_map, "cdef_idx_map", _MAP_DTYPES, 2, dev,
          contiguous=False)
    check(noskip4, "noskip4", _MAP_DTYPES, 2, dev, contiguous=False)
    for nm, t in (("y_strengths", y_strengths),
                  ("uv_strengths", uv_strengths)):
        check(t, nm, _MAP_DTYPES, 1, dev, contiguous=False)
        if t.shape[0] < 8:
            raise ValueError(f"{nm}: {t.shape[0]} entries, expected 8")
    bh4, bw4 = noskip4.shape
    h8, w8 = (bh4 + 1) // 2, (bw4 + 1) // 2
    if cdef_idx_map.shape[0] * 8 < h8 or cdef_idx_map.shape[1] * 8 < w8:
        raise ValueError(f"cdef_idx_map: shape {tuple(cdef_idx_map.shape)} "
                         f"for {h8}x{w8} blocks")
    for i, p in enumerate(planes):
        sh, sw = (ss_ver, ss_hor) if i else (0, 0)
        if p.shape[0] < h8 * (8 >> sh) or p.shape[1] < w8 * (8 >> sw):
            raise ValueError(f"planes[{i}]: shape {tuple(p.shape)} for "
                             f"{h8}x{w8} blocks")
    outs = [torch.empty(p.shape, dtype=torch.int32, device=dev)
            for p in planes]
    a = frame_args(planes, outs, cdef_idx_map, noskip4, y_strengths,
                   uv_strengths, damping, bitdepth, ss_hor, ss_ver)
    if any(o.numel() for o in outs):
        lib = _lib_on(dev)
        with torch.cuda.device(dev):
            _launch_filter(dev, lib, a, n, "cdef_frame_launch")
    return tuple(outs)
