"""Wrappers of the two hand-written CUDA kernels of the MC path.

- ``mc_hplanes``: ``csrc/mc_hplanes.cu``, the H-plane 8-tap pass;
- ``mc_unit_batch_hv``: ``csrc/mc_vpass.cu``, the per-unit V-pass.

Each takes the same arguments as its plain version in ``ops/mc.py``. A
tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises. The kernels are built and loaded by
``ops/cuda_build.py`` (``nvcc`` for ``sm_90a`` at first use, bound
through ctypes). Each library keeps the subpel table in
``__constant__`` memory, uploaded once per device from ``mc.SUBPEL``.
``HPLANES_LAUNCHES`` and ``VPASS_LAUNCHES`` count the launches. Neither
wrapper reads a device tensor back to the host.
"""
from __future__ import annotations

import ctypes as ct
import threading

import torch

from . import mc
from .cuda_build import check, cuda_device, load, load_on, raise_on

HPLANES_LAUNCHES = 0
VPASS_LAUNCHES = 0

# the launch counts are bumped from whichever thread launches (the
# pipelined decoder's pixel worker, a caller's own thread)
_count_lock = threading.Lock()


def _bind(lib, name):
    vp = ct.c_void_p
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ct.c_int
    if name == "mc_hplanes":
        fn.argtypes = [vp, vp, vp] + [ct.c_int] * 4 + [vp]
    else:
        fn.argtypes = [vp] * 7 + [ct.c_int] * 9 + [vp]
        lib.mc_empty_launch.restype = ct.c_int
        lib.mc_empty_launch.argtypes = [vp]


def _lib(name):
    return load(name, lambda lib: _bind(lib, name))


def _lib_on(name, dev):
    """The kernel library, with its __constant__ subpel table set on
    `dev` (the caller has made `dev` current)."""
    return load_on(name, lambda lib: _bind(lib, name), dev, mc.SUBPEL)


def mc_hplanes(ref_stack, combos, bitdepth):
    """ref_stack (R, H, W) int32; combos (C, 3) int32 (ref, filter_row,
    mx), ref < R, filter_row < 6, mx in 1..15. Returns (C, H, W+22)
    int16. See ``ops/mc.mc_hplanes``."""
    global HPLANES_LAUNCHES
    if ref_stack.device.type == "cpu":
        return mc.mc_hplanes(ref_stack, combos, bitdepth)
    dev = cuda_device(ref_stack, "mc_hplanes")
    check(ref_stack, "ref_stack", torch.int32, 3, dev)
    check(combos, "combos", torch.int32, 2, dev)
    if combos.shape[1] != 3:
        raise ValueError(f"combos: shape {tuple(combos.shape)}, "
                         "expected (C, 3)")
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    _, H, W = ref_stack.shape
    C = combos.shape[0]
    out = torch.empty((C, H, W + 22), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        lib = _lib_on("mc_hplanes", dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mc_hplanes_launch(
            ref_stack.data_ptr(), combos.data_ptr(), out.data_ptr(), H, W,
            C, mc.ibits(bitdepth), stream)
    raise_on(lib, "mc_hplanes", rc)
    with _count_lock:
        HPLANES_LAUNCHES += 1
    return out


def mc_unit_batch_hv(args, uw: int, uh: int, bitdepth: int, prep: bool):
    """args = (hstack (C, H, W+22) int16, slot, oy, ox, my, tv), each
    (B,) int32; slot < C, ox in [-15, W-1], my in 1..15, tv in 0..2.
    Returns (B, uh, uw) int32. See ``ops/mc.mc_unit_batch_hv``."""
    global VPASS_LAUNCHES
    hstack = args[0]
    if hstack.device.type == "cpu":
        return mc.mc_unit_batch_hv(args, uw, uh, bitdepth, prep)
    dev = cuda_device(hstack, "mc_unit_batch_hv")
    check(hstack, "hstack", torch.int16, 3, dev)
    cols = args[1:]
    for nm, t in zip(("slot", "oy", "ox", "my", "tv"), cols):
        check(t, nm, torch.int32, 1, dev)
    B = cols[0].shape[0]
    if any(t.shape[0] != B for t in cols):
        raise ValueError("descriptor columns differ in length")
    if uw not in (2, 4, 8) or uh not in (2, 4, 8):
        raise ValueError(f"unit {uw}x{uh}")
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    _, H, w_mid = hstack.shape
    out = torch.empty((B, uh, uw), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        lib = _lib_on("mc_vpass", dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mc_vpass_launch(
            hstack.data_ptr(), *(t.data_ptr() for t in cols),
            out.data_ptr(), B, H, w_mid,
            uw, uh, mc.ibits(bitdepth), 0 if bitdepth == 8 else 8192,
            (1 << bitdepth) - 1, int(bool(prep)), stream)
    raise_on(lib, "mc_vpass", rc)
    with _count_lock:
        VPASS_LAUNCHES += 1
    return out


def empty_launch():
    """Launch an empty kernel on the current CUDA stream: the launch
    floor that a V-pass time is set beside. Not counted."""
    lib = _lib("mc_vpass")
    raise_on(lib, "mc_vpass", lib.mc_empty_launch(
        torch.cuda.current_stream().cuda_stream))
