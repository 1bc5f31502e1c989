"""Build, load and argument checks shared by the wrappers of the
hand-written CUDA kernels (``ops/mc_cuda.py``, ``ops/mcu_cuda.py``,
``ops/itx_cuda.py``, ``ops/deblock_cuda.py``, ``ops/cdef_cuda.py``,
``ops/tools_cuda.py``).

Every source ``csrc/<name>.cu`` of ``SOURCES`` is compiled with ``nvcc``
for ``sm_90a`` at first use, one ``nvcc`` per source, run side by side,
into ``build/kernels/lib<name>.so`` beside this package, and bound through
ctypes (plain C entry points, no PyTorch headers). A library is rebuilt
when its source or any ``csrc/*.cuh`` header is newer than it; the
compiler's output is kept beside it as ``lib<name>.log``. Each
library exports ``<name>_error_string(int)``; its launch functions return
``cudaGetLastError()``. ``build_variants`` compiles one source with
chosen macros into libraries of their own, for a tool's timing builds.
"""
from __future__ import annotations

import ctypes as ct
import fcntl
import glob
import os
import subprocess
import threading

import torch

_PKG = os.path.join(os.path.dirname(__file__), os.pardir)
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build", "kernels")
SOURCES = ("mc_hplanes", "mc_vpass", "mc_units", "mc_scaled", "itx",
           "deblock", "cdef", "warp", "comp", "obmc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs = {}
_lock = threading.Lock()
_table_on = set()    # (library, device index) with its table uploaded


def nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def so_path(name):
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name):
    so = so_path(name)
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + \
        glob.glob(os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def log_path(name):
    return os.path.join(BUILD, f"lib{name}.log")


def _nvcc(name, out, flags):
    """A running nvcc of csrc/<name>.cu into `out`, its output piped."""
    return subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, *flags, "-o", out,
         os.path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_variants(name, variants):
    """Compile csrc/<name>.cu once for each {tag: macros to define} of
    `variants`, side by side, into build/kernels/lib<name>_<tag>.so, for
    a tool that loads them itself (the decoder never does). Returns {tag:
    library path}. Raises if a build fails."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {tag: (so_path(f"{name}_{tag}"),
                   _nvcc(name, so_path(f"{name}_{tag}"),
                         [f"-D{d}" for d in defines]))
             for tag, defines in variants.items()}
    for tag, (_, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu ({tag}):\n{out}")
    return {tag: so for tag, (so, _) in procs.items()}


def build(extra_flags=(), force=()):
    """Compile every stale kernel library and those named in `force`,
    all ``nvcc`` runs side by side. Returns {name: compiler output} for
    the sources it built. Raises if a build fails."""
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for name in SOURCES:
            if not _stale(name) and name not in force:
                continue
            tmp = f"{so_path(name)}.{os.getpid()}.tmp"
            procs[name] = (tmp, _nvcc(name, tmp, extra_flags))
        logs = {}
        for name, (tmp, p) in procs.items():
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, so_path(name))
            with open(log_path(name), "w") as f:
                f.write(out)
            logs[name] = out
        return logs


def load(name, bind):
    """The kernel library `name`, built if stale and loaded once;
    bind(lib) sets the argument types of its entry points."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build()
            lib = ct.CDLL(so_path(name))
            err = getattr(lib, f"{name}_error_string")
            err.restype = ct.c_char_p
            err.argtypes = [ct.c_int]
            bind(lib)
            _libs[name] = lib
    return _libs[name]


def load_on(name, bind, dev, table):
    """load(name, bind), with the library's __constant__ table set on
    `dev` once (``<name>_init(table)``; the caller has made `dev`
    current). `table` is a contiguous numpy array."""
    lib = load(name, bind)
    key = (name, dev.index)
    if key not in _table_on:
        with _lock:
            if key not in _table_on:
                init = getattr(lib, f"{name}_init")
                init.restype = ct.c_int
                init.argtypes = [ct.c_void_p]
                raise_on(lib, name, init(table.ctypes.data))
                _table_on.add(key)
    return lib


def check(t, name, dtype, ndim, device, contiguous=True):
    """Raise unless t is a tensor of `dtype` with `ndim` dims on
    `device` (dtype may be a tuple of allowed dtypes), contiguous unless
    the caller reads it at its strides."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def raise_on(lib, name, rc):
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


def cuda_device(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU (plain "
                         f"version) or on a CUDA device, got {t.device}")
    return t.device
