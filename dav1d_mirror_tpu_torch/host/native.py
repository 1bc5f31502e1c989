# Copied from dav1d_mirror_tpu/host/native.py; the loader builds into
# the package's build directory and raises instead of falling back.
"""ctypes bindings for the native host entropy stage (native/msac.cpp).

Loads ``build/native/libdav1d_host.so`` (building it from ``native/`` on
first use, or when a source is newer than the library) and exposes:

- ``NativeMsac`` — the C range decoder, each symbol decoded natively.
  CDF rows are passed as raw pointers into the numpy-backed
  ``CdfContext`` so adaptation is shared with the Python side.
- ``coef_decode_block(...)`` — one call decodes a whole transform block's
  eob/token/sign/dequant stream (dav1d recon_tmpl.c decode_coefs:321),
  the densest part of the host stage.

The package has no pure-Python host walk: if the library cannot be built
or loaded, importing this module raises.
"""
from __future__ import annotations

import ctypes as ct
import fcntl
import os
import subprocess

import numpy as np

_PKG = os.path.join(os.path.dirname(__file__), os.pardir)
_DIR = os.path.join(_PKG, "native")
_BUILD = os.path.join(_PKG, "build", "native")
_SO = os.path.join(_BUILD, "libdav1d_host.so")
# every input of build.sh: editing ANY of these triggers a rebuild
_SRCS = [os.path.join(_DIR, f) for f in
         ("msac.cpp", "ipred.cpp", "tilecoder.cpp", "recon.cpp",
          "lf.cpp", "ec.h", "build.sh")]


def _stale() -> bool:
    src_mtime = max(os.path.getmtime(f) for f in _SRCS)
    return not os.path.exists(_SO) or os.path.getmtime(_SO) < src_mtime


def _build():
    """Build under a file lock (test workers import this concurrently);
    the library is written under a temporary name and renamed, so no
    process ever loads a half-written file."""
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return
        tmp = f"{_SO}.{os.getpid()}.tmp"
        r = subprocess.run(["sh", os.path.join(_DIR, "build.sh"), tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"native host library build failed:\n{r.stderr}")
        os.replace(tmp, _SO)


def _load():
    if _stale():
        _build()
    lib = ct.CDLL(_SO)

    u16p = ct.c_void_p   # raw addresses (fast extraction)
    lib.msac_sizeof.restype = ct.c_size_t
    lib.msac_init.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_size_t,
                              ct.c_int]
    lib.msac_decode_bool_equi.argtypes = [ct.c_void_p]
    lib.msac_decode_bool_equi.restype = ct.c_uint
    lib.msac_decode_bool.argtypes = [ct.c_void_p, ct.c_uint]
    lib.msac_decode_bool.restype = ct.c_uint
    lib.msac_decode_bool_adapt.argtypes = [ct.c_void_p, u16p]
    lib.msac_decode_bool_adapt.restype = ct.c_uint
    lib.msac_decode_symbol_adapt.argtypes = [ct.c_void_p, u16p, ct.c_uint]
    lib.msac_decode_symbol_adapt.restype = ct.c_uint
    lib.msac_decode_hi_tok.argtypes = [ct.c_void_p, u16p]
    lib.msac_decode_hi_tok.restype = ct.c_uint
    lib.msac_decode_bools.argtypes = [ct.c_void_p, ct.c_uint]
    lib.msac_decode_bools.restype = ct.c_uint
    lib.msac_decode_golomb.argtypes = [ct.c_void_p]
    lib.msac_decode_golomb.restype = ct.c_uint
    lib.msac_decode_subexp.argtypes = [ct.c_void_p, ct.c_int, ct.c_int,
                                       ct.c_uint]
    lib.msac_decode_subexp.restype = ct.c_int
    lib.msac_get_rng.argtypes = [ct.c_void_p]
    lib.msac_get_rng.restype = ct.c_uint32
    lib.msac_get_cnt.argtypes = [ct.c_void_p]
    lib.msac_get_cnt.restype = ct.c_int
    lib.msac_get_dif.argtypes = [ct.c_void_p]
    lib.msac_get_dif.restype = ct.c_uint64
    lib.msac_get_pos.argtypes = [ct.c_void_p]
    lib.msac_get_pos.restype = ct.c_size_t
    lib.coef_decode_block.argtypes = [
        ct.c_void_p,
        u16p, ct.c_int,           # eob_bin_cdf, eob_bin_count
        u16p, u16p, u16p, u16p,   # eob_hi_bit, eob_base, base, br
        u16p,                     # dc_sign
        ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_int,  # class/geom
        ct.c_void_p, ct.c_void_p,  # scan, lo_ctx_offsets
        ct.c_int32, ct.c_int32, ct.c_void_p,  # dq_dc, dq_ac, qm
        ct.c_int, ct.c_int32,     # dq_shift, cf_max
        ct.c_void_p, ct.POINTER(ct.c_int32),  # cf_out, eob_out
    ]
    lib.coef_decode_block.restype = ct.c_int
    for f in (lib.ipred_z1_loop, lib.ipred_z2_loop, lib.ipred_z3_loop):
        f.restype = None
    lib.ipred_z1_loop.argtypes = [ct.c_void_p, ct.c_int, ct.c_int,
                                  ct.c_int, ct.c_int, ct.c_int,
                                  ct.c_void_p]
    lib.ipred_z2_loop.argtypes = [ct.c_void_p, ct.c_int, ct.c_int,
                                  ct.c_int, ct.c_int, ct.c_int, ct.c_int,
                                  ct.c_void_p]
    lib.ipred_z3_loop.argtypes = [ct.c_void_p, ct.c_int, ct.c_int,
                                  ct.c_int, ct.c_int, ct.c_int,
                                  ct.c_void_p]
    return lib


LIB = _load()


def _u16p(arr):
    # ct.addressof(from_buffer) is ~4x faster than ct.cast(ctypes.data)
    # and this runs per decoded symbol; read-only arrays (memoized spec
    # tables) fall back to the slower path
    try:
        return ct.addressof(ct.c_char.from_buffer(arr))
    except (TypeError, ValueError):
        return arr.ctypes.data


class NativeMsac:
    """Bit-exact native counterpart of host/msac.py Msac."""

    __slots__ = ("_buf", "_st", "allow_update_cdf")

    def __init__(self, data: bytes, disable_cdf_update: bool = False):
        self._buf = bytes(data)  # keep alive; C keeps a pointer into it
        self._st = ct.create_string_buffer(LIB.msac_sizeof())
        LIB.msac_init(self._st, self._buf, len(self._buf),
                      int(disable_cdf_update))
        self.allow_update_cdf = not disable_cdf_update

    @property
    def rng(self):
        return LIB.msac_get_rng(self._st)

    @property
    def cnt(self):
        return LIB.msac_get_cnt(self._st)

    @property
    def dif(self):
        return int(LIB.msac_get_dif(self._st))

    @property
    def pos(self):
        return LIB.msac_get_pos(self._st)

    def decode_bool_equi(self):
        return LIB.msac_decode_bool_equi(self._st)

    def decode_bool(self, f):
        return LIB.msac_decode_bool(self._st, f)

    def decode_bool_adapt(self, cdf):
        return LIB.msac_decode_bool_adapt(self._st, _u16p(cdf))

    def decode_symbol_adapt(self, cdf, n_symbols):
        return LIB.msac_decode_symbol_adapt(self._st, _u16p(cdf),
                                            n_symbols)

    def decode_hi_tok(self, cdf):
        return LIB.msac_decode_hi_tok(self._st, _u16p(cdf))

    def decode_bools(self, n):
        return LIB.msac_decode_bools(self._st, n)

    def decode_golomb(self):
        return LIB.msac_decode_golomb(self._st)

    def decode_subexp(self, ref, n, k):
        return LIB.msac_decode_subexp(self._st, ref, n, k)

    def coef_decode_block(self, eob_bin_cdf, eob_bin_count, eob_hi_bit_cdf,
                          eob_base_cdf, base_cdf, br_cdf, dc_sign_cdf,
                          tx_class, sw4, sh4, lw, lh, scan,
                          lo_ctx_offsets, dq_dc, dq_ac, qm, dq_shift,
                          cf_max):
        """Returns (cf flat int32 [dav1d y+x*sh layout], eob, cf_ctx)."""
        cf = np.zeros((4 * sw4) * (4 * sh4), np.int32)
        eob = ct.c_int32()
        cf_ctx = LIB.coef_decode_block(
            self._st,
            _u16p(eob_bin_cdf), eob_bin_count,
            _u16p(eob_hi_bit_cdf), _u16p(eob_base_cdf), _u16p(base_cdf),
            _u16p(br_cdf), _u16p(dc_sign_cdf),
            tx_class, sw4, sh4, lw, lh,
            _u16p(scan) if scan is not None else None,
            (_u16p(lo_ctx_offsets)
             if lo_ctx_offsets is not None else None),
            dq_dc, dq_ac,
            _u16p(qm) if qm is not None else None,
            dq_shift, cf_max,
            _u16p(cf), ct.byref(eob))
        return cf, eob.value, cf_ctx
