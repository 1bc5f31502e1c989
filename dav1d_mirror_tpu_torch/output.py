# Copied from dav1d_mirror_tpu/output.py (XXH3Muxer imports xxhash at use).
"""Output muxers (dav1d tools/output/*): md5, xxh3, yuv, y4m2, null.

The md5 muxer matches tools/output/md5.c bit-for-bit: one cumulative MD5
over every frame's visible plane rows (16-bit little-endian samples for
high bit depth), printed as 32 hex chars + newline; `verify` compares
against an expected digest like dav1d's --verify."""
from __future__ import annotations

import hashlib
import sys

import numpy as np

from .host import headers as h


def _plane_bytes(pic, plane):
    dt = np.uint8 if pic.bitdepth == 8 else np.dtype("<u2")
    return np.ascontiguousarray(plane.astype(dt)).tobytes()


class NullMuxer:
    def __init__(self, path=None):
        self.n = 0

    def write(self, pic):
        self.n += 1

    def finish(self):
        return None


class _HashMuxer:
    """One cumulative hash over every frame's visible plane rows, written
    as its hex digest + newline to `path` (stdout for None or "-")."""

    def __init__(self, hasher, path=None):
        self._h = hasher
        self.path = path
        self.n = 0

    def write(self, pic):
        self.n += 1
        for plane in pic.planes:
            self._h.update(_plane_bytes(pic, plane))

    def digest(self):
        return self._h.hexdigest()

    def finish(self):
        out = self.digest() + "\n"
        if self.path and self.path != "-":
            with open(self.path, "w") as f:
                f.write(out)
        else:
            sys.stdout.write(out)
        return self.digest()


class MD5Muxer(_HashMuxer):
    def __init__(self, path=None):
        super().__init__(hashlib.md5(), path)


class XXH3Muxer(_HashMuxer):
    """XXH3-128 muxer (dav1d tools/output/xxhash.c:41-142): the canonical
    32-hex digest of the same byte sequence as the md5 muxer. Needs the
    `xxhash` package, imported when the muxer is opened."""

    def __init__(self, path=None):
        try:
            import xxhash
        except ImportError as e:
            raise RuntimeError(
                "the xxh3 muxer needs the xxhash package, which is not "
                "installed; use --muxer md5") from e
        super().__init__(xxhash.xxh3_128(), path)


class YUVMuxer:
    def __init__(self, path):
        self.f = open(path, "wb")
        self.n = 0

    def write(self, pic):
        self.n += 1
        for plane in pic.planes:
            self.f.write(_plane_bytes(pic, plane))

    def finish(self):
        self.f.close()
        return None


class Y4MMuxer:
    """tools/output/y4m2.c: YUV4MPEG2 with colourspace tag."""

    def __init__(self, path, fps=(30, 1)):
        self.f = open(path, "wb")
        self.n = 0
        self.fps = fps
        self._wrote_header = False

    def _header(self, pic):
        ss = {h.PIXEL_LAYOUT_I400: "mono", h.PIXEL_LAYOUT_I420: "420jpeg",
              h.PIXEL_LAYOUT_I422: "422", h.PIXEL_LAYOUT_I444: "444"}
        cs = ss[pic.layout]
        if pic.bitdepth > 8:
            base = {h.PIXEL_LAYOUT_I400: "mono", h.PIXEL_LAYOUT_I420: "420",
                    h.PIXEL_LAYOUT_I422: "422", h.PIXEL_LAYOUT_I444: "444"}
            cs = f"{base[pic.layout]}p{pic.bitdepth}"
        hdr = (f"YUV4MPEG2 W{pic.width} H{pic.height} "
               f"F{self.fps[0]}:{self.fps[1]} Ip C{cs}\n")
        self.f.write(hdr.encode())

    def write(self, pic):
        if not self._wrote_header:
            self._header(pic)
            self._wrote_header = True
        self.f.write(b"FRAME\n")
        for plane in pic.planes:
            self.f.write(_plane_bytes(pic, plane))
        self.n += 1

    def finish(self):
        self.f.close()
        return None


MUXERS = {"null": NullMuxer, "md5": MD5Muxer, "xxh3": XXH3Muxer,
          "yuv": YUVMuxer, "y4m2": Y4MMuxer}


def open_muxer(name, path, fps=(30, 1)):
    if name == "y4m2":
        return Y4MMuxer(path, fps=fps)
    return MUXERS[name](path)
