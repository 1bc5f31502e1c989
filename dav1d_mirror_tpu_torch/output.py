# Copied from dav1d_mirror_tpu/output.py (the md5 muxer only).
"""Output muxer (dav1d tools/output/md5.c).

The md5 muxer matches tools/output/md5.c bit-for-bit: one cumulative MD5
over every frame's visible plane rows (16-bit little-endian samples for
high bit depth), printed as 32 hex chars + newline."""
from __future__ import annotations

import hashlib
import sys

import numpy as np


class MD5Muxer:
    def __init__(self, path=None):
        self._md5 = hashlib.md5()
        self.path = path
        self.n = 0

    def write(self, pic):
        self.n += 1
        for plane in pic.planes:
            dt = np.uint8 if pic.bitdepth == 8 else np.dtype("<u2")
            self._md5.update(np.ascontiguousarray(plane.astype(dt)).tobytes())

    def digest(self):
        return self._md5.hexdigest()

    def finish(self):
        out = self.digest() + "\n"
        if self.path and self.path != "-":
            with open(self.path, "w") as f:
                f.write(out)
        else:
            sys.stdout.write(out)
        return self.digest()
