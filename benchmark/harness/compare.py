"""The comparison that decides ``correct``: every picture the window's
decoder returned, every plane, held to the md5 of the same picture's
plane from the reference decode, which make_pools.py stored beside each
stream; and every picture due (one a temporal unit sent) returned.

A plane is hashed as dav1d's md5 muxer hashes it: 8-bit samples, or
16-bit little-endian above 8 bits.
"""
from __future__ import annotations

import hashlib
import sys

import numpy as np

# the JAX package and its libraries: none may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "dav1d_mirror_tpu")
# the number compared, with its limit (an exact comparison): pictures
# wrong or missing
LIMITS = {"failed_pictures": 0}


def plane_md5(plane, bitdepth: int) -> str:
    dt = np.uint8 if bitdepth == 8 else np.dtype("<u2")
    return hashlib.md5(
        np.ascontiguousarray(plane.astype(dt)).tobytes()).hexdigest()


def compare(visits: list, pool: list, grain_key: str) -> dict:
    """{attempted, checked, wrong_pictures, missing_pictures,
    failed_pictures} over `visits` (drive.Visit) of `pool`: a picture is
    wrong if any plane differs from the reference's, or if it comes beyond
    the pictures due; a picture due and never returned is missing; failed
    are both."""
    out = {"attempted": 0, "checked": 0, "wrong_pictures": 0,
           "missing_pictures": 0}
    for v in visits:
        expected = pool[v.stream].planes_md5[grain_key][:v.sent]
        out["attempted"] += len(expected)
        out["missing_pictures"] += max(0, len(expected) - len(v.pictures))
        for i, pic in enumerate(v.pictures):
            out["checked"] += 1
            if i >= len(expected) or len(pic.planes) != len(expected[i]) \
                    or any(plane_md5(p, pic.bitdepth) != e
                           for p, e in zip(pic.planes, expected[i])):
                out["wrong_pictures"] += 1
    out["failed_pictures"] = out["wrong_pictures"] + out["missing_pictures"]
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden (the whole name
    before the first dot: dav1d_mirror_tpu_torch is not dav1d_mirror_tpu)."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))
