# Copied from dav1d_mirror_tpu/utils/intops.py.
"""Bit-exact integer helpers shared by the NumPy references and JAX kernels.

AV1 reconstruction is defined over two's-complement integer arithmetic with
arithmetic right shifts.  Both NumPy and jax.numpy implement ``>>`` on signed
integers arithmetically, so the same expressions are usable from either side;
the helpers here exist to keep the rounding idioms in one place.

Reference semantics: dav1d `include/common/intops.h` (iclip/apply_sign/ulog2).
"""
from __future__ import annotations

import numpy as np


def iclip(v, lo, hi):
    """Clamp; works on numpy or jax arrays alike (uses the array's own ops)."""
    return v.clip(lo, hi) if hasattr(v, "clip") else max(lo, min(hi, v))


def iclip_np(v, lo, hi):
    return np.clip(v, lo, hi)


def round_shift(x, s):
    """(x + (1 << (s-1))) >> s with arithmetic shift; s must be >= 1."""
    return (x + (1 << (s - 1))) >> s


def apply_sign(v, s):
    """v if s >= 0 else -v (branchless form used in MV/sign decode)."""
    return -v if s < 0 else v


def ulog2(v: int) -> int:
    """Floor log2 of a positive integer."""
    return int(v).bit_length() - 1


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def align_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a
