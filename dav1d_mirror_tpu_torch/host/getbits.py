# Copied from dav1d_mirror_tpu/host/getbits.py.
"""MSB-first bit reader for OBU/header parsing.

Semantics match the AV1 spec readers f(n)/su(n)/uvlc/le/ns/uleb128
(cross-checked vs dav1d src/getbits.c).
"""
from __future__ import annotations

from ..utils.intops import ulog2
from .msac import inv_recenter


class GetBits:
    __slots__ = ("data", "pos", "bitpos", "error", "start", "end")

    def __init__(self, data, start: int = 0, end: int | None = None):
        self.data = data
        self.start = start
        self.end = len(data) if end is None else end
        self.pos = start  # byte position
        self.bitpos = 0   # bits consumed within current byte (0-7)
        self.error = 0

    def get_bit(self) -> int:
        if self.pos >= self.end:
            self.error = 1
            return 0
        b = (self.data[self.pos] >> (7 - self.bitpos)) & 1
        self.bitpos += 1
        if self.bitpos == 8:
            self.bitpos = 0
            self.pos += 1
        return b

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit()
        return v

    def get_sbits(self, n: int) -> int:
        """n-bit two's-complement (AV1 su(n))."""
        v = self.get_bits(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def get_uleb128(self) -> int:
        val = 0
        i = 0
        while True:
            v = self.get_bits(8)
            more = v & 0x80
            val |= (v & 0x7F) << i
            i += 7
            if not more or i >= 56:
                break
        if val > 0xFFFFFFFF or more:
            self.error = 1
            return 0
        return val

    def get_uniform(self, max_: int) -> int:
        """ns(max): output in [0, max-1]; max must be > 1."""
        l = ulog2(max_) + 1
        m = (1 << l) - max_
        v = self.get_bits(l - 1)
        return v if v < m else (v << 1) - m + self.get_bit()

    def get_vlc(self) -> int:
        if self.get_bit():
            return 0
        n_bits = 0
        while True:
            n_bits += 1
            if n_bits == 32:
                return 0xFFFFFFFF
            if self.get_bit():
                break
        return ((1 << n_bits) - 1) + self.get_bits(n_bits)

    def _subexp_u(self, ref: int, n: int) -> int:
        v = 0
        i = 0
        while True:
            b = 3 + i - 1 if i else 3
            if n < v + 3 * (1 << b):
                v += self.get_uniform(n - v + 1)
                break
            if not self.get_bit():
                v += self.get_bits(b)
                break
            v += 1 << b
            i += 1
        return inv_recenter(ref, v) if ref * 2 <= n \
            else n - inv_recenter(n - ref, v)

    def get_bits_subexp(self, ref: int, n: int) -> int:
        return self._subexp_u(ref + (1 << n), 2 << n) - (1 << n)

    def bytealign(self):
        if self.bitpos:
            self.bitpos = 0
            self.pos += 1

    def bit_position(self) -> int:
        return (self.pos - self.start) * 8 + self.bitpos

    def byte_position(self) -> int:
        """Position of next unread byte (after bytealign)."""
        return self.pos + (1 if self.bitpos else 0)
