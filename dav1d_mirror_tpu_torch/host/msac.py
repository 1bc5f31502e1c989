# Copied from dav1d_mirror_tpu/host/msac.py.
"""AV1 multi-symbol adaptive arithmetic (range) decoder — host stage.

This is the inherently serial hot loop of the decoder; it stays on the host.
This Python implementation is the behavioral specification and the fallback;
the production path is the C++ implementation in ``native/`` (same
semantics, validated against this and against the reference via round-trip
tests).

Semantics per the AV1 spec's symbol decoder (daala EC), cross-checked against
dav1d ``src/msac.c`` (15-bit probabilities, EC_PROB_SHIFT=6, EC_MIN_PROB=4,
64-bit window, CDF adaptation rule at src/msac.c:154-163).
"""
from __future__ import annotations

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
W = 64  # window size in bits
MASK = (1 << W) - 1


def inv_recenter(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if (v & 1) == 0:
        return (v >> 1) + r
    return r - ((v + 1) >> 1)


class Msac:
    __slots__ = ("buf", "pos", "end", "dif", "rng", "cnt",
                 "allow_update_cdf")

    def __init__(self, data: bytes, disable_cdf_update: bool = False,
                 start: int = 0, end: int | None = None):
        self.buf = data
        self.pos = start
        self.end = len(data) if end is None else end
        self.dif = 0
        self.rng = 0x8000
        self.cnt = -15
        self.allow_update_cdf = not disable_cdf_update
        self._refill()

    def _refill(self):
        c = W - self.cnt - 24
        dif = self.dif
        pos, end, buf = self.pos, self.end, self.buf
        while True:  # c >= 0 guaranteed on entry
            if pos >= end:
                # past the end: fill remaining low bits with 1s
                dif |= (1 << (c + 8)) - 1
                break
            dif |= (buf[pos] ^ 0xFF) << c
            pos += 1
            c -= 8
            if c < 0:
                break
        self.dif = dif & MASK
        self.cnt = W - c - 24
        self.pos = pos

    def _norm(self, dif: int, rng: int):
        d = 16 - rng.bit_length()
        self.dif = (dif << d) & MASK
        self.rng = rng << d
        cnt = self.cnt
        self.cnt = cnt - d
        if cnt < d:  # matches the unsigned compare: cnt<0 always refills
            self._refill()

    def decode_bool_equi(self) -> int:
        r = self.rng
        v = ((r >> 8) << 7) + EC_MIN_PROB
        vw = v << (W - 16)
        if self.dif >= vw:
            self._norm(self.dif - vw, r - v)
            return 0
        self._norm(self.dif, v)
        return 1

    def decode_bool(self, f: int) -> int:
        r = self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
            + EC_MIN_PROB
        vw = v << (W - 16)
        if self.dif >= vw:
            self._norm(self.dif - vw, r - v)
            return 0
        self._norm(self.dif, v)
        return 1

    def decode_bool_adapt(self, cdf) -> int:
        bit = self.decode_bool(int(cdf[0]))
        if self.allow_update_cdf:
            count = int(cdf[1])
            rate = 4 + (count >> 4)
            if bit:
                cdf[0] = int(cdf[0]) + ((32768 - int(cdf[0])) >> rate)
            else:
                cdf[0] = int(cdf[0]) - (int(cdf[0]) >> rate)
            cdf[1] = count + (count < 32)
        return bit

    def decode_symbol_adapt(self, cdf, n_symbols: int) -> int:
        c = self.dif >> (W - 16)
        r = self.rng >> 8
        u = v = self.rng
        val = -1
        while True:
            val += 1
            u = v
            v = (r * (int(cdf[val]) >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)
            v += EC_MIN_PROB * (n_symbols - val)
            if c >= v:
                break
        self._norm(self.dif - (v << (W - 16)), u - v)
        if self.allow_update_cdf:
            count = int(cdf[n_symbols])
            rate = 4 + (count >> 4) + (n_symbols > 2)
            for i in range(val):
                cdf[i] = int(cdf[i]) + ((32768 - int(cdf[i])) >> rate)
            for i in range(val, n_symbols):
                cdf[i] = int(cdf[i]) - (int(cdf[i]) >> rate)
            cdf[n_symbols] = count + (count < 32)
        return val

    def decode_hi_tok(self, cdf) -> int:
        tok_br = self.decode_symbol_adapt(cdf, 3)
        tok = 3 + tok_br
        if tok_br == 3:
            tok_br = self.decode_symbol_adapt(cdf, 3)
            tok = 6 + tok_br
            if tok_br == 3:
                tok_br = self.decode_symbol_adapt(cdf, 3)
                tok = 9 + tok_br
                if tok_br == 3:
                    tok = 12 + self.decode_symbol_adapt(cdf, 3)
        return tok

    def decode_bools(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bool_equi()
        return v

    def decode_subexp(self, ref: int, n: int, k: int) -> int:
        assert n >> k == 8
        a = 0
        if self.decode_bool_equi():
            if self.decode_bool_equi():
                k += self.decode_bool_equi() + 1
            a = 1 << k
        v = self.decode_bools(k) + a
        if ref * 2 <= n:
            return inv_recenter(ref, v)
        return n - 1 - inv_recenter(n - 1 - ref, v)
