"""Loop restoration (Wiener and self-guided) as PyTorch ops, bit-exact.

Port of ``dav1d_mirror_tpu/ops/looprestoration_tpu.py``. Each (stripe,
unit) region filters independently from the pre-LR snapshot and the
pre-CDEF boundary rows, so the host batches every stripe-unit of one
geometry: ``pad_stripes`` gathers the (h+6, w+6) padded windows of a batch
on the device, ``wiener_batch`` runs the separable 7-tap filter as shifted
multiply-adds, and ``sgr_batch`` the self-guided filter over cumulative-sum
box sums. All arithmetic is int32 except where dav1d computes in
``unsigned`` (the SGR strength and ``A`` products): there the values pass
2^31, so those products are taken in int64 and masked to 32 bits at the
same points, which keeps dav1d's unsigned semantics exactly.

Bit-exact with dav1d src/looprestoration_tmpl.c (wiener :134, boxsum
:214/:291, selfguided :350).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .spec_consts import SGR_X_BY_X

_U32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _x_by_x_table(device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(SGR_X_BY_X, np.int64), device=device)


def pad_stripes(pre_lr, pre, xs, ys, edges, w: int, h: int):
    """Batched (h+6, w+6) stripe windows gathered from the pre-LR plane
    (body) and the pre-CDEF plane (top/bottom boundary rows, dav1d's
    lr_copy semantics). Edge replication is expressed as clamped gather
    indices.

    pre_lr/pre: (H, W) int32 planes. xs/ys: (B,) unit origins.
    edges: (B,) LR_HAVE_* masks. Returns (B, h+6, w+6) int32. Every
    index is clamped into the plane (the reference's gathers clamp)."""
    dev = pre_lr.device
    ph, pw = pre_lr.shape
    have_l = edges & 1                     # LR_HAVE_LEFT
    have_r = (edges >> 1) & 1
    have_t = (edges >> 2) & 1
    have_b = (edges >> 3) & 1

    c = torch.arange(w + 6, device=dev, dtype=torch.int32)[None, :]
    lo = -3 * have_l[:, None]
    hi = (w - 1) + 3 * have_r[:, None]
    col = xs[:, None] + torch.clamp(c - 3, min=lo, max=hi)
    col = col.clamp(0, pw - 1).long()      # (B, w+6)

    r = torch.arange(h + 6, device=dev, dtype=torch.int32)[None, :]
    # body rows (and top/bottom replication when boundary rows absent)
    row_lr = (ys[:, None] + (r - 3).clamp(0, h - 1)).clamp(0, ph - 1)
    # boundary rows from the pre-CDEF plane:
    #   r 0,1 -> y-2 ; r 2 -> y-1 ; r h+3 -> y+h ; r h+4,h+5 -> y+h+1
    row_pre = torch.where(r < 3, ys[:, None] - torch.where(r < 2, 2, 1),
                          ys[:, None] + h + (r > h + 3).to(torch.int32))
    row_pre = row_pre.clamp(0, pre.shape[0] - 1)
    use_pre = ((r < 3) & (have_t[:, None] == 1)) | \
              ((r >= h + 3) & (have_b[:, None] == 1))   # (B, h+6)

    body = pre_lr[row_lr.long()[:, :, None], col[:, None, :]]
    bound = pre[row_pre.long()[:, :, None], col[:, None, :]]
    return torch.where(use_pre[:, :, None], bound, body)


def wiener_batch(padded, fh, fv, w: int, h: int, bitdepth: int):
    """padded: (B, h+6, w+6) int32 stripes; fh/fv: (B, 7) int32 filters.
    Returns (B, h, w) filtered pixels."""
    round_bits_h = 3 + (bitdepth == 12) * 2
    rnd_h = 1 << (round_bits_h - 1)
    clip_limit = 1 << (bitdepth + 1 + 7 - round_bits_h)
    base = 1 << (bitdepth + 6)

    hor = padded[:, :, 0:w] * fh[:, 0, None, None]
    for k in range(1, 7):
        hor = hor + padded[:, :, k:k + w] * fh[:, k, None, None]
    hor = ((hor + (base + rnd_h)) >> round_bits_h).clamp(0, clip_limit - 1)

    round_bits_v = 11 - (bitdepth == 12) * 2
    rnd_v = 1 << (round_bits_v - 1)
    round_offset = 1 << (bitdepth + round_bits_v - 1)
    out = hor[:, 0:h] * fv[:, 0, None, None]
    for k in range(1, 7):
        out = out + hor[:, k:k + h] * fv[:, k, None, None]
    return ((out + (rnd_v - round_offset)) >> round_bits_v).clamp(
        0, (1 << bitdepth) - 1)


def _boxsum_b(padded, rad: int):
    """padded: (B, H, W) int32. Returns (sum, sumsq) int32 of
    (2rad+1)^2 boxes; result[b, y, x] is the box centred at
    padded[b, y+rad, x+rad]. The running sums are int64 (a box sum fits
    int32, its prefix sums need not)."""
    a = padded.to(torch.int64)
    n = 2 * rad + 1

    def box(v):
        cs = torch.nn.functional.pad(torch.cumsum(v, dim=1), (0, 0, 1, 0))
        vs = cs[:, n:] - cs[:, :-n]
        cs2 = torch.nn.functional.pad(torch.cumsum(vs, dim=2), (1, 0))
        return (cs2[:, :, n:] - cs2[:, :, :-n]).to(torch.int32)
    return box(a), box(a * a)


def selfguided_batch(padded, s, w: int, h: int, n: int, bitdepth: int):
    """padded: (B, h+6, w+6); s: (B,) sgr strength. Returns (B, h, w)
    int32 pre-weight filter outputs (dav1d selfguided_filter)."""
    sgr_one_by_x = 164 if n == 25 else 455
    bd_m8 = bitdepth - 8
    rad = 2 if n == 25 else 1

    box_s, box_s2 = _boxsum_b(padded, rad)
    # centre grid: unit coords [-1, h+1) x [-1, w+1); padded centre (2+j, 2+i)
    H2, W2 = h + 2, w + 2
    sv = box_s[:, 2 - rad:2 - rad + H2, 2 - rad:2 - rad + W2]
    sv2 = box_s2[:, 2 - rad:2 - rad + H2, 2 - rad:2 - rad + W2]

    a = (sv2 + ((1 << (2 * bd_m8)) >> 1)) >> (2 * bd_m8)
    b = (sv + ((1 << bd_m8) >> 1)) >> bd_m8
    # dav1d's unsigned products: p * s reaches ~4.2e9 (> int32) at n = 9
    pval = torch.clamp(a * n - b * b, min=0).to(torch.int64)
    z = (((pval * s.to(torch.int64)[:, None, None]) & _U32) +
         (1 << 19)) & _U32
    z = z >> 20
    x = _x_by_x_table(padded.device)[z.clamp(max=255)]       # int64
    prod = (((x * sv.to(torch.int64)) & _U32) * sgr_one_by_x) & _U32
    A = (((prod + (1 << 11)) & _U32) >> 12).to(torch.int32)
    B = x.to(torch.int32)

    if n == 25:
        # A/B only computed on every other row (centre rows -1, 1, 3, ...)
        keep = (torch.arange(H2, device=padded.device) % 2) == 0
        A = torch.where(keep[None, :, None], A, 0)
        B = torch.where(keep[None, :, None], B, 0)

    src = padded[:, 3:3 + h, 3:3 + w]

    def nb(P, dy, dx):
        return P[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    if n == 25:
        six_b = ((nb(B, -1, 0) + nb(B, 1, 0)) * 6 +
                 (nb(B, -1, -1) + nb(B, 1, -1) +
                  nb(B, -1, 1) + nb(B, 1, 1)) * 5)
        six_a = ((nb(A, -1, 0) + nb(A, 1, 0)) * 6 +
                 (nb(A, -1, -1) + nb(A, 1, -1) +
                  nb(A, -1, 1) + nb(A, 1, 1)) * 5)
        even = (six_a - six_b * src + (1 << 8)) >> 9
        five_b = nb(B, 0, 0) * 6 + (nb(B, 0, -1) + nb(B, 0, 1)) * 5
        five_a = nb(A, 0, 0) * 6 + (nb(A, 0, -1) + nb(A, 0, 1)) * 5
        odd = (five_a - five_b * src + (1 << 7)) >> 8
        rows_even = (torch.arange(h, device=padded.device) % 2) == 0
        # last row when h is odd uses the even (six-neighbour) formula
        return torch.where(rows_even[None, :, None], even, odd)
    eight_b = ((nb(B, 0, 0) + nb(B, 0, -1) + nb(B, 0, 1) +
                nb(B, -1, 0) + nb(B, 1, 0)) * 4 +
               (nb(B, -1, -1) + nb(B, 1, -1) +
                nb(B, -1, 1) + nb(B, 1, 1)) * 3)
    eight_a = ((nb(A, 0, 0) + nb(A, 0, -1) + nb(A, 0, 1) +
                nb(A, -1, 0) + nb(A, 1, 0)) * 4 +
               (nb(A, -1, -1) + nb(A, 1, -1) +
                nb(A, -1, 1) + nb(A, 1, 1)) * 3)
    return (eight_a - eight_b * src + (1 << 8)) >> 9


def sgr_batch(padded, cur, s0, s1, w0, w1, w: int, h: int, bitdepth: int,
              kind: int):
    """kind: 0 = 5x5, 1 = 3x3, 2 = both. cur: (B, h, w) current
    (post-CDEF) pixels; returns filtered (B, h, w) int32."""
    v = torch.zeros(cur.shape, dtype=torch.int32, device=cur.device)
    if kind in (0, 2):
        v = v + w0[:, None, None] * selfguided_batch(padded, s0, w, h, 25,
                                                     bitdepth)
    if kind in (1, 2):
        v = v + w1[:, None, None] * selfguided_batch(padded, s1, w, h, 9,
                                                     bitdepth)
    out = cur + ((v + (1 << 10)) >> 11)
    return out.clamp(0, (1 << bitdepth) - 1).to(torch.int32)
