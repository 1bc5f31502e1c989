"""Batched inverse transforms as PyTorch ops on int32 tensors.

Port of ``dav1d_mirror_tpu/ops/itx.py``. The host planner buckets tx
blocks by tx size and emits dense (B, sh, sw) int32 coefficient batches;
this module turns each bucket into (B, h, w) residuals with bit-exact AV1
integer arithmetic, vectorized over the batch. The 1D butterflies are
``ops/itx_1d.py``, unchanged: they run on any operand with +, -, *, >>
and ``.clip``, torch tensors included.

``itx_bucket`` is the plain version of the inverse-transform kernel
(``csrc/itx.cu``, wrapper ``ops/itx_cuda.py``): one residual bucket from
its compact coefficients to the plane, as the reference executor composes
``_expand_cf``, the transform and the clip-add scatter
(``dav1d_mirror_tpu/models/frame_exec.py:94-133``).

Reference parity: dav1d `src/itx_tmpl.c:40-100` (composer semantics),
`src/itx_1d.c` (butterflies).
"""
from __future__ import annotations

import torch

from .itx_1d import get_1d_fn, iwht4
from .itx_meta import TX_INFO, TXTYPE_TO_1D, WHT_WHT
from .mc import scatter_units, unit_index
from .spec_consts import clip_ranges

MODES = ("add", "raw", "hres")


def _apply_1d(arr, fn, mn, mx, n_out):
    """arr: (n_in, M) int32 -> (n_out, M), applying fn along axis 0."""
    out = fn([arr[k] for k in range(arr.shape[0])], mn, mx)
    assert len(out) == n_out
    return torch.stack(out, dim=0)


def _residual_core(coefs, tx: int, txtp: int, bitdepth: int):
    """coefs: (B, sh, sw) int32, de-transposed layout coefs[b, y, x].
    Returns (B, h, w) int32 residuals (to be added + pixel-clipped by the
    reconstruction stage)."""
    w, h, shift = TX_INFO[tx]
    sw, sh = min(w, 32), min(h, 32)
    B = coefs.shape[0]
    assert tuple(coefs.shape[1:]) == (sh, sw), (coefs.shape, (sh, sw))
    rnd = (1 << shift) >> 1

    if txtp == WHT_WHT:
        c = coefs.to(torch.int32) >> 2
        # row pass along x, batched over (B, y)
        arr = c.permute(2, 0, 1).reshape(4, B * 4)
        tmp = torch.stack(iwht4([arr[k] for k in range(4)]), dim=0)
        # tmp: (x, B, y) -> col pass along y
        arr = tmp.reshape(4, B, 4).permute(2, 1, 0).reshape(4, B * 4)
        out = torch.stack(iwht4([arr[k] for k in range(4)]), dim=0)
        return out.reshape(4, B, 4).permute(1, 0, 2)

    is_rect2 = (w * 2 == h) or (h * 2 == w)
    row_fam, col_fam = TXTYPE_TO_1D[txtp]
    row_min, row_max, col_min, col_max = clip_ranges(bitdepth)

    c = coefs.to(torch.int32)
    if is_rect2:
        c = (c * 181 + 128) >> 8

    # row pass: transform along x; batch over (B, sh)
    arr = c.permute(2, 0, 1).reshape(sw, B * sh)
    tmp = _apply_1d(arr, get_1d_fn(row_fam, w), row_min, row_max, w)

    tmp = ((tmp + rnd) >> shift).clamp(col_min, col_max)

    # col pass: transform along y; batch over (B, w)
    arr = tmp.reshape(w, B, sh).permute(2, 1, 0).reshape(sh, B * w)
    out = _apply_1d(arr, get_1d_fn(col_fam, h), col_min, col_max, h)

    out = (out + 8) >> 4
    return out.reshape(h, B, w).permute(1, 0, 2)


def itx_families(n: int) -> tuple:
    """1D transform families that exist at line length n (dav1d
    src/itx_1d.c: adst tops out at 16, identity at 32, only dct has 64).
    The order is the selector index contract of the *_multi kernels."""
    if n == 64:
        return ("dct",)
    if n == 32:
        return ("dct", "identity")
    return ("dct", "adst", "flipadst", "identity")


def itx_multi_sel(tx: int, txtp: int) -> tuple[int, int]:
    """(row_sel, col_sel) family indices for a (tx, txtp) pair, the
    per-block data consumed by _residual_multi_core."""
    w, h, _ = TX_INFO[tx]
    row_fam, col_fam = TXTYPE_TO_1D[txtp]
    return (itx_families(w).index(row_fam),
            itx_families(h).index(col_fam))


def _select_variants(variants, sel, reps):
    """variants: list of (n_out, B*lines) tensors, one per 1D family;
    sel: (B,) family index per block; reps: lines per block along the
    flattened column axis. Every family is computed, then each column
    takes its block's family: one op per tx size covers every type."""
    stacked = torch.stack(variants)                       # (F, n_out, B*L)
    sel_cols = sel.long().repeat_interleave(reps)          # (B*L,)
    idx = sel_cols[None, None, :].expand(1, stacked.shape[1], -1)
    return torch.gather(stacked, 0, idx)[0]


def _residual_multi_core(coefs, row_sel, col_sel, tx: int, bitdepth: int):
    """Like _residual_core but with the transform TYPE as per-block
    data: row_sel/col_sel are (B,) indices into itx_families(w/h).
    Bit-exact: each variant is the exact butterfly network; selection
    doesn't change arithmetic. WHT (lossless 4x4) is not covered."""
    w, h, shift = TX_INFO[tx]
    sw, sh = min(w, 32), min(h, 32)
    B = coefs.shape[0]
    assert tuple(coefs.shape[1:]) == (sh, sw), (coefs.shape, (sh, sw))
    rnd = (1 << shift) >> 1
    row_fams = itx_families(w)
    col_fams = itx_families(h)
    row_min, row_max, col_min, col_max = clip_ranges(bitdepth)

    c = coefs.to(torch.int32)
    if (w * 2 == h) or (h * 2 == w):
        c = (c * 181 + 128) >> 8

    # row pass along x; flattened columns are (b, y) pairs
    arr = c.permute(2, 0, 1).reshape(sw, B * sh)
    if len(row_fams) == 1:
        tmp = _apply_1d(arr, get_1d_fn(row_fams[0], w), row_min, row_max,
                        w)
    else:
        tmp = _select_variants(
            [_apply_1d(arr, get_1d_fn(f, w), row_min, row_max, w)
             for f in row_fams], row_sel, sh)

    tmp = ((tmp + rnd) >> shift).clamp(col_min, col_max)

    # col pass along y; flattened columns are (b, x) pairs
    arr = tmp.reshape(w, B, sh).permute(2, 1, 0).reshape(sh, B * w)
    if len(col_fams) == 1:
        out = _apply_1d(arr, get_1d_fn(col_fams[0], h), col_min, col_max,
                        h)
    else:
        out = _select_variants(
            [_apply_1d(arr, get_1d_fn(f, h), col_min, col_max, h)
             for f in col_fams], col_sel, w)

    out = (out + 8) >> 4
    return out.reshape(h, B, w).permute(1, 0, 2)


def itx_residual_multi(coefs, row_sel, col_sel, tx: int, bitdepth: int):
    return _residual_multi_core(coefs, row_sel, col_sel, tx, bitdepth)


def itx_residual(coefs, tx: int, txtp: int, bitdepth: int):
    return _residual_core(coefs, tx, txtp, bitdepth)


def _expand_cf(vals, pos, sh: int, sw: int):
    """Device-side inverse of compact_cf: (B, K)+(B, K) -> (B, sh, sw).
    Pad lanes carry position S = sh*sw; they land in an extra sink
    column that is cut off (the reference drops them)."""
    B = vals.shape[0]
    S = sh * sw
    dense = vals.new_zeros((B, S + 1))
    dense.scatter_(1, pos.long().clamp(0, S), vals)
    return dense[:, :S].reshape(B, sh, sw)


def _add_units(plane, res, ys, xs, bitdepth: int):
    """Clip-add (B, uh, uw) residual units onto the plane at (ys, xs), in
    place; elements outside the plane (pad rows, edge-cut units) are
    neither read nor written."""
    uh, uw = res.shape[1], res.shape[2]
    yy, xx, ok = unit_index(ys, xs, uh, uw, plane.shape)
    yy, xx = yy[ok].long(), xx[ok].long()
    plane[yy, xx] = (plane[yy, xx] + res[ok]).clamp(
        0, (1 << bitdepth) - 1).to(plane.dtype)
    return plane


def itx_bucket(mode: str, vals, pos, sel, tx: int, bitdepth: int,
               plane=None, ys=None, xs=None, out_dtype=torch.int32):
    """One residual bucket of tx size `tx`, the plain version of the
    ``csrc/itx.cu`` kernel.

    vals (B, K) int32 coefficients at positions pos (B, K) int32 of the
    (sh, sw) block (a pad lane carries sh*sw), or pos None: vals is the
    dense (B, sh*sw) block. sel: the transform type, as a tuple of
    per-block family selectors (row_sel, col_sel), each (B,) int32 into
    itx_families(w) / itx_families(h), or as one TxfmType for the whole
    bucket (WHT_WHT: lossless 4x4). mode:
    - "add": clip-add the residuals onto `plane` at (ys, xs) (B,) int32,
      in place, and return the plane;
    - "raw": write them there, cast to the plane's dtype, in place;
    - "hres": return them as a new (B, h, w) tensor of `out_dtype`.
    Elements of a unit outside the plane are dropped."""
    if mode not in MODES:
        raise ValueError(f"itx_bucket: mode {mode!r}")
    w, h, _ = TX_INFO[tx]
    sh, sw = min(h, 32), min(w, 32)
    if pos is None:
        cf = vals.reshape(vals.shape[0], sh, sw)
    else:
        cf = _expand_cf(vals, pos, sh, sw)
    if isinstance(sel, tuple):
        res = _residual_multi_core(cf, sel[0], sel[1], tx, bitdepth)
    else:
        res = _residual_core(cf, tx, int(sel), bitdepth)
    if mode == "hres":
        return res.to(out_dtype)
    if mode == "raw":
        return scatter_units(plane, res, ys, xs, h, w)
    return _add_units(plane, res, ys, xs, bitdepth)
