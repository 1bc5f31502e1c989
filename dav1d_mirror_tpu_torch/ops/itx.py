"""Batched inverse transforms as PyTorch ops on int32 tensors.

Port of ``dav1d_mirror_tpu/ops/itx.py``. The host planner buckets tx
blocks by tx size and emits dense (B, sh, sw) int32 coefficient batches;
this module turns each bucket into (B, h, w) residuals with bit-exact AV1
integer arithmetic, vectorized over the batch. The 1D butterflies are
``ops/itx_1d.py``, unchanged: they run on any operand with +, -, *, >>
and ``.clip``, torch tensors included.

``itx_run`` is the plain version of the inverse-transform kernel
(``csrc/itx.cu``, wrapper ``ops/itx_cuda.py``): a work list of residual
buckets (``build_table``), one ``itx_bucket`` per entry. ``itx_bucket``
takes one bucket from its compact coefficients to the plane, as the
reference executor composes ``_expand_cf``, the transform and the
clip-add scatter (``dav1d_mirror_tpu/models/frame_exec.py:94-133``).

Reference parity: dav1d `src/itx_tmpl.c:40-100` (composer semantics),
`src/itx_1d.c` (butterflies).
"""
from __future__ import annotations

import torch

import numpy as np

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


# ---------------------------------------------------------------------
# the work list: csrc/itx.cu's table, and its plain version
# ---------------------------------------------------------------------
# the int32 fields of a table entry (csrc/itx.cu E_*): tx size, flags,
# plane index, K, B (rows of vals, pad rows included), real rows (the
# first n_real; the rest are pad rows), offsets of vals, pos, row and
# column selectors (F_FIXED: the families themselves), ys and xs in their
# buffers, offset of the entry's residuals in the run's flat hres output,
# the entry's first work item in the map; two spare (64 bytes an entry)
(E_TX, E_FLAGS, E_PLANE, E_K, E_B, E_NREAL, E_VALS, E_POS, E_RSEL, E_CSEL,
 E_YS, E_XS, E_HRES, E_CTA0, E_SPARE0, E_SPARE1) = range(16)
ENTRY = 16
# E_FLAGS bits: WHT (tx 0 only); vals, pos in the int16 buffer (else the
# int32 one); no pos (vals dense, K = sh * sw); fixed families
F_WHT, F_VALS16, F_POS16, F_DENSE, F_FIXED = 1, 2, 4, 8, 16
# threads a CTA, for every tx size (csrc/itx.cu CTA_THREADS)
CTA_THREADS = 128


def cta_geometry(tx: int) -> tuple[int, int]:
    """(threads a tx block, tx blocks a CTA) of the kernel at tx size `tx`:
    a thread for each row (min(h, 32)) and each column (w) of a block, a
    CTA of CTA_THREADS (csrc/itx.cu TX_BLOCKS_PER_CTA)."""
    w, h, _ = TX_INFO[tx]
    t = max(min(h, 32), w)
    return t, CTA_THREADS // t


def item_order(tx: int, K: int) -> tuple:
    """Sort key of an entry's work items in the map: the longest first
    (64-point lines, then 32-point, ..., then the most coefficients a
    block), so that they start in the kernel's first wave."""
    w, h, _ = TX_INFO[tx]
    return (-max(w, h), -K)


def work_rows(mode: str, B: int, n_real: int) -> int:
    """Rows the kernel visits: the real rows; in hres mode every row (a
    pad row writes the zeros of its residuals)."""
    return B if mode == "hres" else n_real


def build_table(mode: str, entries):
    """The work list of one run. entries: dicts of tx, flags, plane, K, B,
    n_real, vals, pos, rsel, csel, ys, xs (offsets, or for F_FIXED the
    families in rsel/csel). Returns (table, work, hres_views): the int32
    table (ENTRY ints an entry, then the work-item -> entry map, each
    entry's items together, longest first: item_order), work = (entries,
    work items), and for hres one (offset, B, h, w) an entry in the flat
    output."""
    if mode not in MODES:
        raise ValueError(f"build_table: mode {mode!r}")
    tab = np.zeros((len(entries), ENTRY), np.int32)
    views = []
    off = 0
    for i, e in enumerate(entries):
        tx = e["tx"]
        w, h, _ = TX_INFO[tx]
        if e["flags"] & F_WHT and tx != 0:
            raise ValueError("WHT is a 4x4 transform")
        tab[i, E_TX] = tx
        tab[i, E_FLAGS] = e["flags"]
        tab[i, E_PLANE] = e.get("plane", 0)
        for f, k in ((E_K, "K"), (E_B, "B"), (E_NREAL, "n_real"),
                     (E_VALS, "vals"), (E_POS, "pos"), (E_RSEL, "rsel"),
                     (E_CSEL, "csel"), (E_YS, "ys"), (E_XS, "xs")):
            tab[i, f] = e.get(k, 0)
        if mode == "hres":
            tab[i, E_HRES] = off
            views.append((off, e["B"], h, w))
            off += e["B"] * h * w
    order = sorted(range(len(entries)), key=lambda i: (
        item_order(entries[i]["tx"], entries[i]["K"]), i))
    items = []
    for i in order:
        e = entries[i]
        rows = work_rows(mode, e["B"], e["n_real"])
        tab[i, E_CTA0] = len(items)
        items.extend([i] * -(-rows // cta_geometry(e["tx"])[1]))
    table = np.concatenate([tab.reshape(-1), np.asarray(items, np.int32)])
    return table, (len(entries), len(items)), tuple(views)


def table_entries(tab, n_entries: int):
    """The entries of a table (a 1-D int32 tensor or array) as lists of
    ENTRY ints."""
    flat = np.asarray(tab.cpu() if isinstance(tab, torch.Tensor) else tab)
    return flat[:n_entries * ENTRY].reshape(n_entries, ENTRY).tolist()


def hres_flat(hres_views, dtype, device):
    """The run's flat hres output (uninitialized) and its (B, h, w) views,
    one an entry."""
    n = sum(B * h * w for _, B, h, w in hres_views)
    flat = torch.empty(n, dtype=dtype, device=device)
    return flat, [flat[o:o + B * h * w].view(B, h, w)
                  for o, B, h, w in hres_views]


def itx_run(mode: str, tab, work, desc, desc16, bitdepth: int, planes=(),
            hres_views=(), hres_dtype=torch.int32):
    """A work list of residual buckets, the plain version of the
    ``csrc/itx.cu`` kernel: one ``itx_bucket`` per table entry, on its
    real rows. tab: the run's int32 table (build_table); work: its
    (entries, work items); desc/desc16: the int32 and int16 buffers its
    offsets count from; planes: the destination planes of "add" and "raw"
    (entry plane i -> planes[i]), updated in place. Returns the hres
    views (a new flat output, the entries' residuals, pad rows zero) in
    hres mode, else None."""
    if mode not in MODES:
        raise ValueError(f"itx_run: mode {mode!r}")
    dev = desc.device
    flat, views = (hres_flat(hres_views, hres_dtype, dev) if mode == "hres"
                   else (None, None))

    def sl(e, f, narrow, n):
        src = desc16 if narrow else desc
        return src[e[f]:e[f] + n].to(torch.int32)
    for i, e in enumerate(table_entries(tab, work[0])):
        tx, fl, K, B, n = e[E_TX], e[E_FLAGS], e[E_K], e[E_B], e[E_NREAL]
        vals = sl(e, E_VALS, fl & F_VALS16, B * K).reshape(B, K)[:n]
        pos = None if fl & F_DENSE else \
            sl(e, E_POS, fl & F_POS16, B * K).reshape(B, K)[:n]
        if fl & F_WHT:
            sel = WHT_WHT
        elif fl & F_FIXED:
            sel = (torch.full((n,), e[E_RSEL], dtype=torch.int32,
                              device=dev),
                   torch.full((n,), e[E_CSEL], dtype=torch.int32,
                              device=dev))
        else:
            sel = (desc[e[E_RSEL]:e[E_RSEL] + n],
                   desc[e[E_CSEL]:e[E_CSEL] + n])
        if mode == "hres":
            views[i][:n] = itx_bucket("hres", vals, pos, sel, tx, bitdepth,
                                      out_dtype=hres_dtype)
            views[i][n:] = 0
        else:
            itx_bucket(mode, vals, pos, sel, tx, bitdepth,
                       planes[e[E_PLANE]], desc[e[E_YS]:e[E_YS] + n],
                       desc[e[E_XS]:e[E_XS] + n])
    return views
