"""Per-frame device program: a packed op list replayed eagerly in PyTorch.

Port of ``dav1d_mirror_tpu/models/frame_exec.py``. The host planner packs
every descriptor, coefficient and filter map of a frame into three flat
buffers (int32, int16, int8) plus a static op list (``FrameProgram``,
copied from the reference with its Pallas-only forms left out). The
executor uploads the three buffers ONCE per frame and replays the ops on
device tensors, slicing each op's inputs out of the uploaded buffers.

The executor implements the op kinds of the hybrid inter path and the
filter chain: ``hpx``, ``puthv_x``, ``put``, ``warp``, ``scaled`` (MC
from a reference of another size), ``comp`` (average, distance-weighted,
wedge and seg joins), ``obmc``, their work lists (``mcurun``,
``mcsrun``, ``warprun``, ``comprun``, ``obmcrun``), the residual buckets
(``residmc``, ``residc`` and ``hresc`` (lossless WHT), ``hresmc``) and
their work lists (``itxrun``), ``dbk`` and ``dbkrun``, ``snap``,
``cdef``, ``sres`` (super-resolution), ``lrw``, ``lrs`` and ``out``, and
the device intra engine's (models/intra): ``embed``,
``palset``, ``newres``, ``resrawmc`` and ``resrawc`` (residual planes),
``intrascan`` and ``crop``. Every other kind raises
``NotImplementedError`` saying why, before any op runs.

Ops update the planes in place, in the reference's op order: puts and
warps, compound blocks, OBMC laps (top, then left), then residuals. An op
that reads the plane it writes reads and writes only its own disjoint
units (a phase's OBMC laps, the residuals). The planner emits each run
of consecutive residual bucket records (the reference interpreter's
form, which the tests replay) and
after it one ``itxrun`` record: the run's work list (``ItxRun``,
ops/itx.build_table) in the int32 buffer. This executor runs the
``itxrun`` record, one launch of the itx kernel a run
(ops/itx_cuda.itx_run), and passes over the bucket records it covers.
The planner also gathers the frame's unit MC (``McRun``): every ``put``
and ``scaled`` record and every "t" and "s" sub-op of the compound and
OBMC side batches is an entry of one of two work lists, and every
compound side and OBMC lap batch has its slot buffer in one flat int32
arena. Before the frame's first MC record it emits ``mcarena`` (the
arena's size and each comp/obmc record's offsets), ``mcurun`` and
``mcsrun`` (the tables, in the int32 buffer). Unit MC reads only the
reference stacks, and its units write disjoint pixels or slots, so the
executor runs all of it there: one launch of each unit MC kernel a
frame (ops/mcu_cuda.mc_units_run, mc_scaled_run), which writes straight
into the planes or the arena and reads the descriptors in place (int16
or int32). It then passes over the ``put`` and ``scaled`` records. The
inter tools run as kernels too (ops/tools_cuda). The frame's ``warp``
records and every "w" sub-op of its side batches are the entries of one
work list, its ``warprun`` record (after the last warp record, before the
first comp record): one launch of the warp kernel a frame, into the
planes and the batches' arena slots (ops/tools_cuda.warp_run); the
executor passes over the warp records. The frame's ``comp`` records, of
every plane, are the entries of one work list, its ``comprun`` record (at
the first comp record): one launch of the join kernel a frame over their
real slots, stored straight into the planes (ops/tools_cuda.comp_run; a
seg chroma join derives its mask from its luma slot's sides in the
arena); the executor passes over the comp records. The ``obmc`` records of
each OBMC phase (top laps, then left laps), of every plane, are the
entries of one work list, an ``obmcrun`` record after the phase's last
obmc record: one launch of the blend kernel a phase, in place on the
planes (ops/tools_cuda.obmc_run); the executor passes over the obmc
records. The planner emits a
``dbk`` record for each deblocked plane (the reference
interpreter's form) and after them one ``dbkrun`` record with every
plane's maps: the executor passes over the ``dbk`` records and runs the
``dbkrun`` record, one launch of the deblock frame kernel
(ops/deblock_cuda.deblock_frame); the ``cdef`` record is one launch of
the CDEF frame kernel (ops/cdef_cuda.cdef_frame: the direction search
and the filter of the frame's planes).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import (cdef_cuda, deblock_cuda, itx, itx_cuda, mc, mc_cuda,
                   mcu_cuda, tools_cuda)
from ..ops.looprestoration import pad_stripes, sgr_batch, wiener_batch
from ..ops.itx_meta import WHT_WHT
from ..ops.mc import (HPAD_L, PAD_OOB, gather_units, mc_hv_combos,
                      resize_plane, scatter_units)
from . import intra


# int16 OOB sentinel for destination rows: PAD_OOB (1 << 20) marks
# dropped scatter rows but doesn't fit int16, so narrow emits carry
# OOB16 and the executor widens it back
OOB16 = 0x7FFF


def emit_ys16(prog, ys):
    v = np.asarray(ys, np.int64)
    assert v.max(initial=0) < 0x7FFF or \
        v[v >= 0x7FFF].min(initial=PAD_OOB) >= PAD_OOB, \
        "ys16 value collides with OOB16"
    return prog.emit16(np.where(v >= PAD_OOB, OOB16, v))


def _ys_oob(ys):
    return torch.where(ys == OOB16, PAD_OOB, ys)


def compact_cf(cf):
    """Sparsify a (B, sh, sw) coefficient batch to (vals (B, K),
    pos (B, K), K): inverse-transform inputs are mostly zeros (eob
    truncates the scan), so the descriptor carries only the nonzeros;
    the device rebuilds the dense block (ops/itx._expand_cf, or the itx
    kernel in its tile; pad lanes carry the out-of-range position S). K is
    the bucket's max nonzero count."""
    B = cf.shape[0]
    S = cf.shape[1] * cf.shape[2]
    flat = cf.reshape(B, S)
    r, c = np.nonzero(flat)
    counts = np.bincount(r, minlength=B)
    K = max(int(counts.max()) if B else 0, 1)
    starts = np.zeros(B + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    k_idx = np.arange(len(r)) - starts[r]
    vals = np.zeros((B, K), np.int32)
    pos = np.full((B, K), S, np.int32)   # S = out of range -> dropped
    vals[r, k_idx] = flat[r, c]
    pos[r, k_idx] = c
    return vals, pos, K


class FrameProgram:
    """Builder: accumulates op records + one flat int32 descriptor
    buffer (and int16/int8 side buffers). Everything static (shapes,
    size classes, offsets) lives in the op records; everything data
    lives in the buffers."""

    def __init__(self, n_planes, bitdepth, plane_shapes, refspec=(),
                 srefspec=(), plane_inputs=False, out_dtype=None):
        """refspec: per plane ((h_vis, w_vis), 7-tuple of refsrc index
        or -1 for an absent/mismatched slot); srefspec: per view of a
        scaled reference (refsrc index, h_vis, w_vis)."""
        self.n_planes = n_planes
        self.bd = bitdepth
        self.plane_shapes = tuple(tuple(s) for s in plane_shapes)
        self.refspec = tuple(refspec)
        self.srefspec = tuple(srefspec)
        self.ref_shapes = tuple(s for s, _ in self.refspec)
        self.plane_inputs = bool(plane_inputs)
        # plane pixel values fit the frame's native dtype; the "out" op
        # narrows the output planes (and the reference planes later
        # frames read) to it
        self.out_dtype = np.dtype(out_dtype).name if out_dtype else None
        self.ops = []
        self._chunks = []
        self._emitted = {}     # int32 offset -> the array emitted there
        self._off = 0
        self._chunks16 = []
        self._off16 = 0
        self._chunks8 = []
        self._off8 = 0
        self._hp_ids = {}      # (pl, combos-bytes) -> cache id
        self._n_cm = 0         # seg-mask registry counter

    # -- packing ----------------------------------------------------
    def emit(self, arr):
        a = np.ascontiguousarray(np.asarray(arr, dtype=np.int32))
        h = (self._off, a.shape)
        self._chunks.append(a.reshape(-1))
        self._emitted[self._off] = a
        self._off += a.size
        return h

    def array(self, h):
        """The int32 array emitted as handle h."""
        return self._emitted[h[0]]

    def emit16(self, arr):
        """Emit into the int16 side buffer. Callers must guarantee values
        fit int16 — coefficient payloads at 8 bpc, filter level/edge
        maps, small taps. The executor widens slices back to int32.
        NEVER use for arrays carrying the PAD_OOB sentinel (1<<20)."""
        a = np.asarray(arr)
        assert a.size == 0 or (a.min() >= -32768 and a.max() <= 32767), \
            "emit16 value out of int16 range"
        a = np.ascontiguousarray(a.astype(np.int16))
        h = (self._off16, a.shape, 16)
        self._chunks16.append(a.reshape(-1))
        self._off16 += a.size
        return h

    def emit8(self, arr):
        """Emit into the int8 side buffer — for small-range per-4x4
        filter maps (deblock levels <= 63, edge masks, luts, CDEF
        strengths). Same caveats as emit16."""
        a = np.asarray(arr)
        assert a.size == 0 or (a.min() >= -128 and a.max() <= 127), \
            "emit8 value out of int8 range"
        a = np.ascontiguousarray(a.astype(np.int8))
        h = (self._off8, a.shape, 8)
        self._chunks8.append(a.reshape(-1))
        self._off8 += a.size
        return h

    def op(self, *rec):
        self.ops.append(rec)

    def hplanes_id(self, pl, combos):
        """Cache id for an H-filtered plane stack; emits the build op on
        first use of this (plane, combos) content."""
        key = (pl, combos.tobytes())
        cid = self._hp_ids.get(key)
        if cid is None:
            cid = len(self._hp_ids)
            self._hp_ids[key] = cid
            self.op("hpx", pl, cid, self.emit(combos))
        return cid

    def new_cm(self):
        """Id of a new entry of the frame's seg-mask registry: a luma seg
        join registers its chroma masks there, the chroma joins read
        them."""
        self._n_cm += 1
        return self._n_cm - 1

    def finalize(self):
        desc = np.concatenate(self._chunks) if self._chunks else \
            np.zeros(1, np.int32)
        desc16 = np.concatenate(self._chunks16) if self._chunks16 else \
            np.zeros(1, np.int16)
        desc8 = np.concatenate(self._chunks8) if self._chunks8 else \
            np.zeros(1, np.int8)
        sig = (tuple(self.ops), self.n_planes, self.bd,
               self.plane_shapes, self.refspec, self.srefspec,
               self.plane_inputs, self.out_dtype)
        return sig, desc, desc16, desc8


# residual bucket record kinds -> the mode of the itx kernel that runs them
RESID_KINDS = {"residc": "add", "residmc": "add", "hresc": "hres",
               "hresmc": "hres", "resrawc": "raw", "resrawmc": "raw"}


def resid_entry(rec, n_real=None):
    """The work-list entry (ops/itx.build_table's dict) of one residual
    bucket record: its tx size, plane, coefficient handles (int16 or
    int32), selectors (or the fixed WHT), origins and real rows (n_real,
    default every row)."""
    kind = rec[0]
    pl, h_rs = 0, None
    h_ys = h_xs = (0, ())
    if kind in ("residc", "resrawc"):
        if kind == "residc":
            _, pl, _, _, tx, txtp, h_v, h_p, h_ys, h_xs = rec
        else:
            _, pl, tx, txtp, _, _, h_v, h_p, h_ys, h_xs = rec
    elif kind in ("residmc", "resrawmc"):
        _, pl, _, _, tx, h_v, h_p, h_rs, h_cs, h_ys, h_xs = rec
    elif kind == "hresc":
        _, tx, txtp, _, _, h_v, h_p = rec
    elif kind == "hresmc":
        _, tx, _, _, h_v, h_p, h_rs, h_cs = rec
    else:
        raise ValueError(f"not a residual record: {kind!r}")
    B, K = h_v[1]
    flags = (itx.F_VALS16 if len(h_v) == 3 else 0) | \
        (itx.F_POS16 if len(h_p) == 3 else 0)
    assert tuple(h_p[1]) == (B, K), (h_p, h_v)
    e = dict(tx=tx, plane=pl, K=K, B=B, n_real=B if n_real is None
             else n_real, vals=h_v[0], pos=h_p[0], ys=h_ys[0], xs=h_xs[0])
    if h_rs is None:
        if txtp != WHT_WHT:
            raise ValueError(f"{kind}: fixed type {txtp}, only WHT_WHT")
        e.update(rsel=0, csel=0)
        flags |= itx.F_WHT | itx.F_FIXED
    else:
        assert len(h_rs) == len(h_cs) == 2, "selectors ride the int32 buffer"
        e.update(rsel=h_rs[0], csel=h_cs[0])
    assert len(h_ys) == len(h_xs) == 2, "origins ride the int32 buffer"
    e["flags"] = flags
    return e


class ItxRun:
    """One run of consecutive residual bucket records of one mode:
    ``op`` emits each record (the reference interpreter's form) and keeps
    its work-list entry; leaving the ``with`` block emits the run's
    ``itxrun`` record, its table in the int32 buffer:
    ("itxrun", mode, table handle, (entries, items, items), hres views)."""

    def __init__(self, prog, mode):
        self.prog = prog
        self.mode = mode
        self.entries = []

    def op(self, *rec, n_real=None):
        assert RESID_KINDS[rec[0]] == self.mode, (rec[0], self.mode)
        self.prog.op(*rec)
        self.entries.append(resid_entry(rec, n_real))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.entries and exc[0] is None:
            table, work, views = itx.build_table(self.mode, self.entries)
            self.prog.op("itxrun", self.mode, self.prog.emit(table), work,
                         views)


def _narrow(h):
    """1 if the handle lies in the int16 side buffer (emit16)."""
    return int(len(h) == 3 and h[2] == 16)


class McRun:
    """The unit MC, warp, comp and OBMC work lists of one frame program, made
    where the planner starts the frame's MC records. ``op`` emits each
    record (the reference interpreter's form); of a ``put`` or ``scaled``
    record, and of each "t" or "s" sub-op of a ``comp`` or ``obmc``
    record, it keeps a work-list entry (ops/mc.mc_build_table's dict) on
    its first `n_real` rows (a comp: a tuple a side, one count a sub-op;
    an obmc: one count a sub-op; a warp: one count), of a ``warp`` record
    and each "w" sub-op a warp entry (ops/mc.warp_build_table's), of an
    ``obmc`` record an OBMC entry of its phase (ops/mc.obmc_build_table's,
    on its laps before the PAD_OOB pad laps), of a ``comp`` record a comp
    entry (ops/mc.comp_build_table's: the table of the record's real
    slots, comp_table, derived from its joins), and it gives each
    compound side and each OBMC lap batch its slot buffer in the frame's
    arena. After the last ``obmc`` record of each phase (0: top laps, 1:
    left laps) it emits ("obmcrun", phase, table handle, work).
    ``close`` inserts, where the MC records start, ("mcarena", arena
    ints, offsets) when the frame has comp or obmc records (offsets: a
    tuple each, in record order: a comp's two sides', an obmc's lap
    batch's), then ("mcurun", table handle, work) and ("mcsrun", table
    handle, work) for the lists with entries; ("warprun", table handle,
    work) after the frame's last ``warp`` record, before its first
    scaled, comp or obmc record, when it has warp work; and ("comprun",
    table handle, (entries, rows, work items)) right before its first comp
    record (after the warprun), when it has comp records. Every plane
    write keeps its order: the "w" units move before the comp records,
    into arena slots that only they write, and the joins move to the
    first comp record, where every side is written and before any record
    that reads or writes their pixels (only comp records lie between the
    first comp record and the last)."""

    def __init__(self, prog):
        self.prog = prog
        self.at = len(prog.ops)
        self.units, self.scaled = [], []
        self.arena = 0
        self.offsets = []
        self.comps = []      # comprun entries
        self.n_rows = 0      # their real slots (rows of the comp table)
        self.comp_at = None  # where the comprun goes: the first comp record
        self.seg = {}        # seg luma join id -> (its slots, {slot: row})
        self.warps = []      # warprun entries
        # where the warprun goes: set at the first scaled, comp or obmc
        # record, after the warp records
        self.warp_at = None
        self.obmcs = []      # obmcrun entries of the current phase
        self.phase = None    # the current OBMC phase (vert)

    def _slots(self, pl, subops, n_real, N, bhp, bwp, prep):
        """Entries of one slot batch's "t", "s" and "w" sub-ops; returns
        the batch's arena offset."""
        off, n = self.arena, N * bhp * bwp
        self.arena += n
        wflags = mc.WF_SLOT | mc.WF_PREP * bool(prep)
        prep = mc.MF_PREP * bool(prep) | mc.MF_ARENA
        for s, nr in zip(subops, n_real):
            if s[0] == "t":
                _, hh, hv, h_arr, h_sl = s
                self.units.append(dict(
                    uw=bwp, uh=bhp, ref=pl, B=h_arr[1][0], n_real=nr,
                    desc=h_arr[0], ys=h_sl[0], dst=off, dstn=n,
                    flags=prep | mc.MF_H * hh | mc.MF_V * hv |
                    mc.MF_DESC16 * _narrow(h_arr) |
                    mc.MF_YS16 * _narrow(h_sl)))
            elif s[0] == "s":
                _, sid, uw, uh, h_rows, h_base = s
                assert len(h_rows) == len(h_base) == 2, "scaled: int32 rows"
                self.scaled.append(dict(
                    uw=uw, uh=uh, ref=sid, B=h_rows[1][0], n_real=nr,
                    desc=h_rows[0], ys=h_base[0], dst=off, dstn=n,
                    row_w=bwp, flags=prep,
                    steps=mc.mc_steps(self.prog.array(h_rows)[:nr])))
            elif s[0] == "w":
                _, h_rows, h_base = s
                assert len(h_rows) == 2, "warp: int32 rows"
                self.warps.append(dict(
                    flags=wflags | mc.WF_YS16 * _narrow(h_base),
                    plane=pl, rows=h_rows[0], ys=h_base[0], dst=off, dstn=n,
                    row_w=bwp, B=h_rows[1][0], n_real=nr))
        return off

    def comp_table(self, bhp, bwp, joins, h_dy):
        """The (n, mc.CJ_COLS) int32 table of a comp record's real slots
        (those before its PAD_OOB pad slots; the JAX-form joins `joins`
        cover every slot): join kind, weight or sign, mask offset. Its
        rows become the frame's next n comp rows: a seg chroma slot's
        offset is the frame row of the luma slot its registry entry
        names, a wedge slot's the offset of its mask in the int32
        buffer."""
        arr = self.prog.array
        dy = arr(h_dy)
        n = int(np.sum(dy != PAD_OOB))
        if (dy[:n] == PAD_OOB).any():
            raise ValueError("comp: a real slot after a pad slot")
        tab = np.full((n, mc.CJ_COLS), -1, np.int32)
        for j in joins:
            sl, par = arr(j[1]), arr(j[2])     # weights or signs
            if j[0] == "wavg":
                kind, moff = mc.CJ_WAVG, np.zeros(len(sl), np.int64)
            elif j[0] == "segl":
                kind, moff = mc.CJ_SEGL, np.zeros(len(sl), np.int64)
                self.seg[j[3]] = (sl, {s: self.n_rows + s for s in
                                       sl.tolist() if s < n})
            elif j[0] == "segc":
                kind = mc.CJ_SEGC
                spec = j[3]
                refs = (zip([spec[1]] * len(sl), arr(spec[2]))
                        if spec[0] == "one" else spec[1])
                moff = np.asarray([self.seg[c][1][int(self.seg[c][0][jj])]
                                   for c, jj in refs], np.int64)
            elif j[0] == "wedge":
                kind = mc.CJ_WEDGE
                moff = j[3][0] + np.arange(len(sl)) * (bhp * bwp)
            for k in range(len(sl) - 1, -1, -1):   # first entry of a slot
                if sl[k] < n:
                    tab[sl[k]] = (kind, par[k], moff[k])
        if (tab[:, 0] < 0).any():
            raise ValueError("comp: a real slot that no join covers")
        self.n_rows += n
        return tab

    def _obmc_close(self):
        """Emit the current OBMC phase's obmcrun record."""
        if self.obmcs:
            table, work = mc.obmc_build_table(self.obmcs)
            self.prog.op("obmcrun", int(self.phase), self.prog.emit(table),
                         work)
        self.obmcs = []

    def op(self, *rec, n_real):
        kind = rec[0]
        if kind == "warp" and self.warp_at is not None:
            raise ValueError("McRun: a warp record after the frame's "
                             "scaled, comp or obmc records")
        if kind not in ("put", "warp") and self.warp_at is None:
            self.warp_at = len(self.prog.ops)
        if kind == "obmc" and self.phase is not None and \
                rec[5] != self.phase:
            self._obmc_close()
        if kind == "comp" and self.comp_at is None:
            self.comp_at = len(self.prog.ops)
        self.prog.op(*rec)
        if kind == "put":
            _, pl, uw, uh, hh, hv, h_arr, h_ys, h_xs = rec
            self.units.append(dict(
                uw=uw, uh=uh, ref=pl, plane=pl, B=h_arr[1][0],
                n_real=n_real, desc=h_arr[0], ys=h_ys[0], xs=h_xs[0],
                flags=mc.MF_H * hh | mc.MF_V * hv |
                mc.MF_DESC16 * _narrow(h_arr) | mc.MF_YS16 * _narrow(h_ys) |
                mc.MF_XS16 * _narrow(h_xs)))
        elif kind == "scaled":
            _, pl, sid, uw, uh, h_rows, h_ys, h_xs = rec
            assert len(h_rows) == len(h_ys) == len(h_xs) == 2, \
                "scaled: int32 descriptors"
            rows = self.prog.array(h_rows)[:n_real]
            self.scaled.append(dict(
                uw=uw, uh=uh, ref=sid, plane=pl, B=h_rows[1][0],
                n_real=n_real, desc=h_rows[0], ys=h_ys[0], xs=h_xs[0],
                flags=0, steps=mc.mc_steps(rows)))
        elif kind == "comp":
            _, pl, bwp, bhp, N, sides, joins, ssh, ssv, h_dy, h_dx = rec
            s0, s1 = (self._slots(pl, side, nr, N, bhp, bwp, True)
                      for side, nr in zip(sides, n_real))
            self.offsets.append((s0, s1))
            self.comps.append(dict(
                plane=pl, bhp=bhp, bwp=bwp, ch=int(bool(ssh)),
                cv=int(bool(ssh and ssv)), s0=s0, s1=s1, dy=h_dy[0],
                dx=h_dx[0], rows=self.comp_table(bhp, bwp, joins, h_dy)))
        elif kind == "warp":
            _, pl, h_rows, h_ys, h_xs = rec
            assert len(h_rows) == 2, "warp: int32 rows"
            self.warps.append(dict(
                flags=mc.WF_YS16 * _narrow(h_ys) | mc.WF_XS16 * _narrow(h_xs),
                plane=pl, rows=h_rows[0], ys=h_ys[0], xs=h_xs[0],
                B=h_rows[1][0], n_real=n_real))
        elif kind == "obmc":
            _, pl, lh, lw, region, vert, nL, subops, h_ys, h_xs = rec
            off = self._slots(pl, subops, n_real, nL, lh, lw, False)
            self.offsets.append((off,))
            assert len(h_ys) == len(h_xs) == 2, "obmc: int32 origins"
            ys = self.prog.array(h_ys)
            n = int(np.sum(ys != PAD_OOB))
            if (ys[:n] == PAD_OOB).any():
                raise ValueError("obmc: a real lap after a pad lap")
            self.obmcs.append(dict(plane=pl, laps=off, lh=lh, lw=lw,
                                   region=region, vert=int(bool(vert)),
                                   ys=h_ys[0], xs=h_xs[0], n_real=n))
            self.phase = vert
        else:
            raise ValueError(f"McRun: not an MC record: {kind!r}")

    def close(self):
        """Emit the last OBMC phase's obmcrun; insert the comprun at the
        first comp record, the warprun after the warps (before the
        comprun), and the arena and unit MC run records where the MC
        records start."""
        self._obmc_close()
        if self.comps:
            table, work = mc.comp_build_table(self.comps)
            self.prog.ops.insert(self.comp_at, ("comprun",
                                                self.prog.emit(table), work))
        if self.warps:
            at = len(self.prog.ops) if self.warp_at is None else self.warp_at
            table, work = mc.warp_build_table(self.warps)
            self.prog.ops.insert(at, ("warprun", self.prog.emit(table),
                                      work))
        recs = []
        if self.offsets:
            recs.append(("mcarena", self.arena, tuple(self.offsets)))
        for kind, entries, scaled in (("mcurun", self.units, False),
                                      ("mcsrun", self.scaled, True)):
            if entries:
                table, work = mc.mc_build_table(scaled, entries)
                recs.append((kind, self.prog.emit(table), work))
        self.prog.ops[self.at:self.at] = recs


def download_views(ts):
    """numpy copies of device tensors: one host copy for each base tensor
    that they view (an itxrun's flat hres output), sliced on the host."""
    flats = {}
    out = []
    for t in ts:
        base = t if t._base is None else t._base
        if id(base) not in flats:
            flats[id(base)] = base.cpu().numpy().reshape(-1)
        off = t.storage_offset() - base.storage_offset()
        out.append(flats[id(base)][off:off + t.numel()].reshape(t.shape))
    return out


def plane_to_torch(arr, device):
    """Upload one numpy plane in a dtype PyTorch computes with: uint8
    stays uint8; uint16 (10/12-bit) planes go up as int16, which holds
    every pixel value exactly."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.int16)
    return torch.from_numpy(arr).to(device)


def frame_program_to_torch(desc, desc16, desc8, refsrc, device):
    """Upload one frame's packed descriptors and its numpy reference (or
    input) planes. Returns (desc, desc16, desc8, refsrc) as tensors."""
    dev = torch.device(device)
    return (torch.from_numpy(np.ascontiguousarray(desc, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(desc16, np.int16)).to(dev),
            torch.from_numpy(np.ascontiguousarray(desc8, np.int8)).to(dev),
            tuple(p if isinstance(p, torch.Tensor)
                  else plane_to_torch(p, dev) for p in refsrc))


_OUT_DTYPES = {"uint8": torch.uint8, "uint16": torch.int16}

HANDLED = ("mcarena", "mcurun", "mcsrun", "hpx", "puthv_x", "put", "warp",
           "warprun", "scaled", "comprun", "comp", "obmc", "obmcrun",
           "residmc", "residc", "hresmc", "hresc", "itxrun", "dbk",
           "dbkrun", "snap", "cdef", "sres", "lrw", "lrs", "out", "embed",
           "palset", "newres", "resrawmc", "resrawc", "intrascan", "crop")

# op kinds of the reference that no planner of the port emits -> why
LATER = {
    "hpp": "Pallas-only form (the port's planner emits hpx)",
    "puthv_p": "Pallas-only form (the port's planner emits puthv_x)",
    "outpack": "TPU tunnel download form, not ported",
    "resid": "dense residual form (the port's planner emits residmc)",
    "residm": "dense residual form (the port's planner emits residmc)",
    "hres": "dense residual form (the port's planner emits hresmc)",
    "hresm": "dense residual form (the port's planner emits hresmc)",
    "setplane": "dense plane upload (the port's planner emits palset)",
    "resraw": "dense residual form (the port's planner emits resrawmc)",
    "resrawm": "dense residual form (the port's planner emits resrawmc)",
}


def _mc_needs(rec):
    """{run kind: entries} that a unit MC record needs: a put or scaled
    record one, a comp or obmc record one a "t" or "s" sub-op."""
    kind = rec[0]
    if kind in ("put", "scaled"):
        return {"mcurun" if kind == "put" else "mcsrun": 1}
    subs = rec[5][0] + rec[5][1] if kind == "comp" else rec[7]
    return {"mcurun": sum(s[0] == "t" for s in subs),
            "mcsrun": sum(s[0] == "s" for s in subs)}


MC_KINDS = ("put", "scaled", "comp", "obmc")
MC_RUNS = ("mcarena", "mcurun", "mcsrun")


def _check_tools(ops):
    """Raise ValueError unless the frame's warp records and "w" sub-ops
    are covered by one warprun record (after the frame's mcarena, where
    it has one, after its warp records and before its first comp record),
    its comp records by one comprun record (after the frame's mcarena and
    warprun, right before the first comp record, only comp records
    between it and the last), and each OBMC phase's obmc records by one
    obmcrun record after them (phase 1's records after phase 0's
    obmcrun)."""
    n_warp = 0        # warp records and "w" sub-ops
    warprun = None
    comp = False
    n_comp = 0        # comp records
    comprun = None
    comp_open = False   # after the comprun, only comp records so far
    n_obmc = [0, 0]   # obmc records a phase
    obmcrun = [None, None]
    for rec in ops:
        kind = rec[0]
        if kind in ("mcarena", "warprun") and comprun is not None:
            raise ValueError(f"comprun before the frame's {kind}")
        if kind == "comp":
            if not comp_open:
                raise ValueError("a comp record before the frame's "
                                 "comprun, or after another record that "
                                 "follows it")
        elif kind != "comprun":
            comp_open = False
        if kind == "mcarena" and warprun is not None:
            raise ValueError("warprun before the frame's mcarena")
        elif kind == "warprun":
            if warprun is not None or comp:
                raise ValueError("warprun twice, or after the frame's "
                                 "first comp record")
            warprun = rec
        elif kind == "warp":
            if warprun is not None:
                raise ValueError("a warp record after the frame's warprun")
            n_warp += 1
        elif kind == "comprun":
            if comprun is not None:
                raise ValueError("comprun twice")
            comprun, comp_open = rec, True
        elif kind == "comp":
            comp = True
            n_comp += 1
            n_warp += sum(s[0] == "w" for side in rec[5] for s in side)
        elif kind == "obmc":
            ph = int(bool(rec[5]))
            if obmcrun[ph] is not None:
                raise ValueError(f"an obmc record after its phase's "
                                 f"obmcrun (phase {ph})")
            if ph and n_obmc[0] and obmcrun[0] is None:
                raise ValueError("a phase-1 obmc record before phase 0's "
                                 "obmcrun")
            n_obmc[ph] += 1
        elif kind == "obmcrun":
            ph = rec[1]
            if obmcrun[ph] is not None or rec[3][0] != n_obmc[ph]:
                raise ValueError(f"obmcrun of {rec[3][0]} entries for "
                                 f"{n_obmc[ph]} obmc records of phase "
                                 f"{ph}, or twice")
            obmcrun[ph] = rec
    have = 0 if warprun is None else warprun[2][0]
    if have != n_warp:
        raise ValueError(f"warprun of {have} entries for {n_warp} warp "
                         f"records and \"w\" sub-ops")
    have = 0 if comprun is None else comprun[2][0]
    if have != n_comp:
        raise ValueError(f"comprun of {have} entries for {n_comp} comp "
                         f"records")
    for ph in (0, 1):
        if n_obmc[ph] and obmcrun[ph] is None:
            raise ValueError(f"{n_obmc[ph]} obmc records of phase {ph} "
                             f"without obmcrun")


def check_ops(ops):
    """Raise NotImplementedError for the first op this executor lacks, and
    ValueError unless each run of residual bucket records is followed
    directly by the itxrun record that covers it, unless the frame's
    put, scaled, "t" and "s" work is covered by the mcurun and mcsrun
    records and its comp and obmc records by the mcarena record, all
    three (those present) before the first of them, unless the frame's
    dbk records are followed by one dbkrun record with a plane's maps for
    each, and unless its warp, comp and OBMC work is covered by its
    warprun, comprun and obmcrun records (_check_tools)."""
    pending = 0
    need = {"mcurun": 0, "mcsrun": 0, "mcarena": 0}
    runs = {}
    n_dbk = None     # dbk records (None: the dbkrun seen, or none yet)
    for rec in ops:
        kind = rec[0]
        if kind not in HANDLED:
            where = LATER.get(kind, "unknown op kind")
            raise NotImplementedError(f"frame op {kind!r}: {where}")
        if kind == "dbk":
            if n_dbk is None and "dbkrun" in runs:
                raise ValueError("dbk record after the frame's dbkrun")
            n_dbk = (n_dbk or 0) + 1
        elif kind == "dbkrun":
            if "dbkrun" in runs or len(rec[1]) != (n_dbk or 0):
                raise ValueError(f"dbkrun of {len(rec[1])} planes after "
                                 f"{n_dbk or 0} dbk records, or twice")
            runs[kind], n_dbk = rec, None
        if kind in MC_RUNS:
            if kind in runs or any(need.values()):
                raise ValueError(f"{kind} after the frame's first unit MC "
                                 "record, or twice")
            runs[kind] = rec
        elif kind in MC_KINDS:
            for k, n in _mc_needs(rec).items():
                need[k] += n
            need["mcarena"] += kind in ("comp", "obmc")
        if kind in RESID_KINDS:
            pending += 1
        elif kind == "itxrun" and rec[3][0] != pending:
            raise ValueError(f"itxrun of {rec[3][0]} entries after "
                             f"{pending} residual records")
        elif kind != "itxrun" and pending:
            raise ValueError(f"{pending} residual records without itxrun")
        else:
            pending = 0
    if pending:
        raise ValueError(f"{pending} residual records without itxrun")
    if n_dbk:
        raise ValueError(f"{n_dbk} dbk records without dbkrun")
    for kind, n in need.items():
        rec = runs.get(kind)
        have = 0 if rec is None else len(rec[2]) if kind == "mcarena" \
            else rec[2][0]
        if have != n:
            raise ValueError(f"{kind} of {have} entries for {n} unit MC "
                             f"records or sub-ops")
    _check_tools(ops)


def execute_program(sig, desc, desc16, desc8, refsrc):
    """Replay a packed program on the device of `desc`. desc/desc16/desc8:
    the uploaded int32/int16/int8 buffers; refsrc: tuple of reference
    plane tensors (or, for plane-input programs, the input planes).
    Returns (planes tuple, hres tuple)."""
    (ops, n_planes, bd, plane_shapes, refspec, srefspec,
     plane_inputs, out_dtype) = sig
    check_ops(ops)
    dev = desc.device

    def narrow(h):
        """The descriptor slice as a view of its buffer, not widened."""
        off, shape = h[0], h[1]
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        src = desc if len(h) == 2 else desc16 if h[2] == 16 else desc8
        return src[off:off + n].reshape(shape)

    def get(h):
        """The descriptor slice as int32: from the int32 buffer, or
        widened from the narrow side buffers (emit16/emit8)."""
        t = narrow(h)
        return t if len(h) == 2 else t.to(torch.int32)

    refs = []
    for (hv, wv), slots in refspec:
        refs.append(torch.stack(
            [torch.zeros((hv, wv), dtype=torch.int32, device=dev) if i < 0
             else refsrc[i][:hv, :wv].to(torch.int32) for i in slots]))
    srefs = [refsrc[i][:h, :w][None].to(torch.int32)
             for i, h, w in srefspec]
    if plane_inputs:
        # a copy: the ops below update planes in place, and the inputs
        # are reference planes later frames still read
        planes = [p.to(torch.int32, copy=True) for p in refsrc]
    else:
        planes = [torch.zeros(s, dtype=torch.int32, device=dev)
                  for s in plane_shapes]
    hp = {}       # cache id -> H-plane stack
    snap = {}     # filter-chain plane snapshots (pre-CDEF, pre-LR)
    hres = []
    # residuals fit int16 at 8 bpc (dav1d's own coef type)
    hres_t = torch.int16 if bd == 8 else torch.int32
    arena = None      # the comp sides' and OBMC laps' slot buffers

    for rec in ops:
        kind = rec[0]
        if kind == "mcarena":
            arena = torch.zeros(rec[1], dtype=torch.int32, device=dev)
        elif kind == "mcurun":
            _, h_tab, work = rec
            mcu_cuda.mc_units_run(get(h_tab), work, desc, desc16, planes,
                                  refs, arena, bd)
        elif kind == "mcsrun":
            _, h_tab, work = rec
            mcu_cuda.mc_scaled_run(get(h_tab), work, desc, planes, srefs,
                                   arena, bd)
        elif kind in ("put", "scaled"):
            pass    # run by the mcurun / mcsrun record before them
        elif kind == "hpx":
            _, pl, cid, h_combos = rec
            hp[cid] = mc_cuda.mc_hplanes(refs[pl], get(h_combos), bd)
        elif kind == "puthv_x":
            (_, pl, uw, uh, cid, h_slot, h_oy, h_ox, h_my, h_tv,
             h_ys, h_xs) = rec
            out = mc_cuda.mc_unit_batch_hv(
                (hp[cid], get(h_slot), get(h_oy), get(h_ox), get(h_my),
                 get(h_tv)), uw, uh, bd, False)
            scatter_units(planes[pl], out, _ys_oob(get(h_ys)), get(h_xs),
                          uh, uw)
        elif kind == "warprun":
            # the frame's warp records and "w" sub-ops, into the planes
            # and the arena slots of the compound sides
            _, h_tab, work = rec
            tools_cuda.warp_run(get(h_tab), work, desc, desc16, planes, refs,
                                arena, bd)
        elif kind == "warp":
            pass    # run by the frame's warprun record
        elif kind == "comprun":
            # the frame's joins over the comp sides' arena slots (mcurun,
            # mcsrun and warprun wrote them), stored into the planes
            _, h_tab, work = rec
            tools_cuda.comp_run(get(h_tab), work, desc, planes, arena, bd)
        elif kind in ("comp", "obmc"):
            pass    # run by the comprun / its phase's obmcrun record
        elif kind == "obmcrun":
            # a phase's laps of every plane, blended in place
            _, _, h_tab, work = rec
            tools_cuda.obmc_run(get(h_tab), work, desc, planes, arena)
        elif kind in RESID_KINDS:
            pass    # run by the itxrun record that follows its run
        elif kind == "itxrun":
            _, mode, h_tab, work, views = rec
            if mode == "hres":
                hres.extend(itx_cuda.itx_run(
                    mode, get(h_tab), work, desc, desc16, bd,
                    hres_views=views, hres_dtype=hres_t))
            else:
                itx_cuda.itx_run(mode, get(h_tab), work, desc, desc16, bd,
                                 planes if mode == "add" else snap["res"])
        elif kind == "dbk":
            pass    # run by the frame's dbkrun record after them
        elif kind == "dbkrun":
            # every plane's maps as int8 views of the side buffer (the
            # kernel reads them so, and derives the neighbour levels)
            _, maps, h_el, h_il = rec
            n = len(maps)
            views = {h: narrow(h) for m in maps for h in m}  # chroma share
            ev, eh, lv, lh = ([views[m[k]] for m in maps] for k in range(4))
            planes[:n] = deblock_cuda.deblock_frame(
                tuple(planes[:n]), ev, eh, lv, lh, get(h_el), get(h_il), bd)
        elif kind == "snap":
            # copies: the LR ops below scatter into the planes in place,
            # and a later bucket's windows read the snapshot
            snap[rec[1]] = [p.clone() for p in planes]
        elif kind == "lrw":
            (_, pl, snapid, w, h, h_xs, h_ysin, h_ysout, h_eg, h_fh,
             h_fv) = rec
            xs = get(h_xs)
            padded = pad_stripes(snap[("prelr", pl)][pl], snap[snapid][pl],
                                 xs, get(h_ysin), get(h_eg), w, h)
            res = wiener_batch(padded, get(h_fh), get(h_fv), w, h, bd)
            scatter_units(planes[pl], res, get(h_ysout), xs, h, w)
        elif kind == "lrs":
            (_, pl, snapid, skind, w, h, h_xs, h_ysin, h_ysout, h_eg,
             h_s0, h_s1, h_w0, h_w1) = rec
            xs, ysin = get(h_xs), get(h_ysin)
            padded = pad_stripes(snap[("prelr", pl)][pl], snap[snapid][pl],
                                 xs, ysin, get(h_eg), w, h)
            cur = gather_units(planes[pl], ysin, xs, h, w)
            res = sgr_batch(padded, cur, get(h_s0), get(h_s1), get(h_w0),
                            get(h_w1), w, h, bd, skind)
            scatter_units(planes[pl], res, get(h_ysout), xs, h, w)
        elif kind == "cdef":
            (_, h_idx, h_ns, h_ystr, h_uvstr, damping, ssh, ssv,
             mono) = rec
            planes = list(cdef_cuda.cdef_frame(
                tuple(planes), get(h_idx), get(h_ns) != 0, get(h_ystr),
                get(h_uvstr), damping=damping, bitdepth=bd, ss_hor=ssh,
                ss_ver=ssv, monochrome=mono))
        elif kind == "sres":
            # a new plane of the upscaled shape: nothing aliases the
            # coded-width one it reads
            _, tgt, pl, out_w, src_w, step, mx0, h_vis, oshape = rec
            src = planes[pl] if tgt is None else snap[tgt][pl]
            new = torch.zeros(oshape, dtype=torch.int32, device=dev)
            new[:h_vis, :out_w] = resize_plane(src[:h_vis], out_w, src_w,
                                               step, mx0, bd)
            if tgt is None:
                planes[pl] = new
            else:
                snap[tgt][pl] = new
        # ---- the device intra engine (models/intra) ----
        elif kind == "embed":
            # a NEW plane in the engine's padded layout (PADT top/left
            # margin, the luma-padded shape for every plane)
            _, pl, Hp, Wp, ph, pw, padt = rec
            new = torch.zeros((Hp, Wp), dtype=torch.int32, device=dev)
            new[padt:padt + ph, padt:padt + pw] = planes[pl][:ph, :pw]
            planes[pl] = new
        elif kind == "palset":
            # palette pixels placed as 4x4 tiles before the scan
            _, pl, h_vals, h_ys, h_xs = rec
            scatter_units(planes[pl], get(h_vals), get(h_ys), get(h_xs), 4,
                          4)
        elif kind == "newres":
            snap["res"] = [torch.zeros_like(p) for p in planes]
        elif kind == "intrascan":
            _, h_mrows, moffs, mfams, h_frows, foffs, ssh, ssv, npl = rec
            out = intra.intra_scan(
                torch.stack(planes[:npl]), torch.stack(snap["res"][:npl]),
                get(h_mrows), moffs, get(h_frows), foffs, bd, ssh, ssv,
                mfams)
            planes[:npl] = list(out.unbind(0))
        elif kind == "crop":
            # a NEW plane of the frame's shape from the padded layout
            _, pl, oy, ox, ph, pw, fh, fw = rec
            H, W = planes[pl].shape
            oy, ox = min(max(oy, 0), H - ph), min(max(ox, 0), W - pw)
            new = torch.zeros((fh, fw), dtype=torch.int32, device=dev)
            new[:ph, :pw] = planes[pl][oy:oy + ph, ox:ox + pw]
            planes[pl] = new
        else:  # "out"
            planes = [p.to(_OUT_DTYPES[out_dtype]) for p in planes]
    return tuple(planes), tuple(hres)


def run_frame_program(prog: FrameProgram, refsrc, device):
    """Finalize, upload once, and execute a packed program on `device`.
    refsrc: reference plane tensors (or numpy planes to upload)."""
    sig, desc, desc16, desc8 = prog.finalize()
    desc, desc16, desc8, refsrc = frame_program_to_torch(
        desc, desc16, desc8, refsrc, device)
    return execute_program(sig, desc, desc16, desc8, refsrc)


# ---------------------------------------------------------------------
# pack helper shared with the planner (models/inter)
# ---------------------------------------------------------------------
def pack_put_case(prog: FrameProgram, pl, key, arr, run: McRun = None):
    """One translational-put bucket. arr: pow2-padded (B, 8) rows
    (ref, oy, ox, mx, my, f2d, dst_y, dst_x) with PAD_OOB dst_y pads
    after its real rows. All columns ride the int16 side (coords < 8K,
    the dst_y OOB sentinel narrowed to OOB16). A ``put`` record goes
    through `run` (the frame's McRun), when given."""
    uw, uh, has_h, has_v = key
    h_ys = emit_ys16(prog, arr[:, 6])
    h_xs = prog.emit16(arr[:, 7])
    if has_h and has_v:
        W = prog.ref_shapes[pl][1]
        combos, slot, tv = mc_hv_combos(arr[:, :6], uw)
        cid = prog.hplanes_id(pl, combos)
        ox = np.clip(arr[:, 2], -HPAD_L, W - 1).astype(np.int32)
        prog.op("puthv_x", pl, uw, uh, cid, prog.emit16(slot),
                prog.emit16(arr[:, 1]), prog.emit16(ox),
                prog.emit16(arr[:, 4]), prog.emit16(tv), h_ys, h_xs)
    else:
        rec = ("put", pl, uw, uh, bool(has_h), bool(has_v),
               prog.emit16(arr[:, :6]), h_ys, h_xs)
        if run is None:
            prog.op(*rec)
        else:
            run.op(*rec, n_real=int(np.sum(arr[:, 6] != PAD_OOB)))
