"""Seeded synthetic inputs of the unit MC kernels (``csrc/mc_units.cu``,
``csrc/mc_scaled.cu``) and their plain versions (``ops/mc.py``
``mc_units_plane`` / ``mc_units_slots`` / ``mc_scaled_plane`` /
``mc_scaled_slots``, and the work lists ``mc_units_run`` /
``mc_scaled_run``): descriptor rows, destination origins on a unit grid
and the planner's pad rows, as numpy arrays from a numpy ``Generator``,
and mixed work lists of many such buckets. ``tests/test_torch_mc_units.py``
and ``tests/test_torch_mc_worklist.py`` hold the plain versions to the
JAX package on them; ``chip_smoke.py`` holds the kernels to the plain
versions on them."""
from __future__ import annotations

import numpy as np

from ..ops.mc import PAD_OOB


def unit_rows(rng, n, refs_shape, uw, uh):
    """(n, 6) translational rows (ref, oy, ox, mx, my, f2d): every
    Filter2d in the first nine rows, subpel 1..15, window origins far
    above, left of, below and right of an (r, h, w) reference stack."""
    r, h, w = refs_shape
    f2d = rng.integers(0, 9, n)
    f2d[:min(n, 9)] = np.arange(min(n, 9))
    oy = rng.integers(-uh - 40, h + 30, n)
    ox = rng.integers(-uw - 40, w + 30, n)
    return np.stack([rng.integers(0, r, n), oy, ox, rng.integers(1, 16, n),
                     rng.integers(1, 16, n), f2d], 1).astype(np.int32)


def grid_origins(rng, n, uw, uh, H, W, pads=2):
    """(ys, xs) of n units: n - pads disjoint origins on the unit grid of
    an (H, W) plane plus the row and column past its edge (units cut by
    the edge), then `pads` pad rows (PAD_OOB) repeating the last real
    unit's column."""
    gy, gx = H // uh + 1, W // uw + 1
    cells = rng.permutation(gy * gx)[:n - pads]
    ys = np.concatenate([cells // gx * uh, [PAD_OOB] * pads])
    xs = np.concatenate([cells % gx * uw, [cells[-1] % gx * uw] * pads])
    return ys.astype(np.int32), xs.astype(np.int32)


def scaled_rows(rng, n, refs_shape, uw, uh):
    """(n, 9) scaled rows (ref, top, left, mxf, myf, dx, dy, f2d, pad):
    steps 512..2048, with whole subpel-0 units (dx = dy = 1024 from phase
    < 64), alternating copy columns (dx = 1536 from phase 0) and random
    ones; every Filter2d; windows far outside the reference."""
    r, h, w = refs_shape
    k = np.arange(n)
    dx = np.where(k % 4 == 0, 1024, np.where(
        k % 4 == 1, 1536, rng.integers(512, 2049, n)))
    dy = np.where(k % 4 == 0, 1024, np.where(
        k % 4 == 2, 2048, rng.integers(512, 2049, n)))
    mxf = np.where(k % 4 < 2, rng.integers(0, 64, n), rng.integers(0, 1024, n))
    myf = np.where(k % 4 == 0, rng.integers(0, 64, n),
                   rng.integers(0, 1024, n))
    f2d = rng.integers(0, 9, n)
    f2d[:min(n, 9)] = np.arange(min(n, 9))
    top = rng.integers(-2 * uh - 20, h + 20, n)
    left = rng.integers(-2 * uw - 20, w + 20, n)
    return np.stack([rng.integers(0, r, n), top, left, mxf, myf, dx, dy,
                     f2d, np.zeros(n, int)], 1).astype(np.int32)


def slot_bases(N, bwp, bhp, uw, uh):
    """Flat offsets of every (uw, uh) sub-rect of slots 0..N-2 of an
    (N, bhp, bwp) slot buffer (slot N-1 left for pad rows)."""
    return np.asarray([s * bhp * bwp + sy * bwp + sx for s in range(N - 1)
                       for sy in range(0, bhp, uh)
                       for sx in range(0, bwp, uw)], np.int32)


def pad_dup(a, k=2):
    """The planner's pad rows: k copies of the last row."""
    return np.concatenate([a, np.repeat(a[-1:], k, 0)])


# ---------------------------------------------------------------------
# mixed work lists of the run kernels (ops/mc.mc_build_table): many
# buckets of one launch, each a put or slot bucket as the planner makes
# them, with disjoint destinations (a band of plane rows, or a slot
# buffer of the arena, an entry), so that any order of the writes gives
# one result
# ---------------------------------------------------------------------
class Packer:
    """The int32 and int16 descriptor buffers of a synthetic run: each
    array's offset in its buffer."""

    def __init__(self):
        self.chunks = {32: [], 16: []}
        self.n = {32: 0, 16: 0}

    def put(self, a, bits=32):
        a = np.ascontiguousarray(a, np.int16 if bits == 16 else np.int32)
        off = self.n[bits]
        self.chunks[bits].append(a.reshape(-1))
        self.n[bits] += a.size
        return off

    def buffers(self):
        return tuple(np.concatenate(self.chunks[b] or [np.zeros(1, t)])
                     for b, t in ((32, np.int32), (16, np.int16)))


def _bands(rng, n, uw, uh, W, y0, pads, oob):
    """(ys, xs) of n units on the grid of a band of rows from y0 (its
    last row and column cut by the band's and plane's edge), `pads` pad
    rows at `oob`; and the band's height."""
    rows = max(4, -(-(n - pads) // (W // uw + 1)) + 1)
    H = (rows - 1) * uh + uh // 2
    ys, xs = grid_origins(rng, n, uw, uh, H, W, pads)
    ys[:n - pads] += y0
    ys[n - pads:] = oob
    return ys, xs, (H // uh + 1) * uh


def units_run_case(rng, bd, units, refs_shape=(2, 40, 60), W=70):
    """A mixed translational run: for each (uw, uh) of `units` and each
    (has_h, has_v), one entry, by turns a plane bucket with int16 rows
    and OOB16 pad rows, one with int32 rows and PAD_OOB pad rows, and a
    slot bucket (int32 or int16 slots, pad rows repeating the last unit
    and slot), put and prep by turns, on planes and reference stacks 0..2
    by turns; small units 40 a bucket, larger ones 6. Returns dict(refs
    (3 numpy stacks), planes (3 numpy planes of pixels), arena (ints),
    desc, desc16, table, work, calls): calls are the entries as the
    one-bucket calls that the table stands for, ("plane", pl, arr, ys,
    xs, uw, uh, has_h, has_v, prep) or ("slots", pl, offset, N, arr,
    slots, uw, uh, has_h, has_v, prep), numpy descriptors as stored."""
    from ..ops import mc
    from ..models.frame_exec import OOB16
    pk = Packer()
    refs = [rng.integers(0, 1 << bd, refs_shape).astype(np.int32)
            for _ in range(3)]
    band = [0, 0, 0]
    arena = 0
    entries, calls = [], []
    k = 0
    for uw, uh in units:
        for hh, hv in ((0, 0), (1, 0), (0, 1), (1, 1)):
            mode, pl, prep = k % 3, k // 3 % 3, bool(k // 9 % 2)
            n = 40 if uw * uh <= 64 else 6
            arr = pad_dup(unit_rows(rng, n, refs_shape, uw, uh), 3)
            flags = mc.MF_H * hh | mc.MF_V * hv | mc.MF_PREP * prep
            e = dict(uw=uw, uh=uh, ref=pl, plane=pl, B=n + 3, n_real=n)
            if mode < 2:
                narrow = mode == 0
                bits = 16 if narrow else 32
                ys, xs, h = _bands(rng, n + 3, uw, uh, W, band[pl], 3,
                                   OOB16 if narrow else mc.PAD_OOB)
                band[pl] += h
                flags |= (mc.MF_DESC16 | mc.MF_YS16 | mc.MF_XS16) * narrow
                e.update(desc=pk.put(arr, bits), ys=pk.put(ys, bits),
                         xs=pk.put(xs, bits))
                calls.append(("plane", pl, arr.astype(f"int{bits}"),
                              ys.astype(f"int{bits}"),
                              xs.astype(f"int{bits}"), uw, uh, hh, hv,
                              prep))
            else:
                N = n + 2
                slots = pad_dup(rng.permutation(N - 1)[:n].astype(
                    np.int32), 3)
                bits = 16 if k % 2 else 32
                flags |= mc.MF_ARENA | mc.MF_YS16 * (bits == 16)
                e.update(desc=pk.put(arr), ys=pk.put(slots, bits),
                         dst=arena, dstn=N * uh * uw)
                calls.append(("slots", pl, arena, N, arr, slots.astype(
                    f"int{bits}"), uw, uh, hh, hv, prep))
                arena += N * uh * uw
            e["flags"] = flags
            entries.append(e)
            k += 1
    # each plane one row short of its last band: that band's lowest units
    # are cut by the plane's edge
    planes = [rng.integers(0, 1 << bd, (max(h - 1, 1), W)).astype(np.int32)
              for h in band]
    table, work = mc.mc_build_table(False, entries)
    desc, desc16 = pk.buffers()
    return dict(refs=refs, planes=planes, arena=arena, desc=desc,
                desc16=desc16, table=table, work=work, calls=calls)


def scaled_run_case(rng, bd, units, W=75):
    """A mixed scaled run: for each (uw, uh) of `units`, put and prep,
    one plane bucket (PAD_OOB pad rows) and one flat-base bucket into a
    slot buffer of whole 8x8-aligned cells (pad rows repeating the last
    unit), on two reference views of other sizes by turns (the second a
    crop of a wider plane: `sref_full`, viewed [:, :h, :w]); small units
    40 a bucket, larger ones 6; steps 512..2048 (scaled_rows). Returns
    dict(srefs (numpy views), planes (3), arena, desc, table, work,
    calls): ("plane", pl, sid, rows, ys, xs, uw, uh, prep) or ("slots",
    sid, offset, (N, bhp, bwp), rows, base, uw, uh, prep)."""
    from ..ops import mc
    pk = Packer()
    full = rng.integers(0, 1 << bd, (1, 70, 110)).astype(np.int32)
    srefs = [rng.integers(0, 1 << bd, (1, 60, 90)).astype(np.int32),
             full[:, :66, :100]]
    band = [0, 0, 0]
    arena = 0
    entries, calls = [], []
    k = 0
    for uw, uh in units:
        for prep in (False, True):
            for slot in (False, True):
                sid, pl = k % 2, k % 3
                n = 40 if uw * uh <= 64 else 6
                rows = pad_dup(scaled_rows(rng, n, srefs[sid].shape, uw,
                                           uh), 3)
                rows[:, 0] = 0
                e = dict(uw=uw, uh=uh, ref=sid, plane=pl, B=n + 3,
                         n_real=n, desc=pk.put(rows),
                         steps=mc.mc_steps(rows[:n]),
                         flags=mc.MF_PREP * prep | mc.MF_ARENA * slot)
                if slot:
                    bwp, bhp = max(uw, 8), max(uh, 8)
                    N = n // ((bwp // uw) * (bhp // uh)) + 2
                    base = pad_dup(slot_bases(N, bwp, bhp, uw, uh)[:n], 3)
                    e.update(ys=pk.put(base), dst=arena,
                             dstn=N * bhp * bwp, row_w=bwp)
                    calls.append(("slots", sid, arena, (N, bhp, bwp), rows,
                                  base, uw, uh, prep))
                    arena += N * bhp * bwp
                else:
                    ys, xs, h = _bands(rng, n + 3, uw, uh, W, band[pl], 3,
                                       mc.PAD_OOB)
                    band[pl] += h
                    e.update(ys=pk.put(ys), xs=pk.put(xs))
                    calls.append(("plane", pl, sid, rows, ys, xs, uw, uh,
                                  prep))
                entries.append(e)
                k += 1
    planes = [rng.integers(0, 1 << bd, (max(h - 1, 1), W)).astype(np.int32)
              for h in band]
    table, work = mc.mc_build_table(True, entries)
    desc, _ = pk.buffers()
    return dict(srefs=srefs, planes=planes, arena=arena, desc=desc,
                table=table, work=work, calls=calls)


def run_case_args(case, dev):
    """(table, work, descriptor buffers..., planes, references, arena) of
    a units_run_case or scaled_run_case on device `dev`, in the order of
    ops/mc.mc_units_run / mc_scaled_run: fresh planes and a zero arena;
    the scaled case's second view a crop of a wider plane, read at its
    strides."""
    import torch

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    planes = [T(p) for p in case["planes"]]
    arena = torch.zeros(case["arena"], dtype=torch.int32, device=dev)
    if "refs" in case:
        return (T(case["table"]), case["work"], T(case["desc"]),
                T(case["desc16"]), planes, [T(r) for r in case["refs"]],
                arena)
    srefs = [T(r) if r.flags.c_contiguous else
             T(r.base)[:, :r.shape[1], :r.shape[2]] for r in case["srefs"]]
    return (T(case["table"]), case["work"], T(case["desc"]), planes, srefs,
            arena)
