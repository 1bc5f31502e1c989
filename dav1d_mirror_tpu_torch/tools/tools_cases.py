"""Synthetic cases of the inter tool kernels (``csrc/warp.cu``,
``csrc/comp.cu``, ``csrc/obmc.cu``) and their check on the card.

    python3 -m dav1d_mirror_tpu_torch.tools.tools_cases

The case functions (numpy, from a seed) serve ``chip_smoke.py``'s tools
phase and the CPU tests (``tests/test_torch_tools_kernels.py``,
``tests/test_torch_tools_runs.py`` and ``tests/test_torch_comp_run.py``,
which hold the plain versions to the JAX package on them). The kernels
run work lists (``warp_run``, ``comp_run``, ``obmc_run``): a warp or
OBMC case runs as a one-entry list, a comp case as a mixed list and as
a one-entry list of each of its records, and the mixed lists hold many
entries:

- warp: bit depths 8, 10 and 12, put into a plane (units on the 8x8 grid,
  some cut by the plane's edges, PAD_OOB pad rows) and put or prep into
  slots of a slot buffer (8x8 sub-rects, pad rows repeating the last
  unit); windows far outside the reference; phases whose table rows lie
  above the table, in [-193, -1] (counted from its end) and below -193;
  a bit depth's three cases as one mixed list (``warp_list``: a
  reference stack a plane, int16 and int32 destinations, the slot
  buffers at offsets of one arena);
- comp: bit depths 8, 10 and 12 in the 4:2:0, 4:2:2 and 4:4:4 layouts:
  two luma records and two chroma records of one frame as one work list
  (``comp_case``), every join kind (average, distance weights, wedge,
  seg luma, seg chroma from one luma record and from both), both mask
  signs, pad slots and padded join lists as the planner makes them,
  blocks cut by the plane's edges; the records' rows come from
  ``models/frame_exec.McRun.comp_table``, the list from
  ``ops/mc.comp_build_table``;
- obmc: top laps (rows blended; the blended rows may exceed the lap's
  rows) and left laps (columns), disjoint laps some cut by the plane's
  edges, PAD_OOB pad laps; a mixed list a bit depth (``obmc_run_case``:
  every lap shape on three planes, the laps of all entries disjoint).

Run as a module on a machine with a CUDA card, it holds every case's
kernel result to its plain version's (``torch.equal``) and prints the
count.
"""
from __future__ import annotations

import sys

import numpy as np

from ..ops.mc import PAD_OOB

BDS = (8, 10, 12)
LAYOUTS = ((1, 1), (1, 0), (0, 0))
# OBMC laps: (vert, lap_h, lap_w, region), as the planner makes them
# (_plan_obmc): top laps of 4x4 to 32x32 blocks in luma and chroma
# (region = the blended rows, 3/4 of them masked; the lap has
# (3 oh4 + 3) / 4 of oh4 rows), left laps (region = lap_w)
OBMC_SHAPES = ((False, 12, 16, 16), (False, 24, 32, 32), (False, 4, 8, 4),
               (False, 12, 8, 16), (False, 2, 4, 2), (True, 16, 8, 8),
               (True, 8, 16, 16), (True, 4, 2, 2), (True, 32, 16, 16))


def prep_values(rng, bd, shape):
    """Prep-domain intermediates: pixel << ib minus the 8192 bias above 8
    bit, with filter overshoot on both sides."""
    ib = 4 if bd == 8 else 14 - bd
    lo, hi = -(1 << (bd + ib - 3)), (1 << (bd + ib)) + (1 << (bd + ib - 3))
    bias = 0 if bd == 8 else 8192
    return (rng.integers(lo, hi, shape) - bias).astype(np.int32)


def grid_units(rng, n, uh, uw, H, W):
    """(ys, xs) of n disjoint (uh, uw) units on the unit grid of an (H, W)
    plane and the row and column past its edges (units cut by them)."""
    gy, gx = H // uh + 1, W // uw + 1
    cells = rng.permutation(gy * gx)[:n]
    return (cells // gx * uh).astype(np.int32), \
        (cells % gx * uw).astype(np.int32)


def pad_to(a, n, fill=None):
    """a (rows first) padded to n rows with `fill`, or with its last row."""
    extra = np.repeat(a[-1:], n - len(a), 0) if fill is None else \
        np.full((n - len(a),) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, extra]).astype(a.dtype)


def warp_rows(rng, n, refs_shape):
    """(n, 10) warp rows (ref, oy, ox, mx, my, alpha, beta, gamma, delta,
    0) as the planner makes them (_warp_rows), with window origins
    inside and far outside the reference; rows 1-3 with phases whose
    table rows lie above the table, in [-193, -1] and below -193."""
    r, h, w = refs_shape
    al, be, ga, de = (rng.integers(-24, 25, n) * 64 for _ in range(4))
    mx = (rng.integers(0, 1 << 16, n) - al * 4 - be * 7) & ~0x3F
    my = (rng.integers(0, 1 << 16, n) - ga * 4 - de * 4) & ~0x3F
    for k, ph in ((1, 140000), (2, -167936), (3, -307200)):
        mx[k], my[k] = ph, -ph // 2
        al[k] = be[k] = ga[k] = de[k] = 12000 * (k - 2)
    oy = rng.integers(-30, h + 20, n)
    ox = rng.integers(-30, w + 20, n)
    return np.stack([rng.integers(0, r, n), oy, ox, mx, my, al, be, ga, de,
                     np.zeros(n, np.int64)], 1).astype(np.int32)


def warp_cases(rng):
    """[(label, kw)]: kw = dict(refs, rows, bd, n_real (the rows before
    the pad rows), and either plane, ys, xs (a plane entry) or buf, base,
    prep (a slot entry))."""
    out = []
    for bd in BDS:
        refs = rng.integers(0, 1 << bd, (3, 40, 56)).astype(np.int32)
        # into a plane: 13 real units, 3 pad rows
        H, W = 48, 64
        rows = pad_to(warp_rows(rng, 13, refs.shape), 16)
        ys, xs = grid_units(rng, 13, 8, 8, H, W)
        out.append((f"warp plane bd{bd}", dict(
            refs=refs, rows=rows, bd=bd,
            plane=rng.integers(0, 1 << bd, (H, W)).astype(np.int32),
            ys=pad_to(ys, 16, PAD_OOB), xs=pad_to(xs, 16), n_real=13)))
        # into slots: (4, 16, 24) slot buffer, 8x8 sub-rects, pads
        # repeating the last unit
        for prep in (False, True):
            N, bhp, bwp = 4, 16, 24
            cells = rng.permutation(N * 6)[:11]
            base = (cells // 6 * bhp * bwp + cells % 6 // 3 * 8 * bwp +
                    cells % 3 * 8).astype(np.int32)
            out.append((f"warp slots bd{bd} {'prep' if prep else 'put'}",
                        dict(refs=refs, bd=bd, prep=prep,
                             rows=pad_to(warp_rows(rng, 11, refs.shape), 16),
                             buf=rng.integers(-99, 99, (N, bhp, bwp)).astype(
                                 np.int32), base=pad_to(base, 16),
                             n_real=11)))
    return out


class _Buffers:
    """The int32 and int16 descriptor buffers of a synthetic list."""

    def __init__(self):
        self.chunks = {np.int32: [], np.int16: []}
        self.off = {np.int32: 0, np.int16: 0}

    def emit(self, a, dtype=np.int32):
        a = np.asarray(a).reshape(-1)
        if dtype == np.int16:     # pad rows' PAD_OOB as the planner's OOB16
            a = np.where(a >= PAD_OOB, 0x7FFF, a)
        off = self.off[dtype]
        self.chunks[dtype].append(a.astype(dtype))
        self.off[dtype] += a.size
        return off

    def flat(self, dtype):
        c = self.chunks[dtype]
        return np.concatenate(c) if c else np.zeros(1, dtype)


def warp_list(kws, narrow=False):
    """The warp cases `kws` (warp_cases' dicts, of one bit depth and one
    reference stack) as one work list (ops/mc.warp_build_table): plane
    cases into planes 0, 1, ..., slot case i reading plane i % 3's
    reference stack, its buffer at its offset of one arena; with
    `narrow`, every other entry's destinations in the int16 buffer.
    Plane p reads refs[p]: the cases' own stack, the stack reversed, and
    its pictures turned by 180 degrees. Returns dict(tab, work, desc,
    desc16, planes, refs, arena, bd, at: [(plane index, arena offset or
    None)] a case)."""
    from ..ops import mc
    buf = _Buffers()
    r = kws[0]["refs"]
    refs = [r] + [np.ascontiguousarray(v) for v in
                  (r[::-1], np.rot90(r, 2, (1, 2)))]
    planes, arena, entries, at = [], [], [], []
    for i, kw in enumerate(kws):
        d16 = np.int16 if narrow and i % 2 == 0 else np.int32
        e = dict(rows=buf.emit(kw["rows"]), B=len(kw["rows"]),
                 n_real=kw["n_real"])
        if "plane" in kw:
            p = len(planes)
            planes.append(kw["plane"])
            e.update(plane=p, ys=buf.emit(kw["ys"], d16),
                     xs=buf.emit(kw["xs"], d16),
                     flags=(mc.WF_YS16 | mc.WF_XS16) * (d16 == np.int16))
            at.append((p, None))
        else:
            off = sum(a.size for a in arena)
            arena.append(kw["buf"].reshape(-1))
            e.update(plane=i % 3, ys=buf.emit(kw["base"], d16), dst=off,
                     dstn=kw["buf"].size, row_w=kw["buf"].shape[2],
                     flags=mc.WF_SLOT | mc.WF_PREP * bool(kw["prep"]) |
                     mc.WF_YS16 * (d16 == np.int16))
            at.append((i % 3, off))
        entries.append(e)
    while len(planes) < 3:        # a plane only slot entries name
        planes.append(np.zeros((8, 8), np.int32))
    tab, work = mc.warp_build_table(entries)
    return dict(tab=tab, work=work, desc=buf.flat(np.int32),
                desc16=buf.flat(np.int16), planes=planes, refs=refs,
                arena=np.concatenate(arena) if arena else
                np.zeros(1, np.int32), bd=kws[0]["bd"], at=at)


def _join_lists(kinds):
    """{kind: slot list padded to a power of two with its last slot}, as
    the planner pads a record's join lists."""
    by = {}
    for s, k in enumerate(kinds):
        by.setdefault(k, []).append(s)
    out = {}
    for k, sl in sorted(by.items()):
        p = 1
        while p < len(sl):
            p *= 2
        out[k] = np.asarray(sl + [sl[-1]] * (p - len(sl)), np.int32)
    return out


def comp_case(rng, bd, ssh, ssv, bw=16, bh=8, H=48, W=80):
    """One frame's compound records as one work list: two luma records
    (every luma join) and two chroma records (the second with seg slots
    of both luma records), all blocks disjoint. Returns dict(bd, ssh,
    ssv, desc (the frame's int32 buffer), planes ((H, W) luma, chroma),
    arena (every record's two side slot buffers), tab, work
    (ops/mc.comp_build_table's), records [dict(pl, bwp, bhp, N, joins
    (the JAX form, handles into desc), h_dy, h_dx, s0, s1 (its sides'
    arena offsets), tmp0, tmp1)])."""
    from ..models.frame_exec import FrameProgram, McRun
    from ..ops import mc
    Hc, Wc = H >> ssv, W >> ssh
    prog = FrameProgram(3, bd, [(H, W), (Hc, Wc), (Hc, Wc)])
    run = McRun(prog)
    recs, entries, arena = [], [], []
    blocks = []     # per luma record: {block slot: (kind, sign, weight)}

    def record(pl, bwp, bhp, ents, dsts, cmask):
        """ents [(kind, sign, weight)] of the real slots; one pad slot
        copying the last, PAD_OOB; joins as the planner emits them."""
        n = len(ents)
        N = 1
        while N < n + 1:
            N *= 2
        ents = ents + [ents[-1]] * (N - n)
        if pl and n - 1 in cmask:    # a pad slot names the last's mask
            cmask.update({s: cmask[n - 1] for s in range(n, N)})
        dy = np.full(N, PAD_OOB, np.int32)
        dx = np.zeros(N, np.int32)
        dy[:n], dx[:n] = dsts
        joins = []
        for kind, sl in _join_lists([e[0] for e in ents]).items():
            h_sl = prog.emit(sl)
            h_sgn = prog.emit(np.asarray([ents[s][1] for s in sl], np.int32))
            if kind == "wavg":
                joins.append(("wavg", h_sl, prog.emit(np.asarray(
                    [ents[s][2] for s in sl], np.int32))))
            elif kind == "wedge":
                m = rng.integers(0, 65, (N, bhp, bwp)).astype(np.int32)
                joins.append(("wedge", h_sl, h_sgn, prog.emit(m[sl])))
            elif pl == 0:
                cmid = prog.new_cm()
                joins.append(("segl", h_sl, h_sgn, cmid))
                for j, s in enumerate(sl):
                    cmask[s] = (cmid, j)
            else:
                refs = [cmask[s] for s in sl]
                spec = ("one", refs[0][0], prog.emit(np.asarray(
                    [r[1] for r in refs], np.int32))) if all(
                    r[0] == refs[0][0] for r in refs) else \
                    ("mix", tuple(refs))
                joins.append(("segc", h_sl, h_sgn, spec))
        h_dy, h_dx = prog.emit(dy), prog.emit(dx)
        tmp = [prep_values(rng, bd, (N, bhp, bwp)) for _ in (0, 1)]
        s0 = sum(a.size for a in arena)
        arena.extend(t.reshape(-1) for t in tmp)
        entries.append(dict(
            plane=pl, bhp=bhp, bwp=bwp, ch=ssh, cv=ssh & ssv, s0=s0,
            s1=s0 + tmp[0].size, dy=h_dy[0], dx=h_dx[0],
            rows=run.comp_table(bhp, bwp, joins, h_dy)))
        recs.append(dict(pl=pl, bwp=bwp, bhp=bhp, N=N, joins=tuple(joins),
                         h_dy=h_dy, h_dx=h_dx, s0=s0, s1=s0 + tmp[0].size,
                         tmp0=tmp[0], tmp1=tmp[1]))

    kinds = ("wavg", "seg", "wedge", "seg", "wavg", "seg", "wedge")
    ys, xs = grid_units(rng, 2 * len(kinds), bh, bw, H, W)
    luma_cm = []
    for r in range(2):
        ents = [(k, int(rng.integers(0, 2)), 8 if i % 2 else
                 int(rng.integers(1, 16)))
                for i, k in enumerate(kinds[r:] + kinds[:r])]
        sl = slice(r * len(kinds), (r + 1) * len(kinds))
        cm = {}
        record(0, bw, bh, [(("segl" if k == "seg" else k), s, w)
                           for k, s, w in ents], (ys[sl], xs[sl]), cm)
        luma_cm.append(cm)
        blocks.append([(k, s, w, y, x) for (k, s, w), y, x in
                       zip(ents, ys[sl], xs[sl])])
    # chroma: four blocks of luma record 0, then its other three and four
    # of record 1 (the blocks of a frame's records are disjoint: the
    # kernel joins every record in one launch)
    for c, pick in enumerate((blocks[0][:4], blocks[0][4:] + blocks[1][:4])):
        cm = {}
        ents, dst = [], []
        for i, (k, s, w, y, x) in enumerate(pick):
            src = 0 if c == 0 or i < 3 else 1
            slot = blocks[src].index((k, s, w, y, x))
            if k == "seg":
                cm[len(ents)] = luma_cm[src][slot]
            ents.append(("segc" if k == "seg" else k, s, w))
            dst.append((y >> ssv, x >> ssh))
        record(1, bw >> ssh, bh >> ssv, ents,
               tuple(np.asarray(d, np.int32) for d in zip(*dst)), cm)
    tab, work = mc.comp_build_table(entries)
    return dict(bd=bd, ssh=ssh, ssv=ssv, desc=prog.finalize()[1],
                planes=[rng.integers(0, 1 << bd, (H, W)).astype(np.int32),
                        rng.integers(0, 1 << bd, (Hc, Wc)).astype(np.int32)],
                arena=np.concatenate(arena), tab=tab, work=work,
                records=recs)


def comp_cases(rng):
    return [(f"comp bd{bd} ss({ssh},{ssv})", comp_case(rng, bd, ssh, ssv))
            for bd in BDS for ssh, ssv in LAYOUTS]


def obmc_cases(rng):
    """[(label, kw)]: kw = dict(plane, laps, ys, xs, region, vert): 6 real
    laps, disjoint as the planner's are, on the lap grid of a plane of
    odd sides (the grid's last row and column are cut by its edges; the
    bottom right lap is one of them), and 2 PAD_OOB pad laps."""
    out = []
    H, W = 71, 95
    for vert, lh, lw, region in OBMC_SHAPES:
        gy, gx = H // lh + 1, W // lw + 1
        cells = np.concatenate([[gy * gx - 1],
                                rng.permutation(gy * gx - 1)[:5]])
        ys = (cells // gx * lh).astype(np.int32)
        xs = (cells % gx * lw).astype(np.int32)
        out.append((f"obmc {'left' if vert else 'top'} {lw}x{lh} region "
                    f"{region}", dict(
                        plane=rng.integers(0, 4096, (H, W)).astype(np.int32),
                        laps=rng.integers(0, 4096, (8, lh, lw)).astype(
                            np.int32),
                        ys=pad_to(ys, 8, PAD_OOB), xs=pad_to(xs, 8),
                        region=region, vert=vert)))
    return out


def to_torch(v, dev):
    """numpy arrays (also inside dicts, lists and tuples) as new tensors
    on dev (copies: the wrappers write their destinations in place)."""
    import torch
    if isinstance(v, dict):
        return {k: to_torch(x, dev) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v)).to(dev)
    if isinstance(v, (list, tuple)):
        return type(v)(to_torch(x, dev) for x in v)
    return v


def one_entry_lists(tab, work, kind):
    """[(tab, work)] of a `kind` ("warp", "comp" or "obmc") work list (a
    tensor, or a numpy array): its entries, each as a one-entry list of
    its own on the table's device, in order (a comp entry with its
    rows)."""
    from ..ops import mc
    if kind == "comp":
        width = mc.CENTRY
        import torch
        ents, _ = mc.comp_table_parts(tab, work)
        cat = np.concatenate if isinstance(tab, np.ndarray) else torch.cat
        out, base = [], work[0] * width
        for i, e in enumerate(ents.tolist()):
            f, n = e[mc.C_FIRST], e[mc.C_NREAL]
            one = cat([tab[i * width:(i + 1) * width],
                       tab[base + f * mc.CROW:base + (f + n) * mc.CROW]])
            one[mc.C_FIRST] = one[mc.C_START] = 0
            out.append((one, (1, n, n * e[mc.C_BH] * e[mc.C_BW] //
                              mc.COMP_ITEM)))
        return out
    width, start = (mc.WENTRY, mc.W_START) if kind == "warp" else \
        (mc.OENTRY, mc.O_START)
    out = []
    for i, e in enumerate(mc.table_rows(tab, work[0], width)):
        one = tab[i * width:(i + 1) * width].clone()
        one[start] = 0
        out.append((one, (1, e[mc.W_NREAL] if kind == "warp" else
                          e[mc.O_NREAL] * e[mc.O_ROWS] * e[mc.O_COLS])))
    return out


def run_warp_list(mod, case, dev):
    """A warp list (warp_list's dict) through `mod`'s warp_run (ops/mc or
    ops/tools_cuda) on fresh tensors on dev; returns (planes, arena)."""
    a = to_torch(case, dev)
    mod.warp_run(a["tab"], case["work"], a["desc"], a["desc16"],
                 a["planes"], a["refs"], a["arena"], case["bd"])
    return a["planes"], a["arena"]


def run_warp(mod, kw, dev):
    """A warp case through `mod`'s warp_run as a one-entry list; returns
    its destination (the plane, or the slot buffer)."""
    planes, arena = run_warp_list(mod, warp_list([kw]), dev)
    if "plane" in kw:
        return planes[0]
    return arena[:kw["buf"].size].view(kw["buf"].shape)


def comp_slice(desc, h):
    """The view of handle h in the flat int32 buffer desc."""
    n = int(np.prod(h[1]))
    return desc[h[0]:h[0] + n].reshape(h[1])


def run_comp(mod, case, dev):
    """A comp case's list (or a one-entry list of it: `case` with its tab
    and work) through `mod`'s comp_run (ops/mc or ops/tools_cuda) on
    fresh tensors on dev; returns the (luma, chroma) planes."""
    a = to_torch({k: case[k] for k in ("tab", "desc", "planes", "arena")},
                 dev)
    mod.comp_run(a["tab"], case["work"], a["desc"], a["planes"], a["arena"],
                 case["bd"])
    return a["planes"]


def comp_record_tables(case):
    """The (n, mc.CJ_COLS) comp_record table of each record of a comp
    case, for a seg-mask arena where each seg luma slot writes its chroma
    mask (a span each, in row order) and each seg chroma slot reads its
    luma slot's; and that arena's ints."""
    from ..ops import mc
    ents, rows = mc.comp_table_parts(case["tab"], case["work"])
    moff = rows[:, mc.R_MOFF].copy()
    at = 0
    for e in ents:
        for g in range(e[mc.C_FIRST], e[mc.C_FIRST] + e[mc.C_NREAL]):
            if rows[g, mc.R_KIND] == mc.CJ_SEGL:
                moff[g] = at
                at += (e[mc.C_BH] >> e[mc.C_CV]) * (e[mc.C_BW] >> e[mc.C_CH])
    segc = rows[:, mc.R_KIND] == mc.CJ_SEGC
    moff[segc] = moff[rows[segc, mc.R_MOFF]]
    tab = np.stack([rows[:, mc.R_KIND], rows[:, mc.R_PAR], moff],
                   1).astype(np.int32)
    return [tab[e[mc.C_FIRST]:e[mc.C_FIRST] + e[mc.C_NREAL]]
            for e in ents], int(at)


def run_comp_records(case, dev):
    """A comp case's records through the plain per-record comp_record
    (ops/mc), in order, with the seg-mask arena of comp_record_tables;
    returns the (luma, chroma) planes."""
    import torch
    from ..ops import mc
    tabs, n_masks = comp_record_tables(case)
    desc = to_torch(case["desc"], dev)
    planes = to_torch(case["planes"], dev)
    masks = torch.zeros(n_masks, dtype=torch.int32, device=dev)
    for r, tab in zip(case["records"], tabs):
        mc.comp_record(planes[r["pl"]], to_torch(r["tmp0"], dev),
                       to_torch(r["tmp1"], dev), to_torch(tab, dev),
                       comp_slice(desc, r["h_dy"]),
                       comp_slice(desc, r["h_dx"]), masks, desc,
                       case["ssh"], case["ssv"], case["bd"])
    return planes


def obmc_list(kws):
    """OBMC cases (obmc_cases' dicts, each with `pl`, the index of its
    destination plane, or plane 0) as one work list
    (ops/mc.obmc_build_table), in order, their laps at offsets of one
    arena. Returns dict(tab, work, desc, arena)."""
    from ..ops import mc
    buf = _Buffers()
    arena, entries = [], []
    for kw in kws:
        nL, lh, lw = kw["laps"].shape
        entries.append(dict(
            plane=kw.get("pl", 0), laps=sum(a.size for a in arena), lh=lh,
            lw=lw, region=kw["region"], vert=int(kw["vert"]),
            ys=buf.emit(kw["ys"]), xs=buf.emit(kw["xs"]),
            n_real=int(np.sum(kw["ys"] != PAD_OOB))))
        arena.append(kw["laps"].reshape(-1))
    tab, work = mc.obmc_build_table(entries)
    return dict(tab=tab, work=work, desc=buf.flat(np.int32),
                arena=np.concatenate(arena))


def obmc_run_case(rng, bd):
    """One phase-free mixed OBMC list of bit depth bd: every OBMC_SHAPES
    shape on a luma plane of odd sides and the chroma shapes on two
    chroma planes, up to 4 real laps an entry on its shape's lap grid
    (the row and column past the plane's edges included), the laps of
    all entries disjoint, and PAD_OOB pad laps. Returns dict(planes,
    recs: obmc_cases-like dicts with `pl`, and obmc_list's fields)."""
    shapes = ((95, 127), (47, 63), (47, 63))
    planes = [rng.integers(0, 1 << bd, s).astype(np.int32) for s in shapes]
    recs = []
    for p, (H, W) in enumerate(shapes):
        taken = np.zeros((H + 64, W + 64), bool)
        for vert, lh, lw, region in OBMC_SHAPES:
            if p and lh > 16:
                continue
            gy, gx = H // lh + 1, W // lw + 1
            ys, xs = [], []
            for c in rng.permutation(gy * gx):
                y, x = c // gx * lh, c % gx * lw
                if len(ys) < 4 and not taken[y:y + lh, x:x + lw].any():
                    taken[y:y + lh, x:x + lw] = True
                    ys.append(y)
                    xs.append(x)
            nL = 8
            recs.append(dict(
                pl=p, region=region, vert=vert,
                laps=rng.integers(0, 1 << bd, (nL, lh, lw)).astype(np.int32),
                ys=pad_to(np.asarray(ys, np.int32), nL, PAD_OOB),
                xs=pad_to(np.asarray(xs, np.int32), nL)))
    return dict(planes=planes, recs=recs, **obmc_list(recs))


def run_obmc_list(mod, case, planes, dev):
    """An OBMC list (obmc_list's fields) through `mod`'s obmc_run on fresh
    tensors on dev, onto copies of `planes`; returns the planes."""
    a = to_torch(dict(case, planes=planes), dev)
    mod.obmc_run(a["tab"], case["work"], a["desc"], a["planes"],
                 a["arena"])
    return a["planes"]


def run_obmc(mod, kw, dev):
    """An obmc case through `mod`'s obmc_run as a one-entry list on fresh
    tensors on dev; returns the plane."""
    return run_obmc_list(mod, obmc_list([kw]), [kw["plane"]], dev)[0]


def check_all(torch, dev, seed=2027):
    """Every synthetic case through the kernel wrappers and the plain
    versions on `dev`: [(label, equal)] (the wrappers' launches counted
    as usual)."""
    from ..ops import mc, tools_cuda
    rng = np.random.default_rng(seed)
    res = []
    warps = warp_cases(rng)
    for label, kw in warps:
        res.append((label, torch.equal(run_warp(tools_cuda, kw, dev),
                                       run_warp(mc, kw, dev))))
    for bd in BDS:
        case = warp_list([kw for _, kw in warps if kw["bd"] == bd], True)
        got, want = (run_warp_list(m, case, dev) for m in (tools_cuda, mc))
        res.append((f"warp list bd{bd}", all(map(
            torch.equal, got[0] + [got[1]], want[0] + [want[1]]))))
    for label, case in comp_cases(rng):
        got, want = run_comp(tools_cuda, case, dev), run_comp(mc, case, dev)
        res.append((label, all(map(torch.equal, got, want))))
        for i, (tab, work) in enumerate(one_entry_lists(
                case["tab"], case["work"], "comp")):
            one = dict(case, tab=tab, work=work)
            got, want = (run_comp(m, one, dev) for m in (tools_cuda, mc))
            res.append((f"{label} entry {i}", all(map(torch.equal, got,
                                                      want))))
    for label, kw in obmc_cases(rng):
        res.append((label, torch.equal(run_obmc(tools_cuda, kw, dev),
                                       run_obmc(mc, kw, dev))))
    for bd in BDS:
        case = obmc_run_case(rng, bd)
        got, want = (run_obmc_list(m, case, case["planes"], dev)
                     for m in (tools_cuda, mc))
        res.append((f"obmc list bd{bd}", all(map(torch.equal, got, want))))
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("tools_cases: torch.cuda is not available", file=sys.stderr)
        return 1
    res = check_all(torch, torch.device("cuda"))
    torch.cuda.synchronize()
    bad = [lb for lb, ok in res if not ok]
    for lb in bad:
        print(f"UNEQUAL: {lb}")
    print(f"tools_cases: {len(res) - len(bad)} of {len(res)} cases "
          f"torch.equal with the plain versions on "
          f"{torch.cuda.get_device_name(0)}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
