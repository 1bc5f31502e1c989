"""The unit MC work lists on the CPU (dav1d_mirror_tpu_torch/models/
frame_exec.McRun, ops/mc.mc_build_table, the plain versions
ops/mc.mc_units_run / mc_scaled_run of csrc/mc_units.cu and
csrc/mc_scaled.cu, and their wrappers' CPU route in ops/mcu_cuda.py):

- the planner's tables on four small corpus streams (warp and OBMC,
  compound with OBMC, masked compound, super-res): one entry for every
  put and scaled record and every "t" and "s" sub-op, with its fields
  and real rows; items that cover every real unit of every tile once,
  the largest first; comp and obmc slot buffers disjoint inside the
  arena; no plane pixel written by two real units;
- mixed runs (bd 8/10/12, the four (has_h, has_v) cases, put and prep,
  int16 and int32 descriptors, plane and arena destinations, pad rows,
  units cut by the plane's edge, scaled steps 512..2048 on a strided
  reference view) equal to the per-bucket plain calls and to the JAX
  package's composition on the same numpy inputs: mc_tpu.mc_unit_batch
  with scatter_units / set_slots, mc_tpu.mc_scaled_batch with
  scatter_units / scatter_slot_units;
- the executor refuses unit MC records that no run covers, and the four
  streams decode to the JAX package's host-path md5.

Tolerance: exact."""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dav1d_mirror_tpu.api as japi
import dav1d_mirror_tpu.models.ref_decoder as jref
from dav1d_mirror_tpu.ops import mc_tpu as jmc
from dav1d_mirror_tpu.output import MD5Muxer as JMD5Muxer
from dav1d_mirror_tpu_torch import api as tapi
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf
from dav1d_mirror_tpu_torch.models import frame_exec as tfe
from dav1d_mirror_tpu_torch.ops import mc, mcu_cuda
from dav1d_mirror_tpu_torch.output import MD5Muxer
from dav1d_mirror_tpu_torch.tools import mcu_cases

STREAMS = Path(__file__).parent / "streams"
TABLE_STREAMS = ("inter_warp_obmc.ivf", "inter_compound_oh.ivf",
                 "inter_masked.ivf", "inter_superres.ivf")
# the mixed runs' unit sizes: chroma 2x2, non-square, whole blocks
RUN_UNITS = ((2, 2), (4, 8), (8, 4), (8, 8), (16, 8), (32, 32), (64, 16))
SCALED_UNITS = ((2, 2), (4, 8), (8, 8), (16, 16))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _decode(api, mux, settings, data):
    _, _, _, frames = parse_ivf(data)
    dec = api.Decoder(settings)
    m = mux()
    for fr in frames:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            m.write(pic)
    return m.digest(), m.n


@functools.lru_cache(maxsize=None)
def _programs(name):
    """The stream's frame programs that hold unit MC records, as the
    port's CPU decode runs them: [(sig, desc, desc16, desc8, refsrc)],
    numpy buffers."""
    seen = []
    orig = tfe.execute_program

    def spy(sig, desc, desc16, desc8, refsrc):
        if any(r[0] in tfe.MC_KINDS for r in sig[0]):
            seen.append((sig, desc.numpy().copy(), desc16.numpy().copy(),
                         desc8.numpy().copy(),
                         tuple(r.numpy().copy() for r in refsrc)))
        return orig(sig, desc, desc16, desc8, refsrc)

    tfe.execute_program = spy
    try:
        _decode(tapi, MD5Muxer, tapi.Settings(device="cpu"),
                (STREAMS / name).read_bytes())
    finally:
        tfe.execute_program = orig
    assert seen, name
    return seen


def _p2(n):
    p = 8
    while p < n:
        p <<= 1
    return p


def _arr(desc, desc16, h):
    """A record's descriptor array as stored (handle h)."""
    n = int(np.prod(h[1]))
    src = desc16 if len(h) == 3 else desc
    return src[h[0]:h[0] + n].reshape(h[1])


def _narrow(h):
    return int(len(h) == 3)


def _steps(rows):
    """M_STEPS of scaled rows: their largest dx | dy << 12."""
    return int(rows[:, 5].max()) | int(rows[:, 6].max()) << 12


def _expected_entries(sig, desc, desc16):
    """(unit entries, scaled entries, slot buffers) of a program, walked
    in record order as McRun gathers them: each entry the dict of fields
    the table must hold; n_real from the pad rows (a put's and scaled
    record's PAD_OOB / OOB16 rows after its real ones; a sub-op's rows
    repeating its last real row and slot or base), with B the power of
    two (at least 8) the planner pads to; slot buffers (size) in order."""
    units, scaled, bufs = [], [], []

    def n_lead(col, pad):
        real = np.nonzero(col != pad)[0]
        n = int(real[-1]) + 1 if len(real) else 0
        assert (col[n:] == pad).all() and (col[:n] != pad).all()
        return n

    def n_dup(rows, keys):
        B = len(keys)
        n = B
        while n > 1 and keys[n - 1] == keys[n - 2] and \
                (rows[n - 1] == rows[n - 2]).all():
            n -= 1
        return n

    def subs(pl, subops, N, bhp, bwp, prep):
        bufs.append(N * bhp * bwp)
        base_flags = mc.MF_ARENA | mc.MF_PREP * prep
        for s in subops:
            if s[0] == "t":
                _, hh, hv, h_arr, h_sl = s
                a, sl = _arr(desc, desc16, h_arr), _arr(desc, desc16, h_sl)
                units.append(dict(
                    uw=bwp, uh=bhp, ref=pl, plane=0, B=len(sl),
                    n_real=n_dup(a, sl), desc=h_arr[0], ys=h_sl[0], xs=0,
                    dstn=N * bhp * bwp, row_w=0, steps=0,
                    flags=base_flags | mc.MF_H * hh | mc.MF_V * hv |
                    mc.MF_DESC16 * _narrow(h_arr) |
                    mc.MF_YS16 * _narrow(h_sl)))
            elif s[0] == "s":
                _, sid, uw, uh, h_rows, h_base = s
                r, b = _arr(desc, desc16, h_rows), _arr(desc, desc16, h_base)
                n = n_dup(r, b)
                scaled.append(dict(
                    uw=uw, uh=uh, ref=sid, plane=0, B=len(b), n_real=n,
                    desc=h_rows[0], ys=h_base[0], xs=0, dstn=N * bhp * bwp,
                    row_w=bwp, flags=base_flags, steps=_steps(r[:n])))

    for rec in sig[0]:
        kind = rec[0]
        if kind == "put":
            _, pl, uw, uh, hh, hv, h_arr, h_ys, h_xs = rec
            ys = _arr(desc, desc16, h_ys)
            units.append(dict(
                uw=uw, uh=uh, ref=pl, plane=pl, B=len(ys),
                n_real=n_lead(ys, tfe.OOB16 if len(h_ys) == 3
                              else mc.PAD_OOB),
                desc=h_arr[0], ys=h_ys[0], xs=h_xs[0], dstn=0, row_w=0,
                steps=0, flags=mc.MF_H * hh | mc.MF_V * hv |
                mc.MF_DESC16 * _narrow(h_arr) | mc.MF_YS16 * _narrow(h_ys) |
                mc.MF_XS16 * _narrow(h_xs)))
        elif kind == "scaled":
            _, pl, sid, uw, uh, h_rows, h_ys, h_xs = rec
            ys = _arr(desc, desc16, h_ys)
            n = n_lead(ys, mc.PAD_OOB)
            scaled.append(dict(
                uw=uw, uh=uh, ref=sid, plane=pl, B=len(ys), n_real=n,
                desc=h_rows[0], ys=h_ys[0], xs=h_xs[0], dstn=0, row_w=0,
                flags=0, steps=_steps(_arr(desc, desc16, h_rows)[:n])))
        elif kind == "comp":
            _, pl, bwp, bhp, N, sides = rec[:6]
            for side in sides:
                subs(pl, side, N, bhp, bwp, True)
        elif kind == "obmc":
            _, pl, lh, lw, _, _, nL, subops = rec[:8]
            subs(pl, subops, nL, lh, lw, False)
    return units, scaled, bufs


def _items(tab, work):
    """The (entry, tile, first unit) of each item of a table."""
    it = np.asarray(tab)[work[0] * mc.MENTRY:].reshape(-1, 2)
    return [(int(a) >> 4, int(a) & 15, int(b)) for a, b in it]


def _runs(sig):
    return {r[0]: r for r in sig[0] if r[0] in tfe.MC_RUNS}


def _table(desc, rec):
    (off, shape), work = rec[1], rec[2]
    return desc[off:off + shape[0]], work


FIELDS = {"uw": mc.M_UW, "uh": mc.M_UH, "flags": mc.M_FLAGS, "ref": mc.M_REF,
          "plane": mc.M_PLANE, "B": mc.M_B, "n_real": mc.M_NREAL,
          "desc": mc.M_DESC, "ys": mc.M_YS, "xs": mc.M_XS, "dstn": mc.M_DSTN,
          "row_w": mc.M_ROWW, "steps": mc.M_STEPS}


def _geometry(scaled, en):
    """mc_geometry of a table entry (a list of MENTRY ints)."""
    return mc.mc_geometry(scaled, en[mc.M_UW], en[mc.M_UH],
                          en[mc.M_FLAGS] & mc.MF_H, en[mc.M_FLAGS] & mc.MF_V,
                          en[mc.M_STEPS])


@pytest.mark.parametrize("name", TABLE_STREAMS)
def test_planner_entries(name):
    """One entry for each put and scaled record and each "t" and "s"
    sub-op, in record order, with its fields; real rows before the pad
    rows, B their power of two; the run records before the first unit MC
    record."""
    n_checked = 0
    for sig, desc, desc16, _, _ in _programs(name):
        units, scaled, _ = _expected_entries(sig, desc, desc16)
        runs = _runs(sig)
        kinds = [r[0] for r in sig[0]]
        first = min(kinds.index(k) for k in tfe.MC_KINDS if k in kinds)
        assert all(kinds.index(k) < first for k in runs)
        for kind, want in (("mcurun", units), ("mcsrun", scaled)):
            if not want:
                assert kind not in runs
                continue
            tab, work = _table(desc, runs[kind])
            got = mc.mc_table_entries(tab, work[0])
            assert len(got) == len(want) == work[0]
            for g, w in zip(got, want):
                assert {k: g[f] for k, f in FIELDS.items()} == w
                assert 1 <= w["n_real"] and w["B"] == _p2(w["n_real"])
                assert g[mc.M_G] == _geometry(kind == "mcsrun", g)[1]
            n_checked += len(want)
    assert n_checked > 0


@pytest.mark.parametrize("name", TABLE_STREAMS)
def test_planner_items(name):
    """The items of each run cover every (entry, tile, real unit) once,
    the largest items first; the run's stage and mid sizes are its
    largest item's."""
    for sig, desc, _, _, _ in _programs(name):
        for kind, rec in _runs(sig).items():
            if kind == "mcarena":
                continue
            scaled = kind == "mcsrun"
            tab, work = _table(desc, rec)
            ents = mc.mc_table_entries(tab, work[0])
            seen = {}
            costs, stage, mid = [], 0, 0
            for e, tile, u0 in _items(tab, work):
                en = ents[e]
                tiles, G, win, m = _geometry(scaled, en)
                assert tile < tiles and u0 % G == 0
                gn = min(G, en[mc.M_NREAL] - u0)
                assert gn >= 1
                for u in range(u0, u0 + gn):
                    seen[(e, tile, u)] = seen.get((e, tile, u), 0) + 1
                passes = 1 + bool(en[mc.M_FLAGS] & mc.MF_H) + \
                    bool(en[mc.M_FLAGS] & mc.MF_V)
                costs.append(min(en[mc.M_UW], mc.MC_TILE) *
                             min(en[mc.M_UH], mc.MC_TILE) *
                             min(G, en[mc.M_NREAL]) * passes)
                stage, mid = max(stage, gn * win), max(mid, gn * m)
            want = {(e, t, u) for e, en in enumerate(ents)
                    for t in range(_geometry(scaled, en)[0])
                    for u in range(en[mc.M_NREAL])}
            assert set(seen) == want and set(seen.values()) == {1}
            assert costs == sorted(costs, reverse=True)
            assert work[1] == len(costs) and work[2:] == (stage, mid)


@pytest.mark.parametrize("name", TABLE_STREAMS)
def test_planner_arena(name):
    """Each comp side's and OBMC lap batch's slot buffer has its own
    span of the arena, in record order, inside it; the entries that
    write slots point at their batch's span."""
    n_bufs = 0
    for sig, desc, desc16, _, _ in _programs(name):
        _, _, bufs = _expected_entries(sig, desc, desc16)
        runs = _runs(sig)
        if not bufs:
            assert "mcarena" not in runs
            continue
        _, size, offsets = runs["mcarena"]
        offs = [o for t in offsets for o in t]
        assert len(offs) == len(bufs)
        spans = sorted(zip(offs, bufs))
        assert spans[0][0] >= 0 and spans[-1][0] + spans[-1][1] <= size
        assert all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))
        for kind in ("mcurun", "mcsrun"):
            if kind in runs:
                tab, work = _table(desc, runs[kind])
                for en in mc.mc_table_entries(tab, work[0]):
                    if en[mc.M_FLAGS] & mc.MF_ARENA:
                        assert (en[mc.M_DST], en[mc.M_DSTN]) in spans
        n_bufs += len(bufs)
    assert n_bufs > 0 or name == "inter_superres.ivf"


@pytest.mark.parametrize("name", TABLE_STREAMS)
def test_planner_plane_writes_are_disjoint(name):
    """The kernels write a run's units in any order: no plane pixel is
    written by two real units of a frame's put and scaled records."""
    n_px = 0
    for sig, desc, desc16, _, _ in _programs(name):
        covered = {}
        for rec in sig[0]:
            if rec[0] not in ("put", "scaled"):
                continue
            pl, (uw, uh) = rec[1], (rec[2], rec[3]) if rec[0] == "put" \
                else (rec[3], rec[4])
            ys = _arr(desc, desc16, rec[-2]).astype(np.int64)
            xs = _arr(desc, desc16, rec[-1]).astype(np.int64)
            real = ys < tfe.OOB16
            H, W = sig[3][pl]
            yy = ys[real, None, None] + np.arange(uh)[None, :, None]
            xx = xs[real, None, None] + np.arange(uw)[None, None, :]
            yy, xx = np.broadcast_arrays(yy, xx)
            ok = (yy < H) & (xx < W)
            covered.setdefault(pl, []).append((yy[ok] * W + xx[ok]))
        for pl, chunks in covered.items():
            lin = np.concatenate(chunks)
            assert len(np.unique(lin)) == len(lin), (name, pl)
            n_px += len(lin)
    assert n_px > 0


# ---------------------------------------------------------------------
# mixed runs: the plain run, the per-bucket plain calls and the JAX
# composition
# ---------------------------------------------------------------------
def _jax_units(case, bd):
    """The run's entries one by one through the JAX package: planes and
    a zero arena."""
    planes = [jnp.asarray(p) for p in case["planes"]]
    arena = np.zeros(case["arena"], np.int32)
    refs = [jnp.asarray(r) for r in case["refs"]]
    for c in case["calls"]:
        if c[0] == "plane":
            _, pl, arr, ys, xs, uw, uh, hh, hv, prep = c
        else:
            _, pl, off, N, arr, slots, uw, uh, hh, hv, prep = c
        a = arr.astype(np.int32)
        units = jmc.mc_unit_batch((refs[pl],) + tuple(
            jnp.asarray(a[:, i]) for i in range(6)), uw, uh, bool(hh),
            bool(hv), bd, prep)
        if c[0] == "plane":
            ys32 = ys.astype(np.int32)
            if ys.dtype == np.int16:
                ys32 = np.where(ys32 == tfe.OOB16, mc.PAD_OOB, ys32)
            planes[pl] = jmc.scatter_units(planes[pl], units,
                                           jnp.asarray(ys32),
                                           jnp.asarray(xs.astype(np.int32)),
                                           uh, uw)
        else:
            buf = jnp.asarray(arena[off:off + N * uh * uw].reshape(N, uh, uw))
            buf = jmc.set_slots(buf, jnp.asarray(slots.astype(np.int32)),
                                units)
            arena[off:off + N * uh * uw] = np.asarray(buf).reshape(-1)
    return [np.asarray(p) for p in planes], arena


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_units_run_matches_jax(bd):
    rng = np.random.default_rng(1200 + bd)
    case = mcu_cases.units_run_case(rng, bd, RUN_UNITS)
    want_planes, want_arena = _jax_units(case, bd)
    for fn in (mc.mc_units_run, mcu_cuda.mc_units_run):
        args = mcu_cases.run_case_args(case, torch.device("cpu"))
        n0 = mcu_cuda.UNITS_LAUNCHES
        fn(*args, bd)
        assert mcu_cuda.UNITS_LAUNCHES == n0   # the CPU route: no launch
        for g, w in zip(args[-3], want_planes):
            assert np.array_equal(g.numpy(), w)
        assert np.array_equal(args[-1].numpy(), want_arena)
    refs = args[-2]
    # the per-bucket plain calls on every row, pad rows included
    planes = [_t(p.copy()) for p in case["planes"]]
    arena = torch.zeros(case["arena"], dtype=torch.int32)
    for c in case["calls"]:
        if c[0] == "plane":
            _, pl, arr, ys, xs, uw, uh, hh, hv, prep = c
            mc.mc_units_plane(planes[pl], refs[pl], _t(arr), _t(ys), _t(xs),
                              uw, uh, bool(hh), bool(hv), bd, prep)
        else:
            _, pl, off, N, arr, slots, uw, uh, hh, hv, prep = c
            mc.mc_units_slots(arena[off:off + N * uh * uw].view(N, uh, uw),
                              refs[pl], _t(arr), _t(slots), bool(hh),
                              bool(hv), bd, prep)
    for g, w in zip(planes, want_planes):
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(arena.numpy(), want_arena)


def _jax_scaled(case, bd):
    planes = [jnp.asarray(p) for p in case["planes"]]
    arena = np.zeros(case["arena"], np.int32)
    srefs = [jnp.asarray(np.ascontiguousarray(r)) for r in case["srefs"]]
    for c in case["calls"]:
        if c[0] == "plane":
            _, pl, sid, rows, ys, xs, uw, uh, prep = c
        else:
            _, sid, off, (N, bhp, bwp), rows, base, uw, uh, prep = c
        units = jmc.mc_scaled_batch(srefs[sid], jnp.asarray(rows), uw, uh,
                                    2 * uw + 10, 2 * uh + 10, bd, prep)
        if c[0] == "plane":
            planes[pl] = jmc.scatter_units(planes[pl], units,
                                           jnp.asarray(ys), jnp.asarray(xs),
                                           uh, uw)
        else:
            n = N * bhp * bwp
            buf = jmc.scatter_slot_units(
                jnp.asarray(arena[off:off + n].reshape(N, bhp, bwp)),
                jnp.asarray(base), units, uh, uw, bwp)
            arena[off:off + n] = np.asarray(buf).reshape(-1)
    return [np.asarray(p) for p in planes], arena


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_scaled_run_matches_jax(bd):
    rng = np.random.default_rng(1300 + bd)
    case = mcu_cases.scaled_run_case(rng, bd, SCALED_UNITS)
    want_planes, want_arena = _jax_scaled(case, bd)
    for fn in (mc.mc_scaled_run, mcu_cuda.mc_scaled_run):
        args = mcu_cases.run_case_args(case, torch.device("cpu"))
        n0 = mcu_cuda.SCALED_LAUNCHES
        fn(*args, bd)
        assert mcu_cuda.SCALED_LAUNCHES == n0
        for g, w in zip(args[-3], want_planes):
            assert np.array_equal(g.numpy(), w)
        assert np.array_equal(args[-1].numpy(), want_arena)
    # the second view is a crop of a wider plane, read at its strides
    srefs = args[-2]
    assert not srefs[1].is_contiguous()
    planes = [_t(p.copy()) for p in case["planes"]]
    arena = torch.zeros(case["arena"], dtype=torch.int32)
    for c in case["calls"]:
        if c[0] == "plane":
            _, pl, sid, rows, ys, xs, uw, uh, prep = c
            mc.mc_scaled_plane(planes[pl], srefs[sid], _t(rows), _t(ys),
                               _t(xs), uw, uh, bd, prep)
        else:
            _, sid, off, shape, rows, base, uw, uh, prep = c
            mc.mc_scaled_slots(arena[off:off + int(np.prod(shape))].view(
                shape), srefs[sid], _t(rows), _t(base), uw, uh, bd, prep)
    for g, w in zip(planes, want_planes):
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(arena.numpy(), want_arena)


def test_run_wrappers_refuse_other_devices():
    m = torch.zeros(40, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        mcu_cuda.mc_units_run(m, (1, 12, 64, 0), m, m.to(torch.int16), [],
                              [], None, 8)
    with pytest.raises(ValueError):
        mcu_cuda.mc_scaled_run(m, (1, 12, 64, 64), m, [], [], None, 8)


# ---------------------------------------------------------------------
# the executor and whole decodes
# ---------------------------------------------------------------------
def _drop(ops, kind):
    return [r for r in ops if r[0] != kind]


def _late(ops, kind):
    """The run record `kind` moved after the first unit MC record."""
    rec = next(r for r in ops if r[0] == kind)
    ops = [r for r in ops if r is not rec]
    first = next(i for i, r in enumerate(ops) if r[0] in tfe.MC_KINDS)
    return ops[:first + 1] + [rec] + ops[first + 1:]


@pytest.mark.parametrize("how", ["no mcurun", "no mcsrun", "no mcarena",
                                 "late mcurun", "twice mcurun"])
def test_executor_refuses_uncovered_records(how):
    """A program whose put, scaled, "t" or "s" work no run covers, whose
    comp and obmc records lack their arena, or whose runs come after its
    first unit MC record (or twice) raises before any op runs."""
    kind = how.split()[1]
    sig, desc, desc16, desc8, refsrc = next(
        p for name in TABLE_STREAMS for p in _programs(name)
        if any(r[0] == kind for r in p[0][0]))
    ops = list(sig[0])
    bad = {"no": lambda: _drop(ops, kind), "late": lambda: _late(ops, kind),
           "twice": lambda: ops + [next(r for r in ops if r[0] == kind)]}[
        how.split()[0]]()
    args = tfe.frame_program_to_torch(desc, desc16, desc8, refsrc, "cpu")
    with pytest.raises(ValueError, match="mcurun|mcsrun|mcarena"):
        tfe.execute_program((tuple(bad),) + sig[1:], *args)
    tfe.execute_program(sig, *args)   # the program as planned runs


@pytest.mark.parametrize("name", TABLE_STREAMS)
def test_decode_md5_matches_jax_host_path(name):
    data = (STREAMS / name).read_bytes()
    # the JAX host path caches global-motion warp parameters by id(frame
    # header): a stale entry of a freed header could be handed on
    jref._GMV_WARP_CACHE.clear()
    want = _decode(japi, JMD5Muxer, japi.Settings(
        use_tpu_inter=False, use_tpu_filters=False), data)
    assert _decode(tapi, MD5Muxer, tapi.Settings(device="cpu"),
                   data) == want
