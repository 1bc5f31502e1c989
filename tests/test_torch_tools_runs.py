"""The warp and OBMC work lists on the CPU (dav1d_mirror_tpu_torch/ops/
mc.py warp_run and obmc_run, the plain versions of csrc/warp.cu and
csrc/obmc.cu; the planner's warprun and obmcrun records, models/
frame_exec.McRun; the executor's runs and check_ops):

- mixed multi-entry lists (tools/tools_cases.warp_list: plane and slot
  entries on three reference stacks, put and prep, int16 and int32
  destinations, pad rows; obmc_run_case: every lap shape on three
  planes, pad laps, laps cut by the planes' edges) through the plain run
  versions, equal to the per-record plain versions (warp_plane,
  warp_slots, obmc_plane on the whole padded records) and to the JAX
  package's warp8x8_batch with scatter_units or scatter_slot_units and
  obmc_blend_batch, at bit depths 8, 10 and 12;
- on the programs of a miniature tools stream: the executor equals the
  JAX interpreter with one warp_run call a frame and two obmc_run calls
  (no per-record call), the tables hold each record's real rows and laps
  only and sit where the records allow, and the laps of one OBMC phase
  are disjoint across records and planes;
- check_ops refuses warp and OBMC work that no run covers, and runs out
  of place.

Tolerance: exact."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))

import torch_tools_programs as ttp  # noqa: E402
from dav1d_mirror_tpu.models import frame_exec as jfe  # noqa: E402
from dav1d_mirror_tpu.ops import mc_tpu as jmc  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
from dav1d_mirror_tpu_torch.ops import mc, tools_cuda  # noqa: E402
from dav1d_mirror_tpu_torch.tools import tools_cases as tc  # noqa: E402

CPU = torch.device("cpu")
BDS = (8, 10, 12)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bd", BDS)
def test_warp_run_matches_per_record_and_jax(bd):
    """A bit depth's three warp cases as one list: the run equals the
    per-record plain calls and the JAX composition; only real rows are
    units of the list."""
    kws = [kw for _, kw in tc.warp_cases(np.random.default_rng(bd))
           if kw["bd"] == bd]
    case = tc.warp_list(kws, narrow=True)
    flags = mc.table_rows(case["tab"], case["work"][0], mc.WENTRY)
    assert {f[mc.W_FLAGS] & mc.WF_SLOT for f in flags} == {0, mc.WF_SLOT}
    assert any(f[mc.W_FLAGS] & mc.WF_YS16 for f in flags)
    assert any(not f[mc.W_FLAGS] & mc.WF_YS16 for f in flags)
    assert sorted({f[mc.W_PLANE] for f in flags}) == [0, 1, 2]
    assert case["work"] == (3, sum(kw["n_real"] for kw in kws))
    assert case["work"][1] < sum(len(kw["rows"]) for kw in kws)
    planes, arena = tc.run_warp_list(mc, case, CPU)
    per_planes = [_t(p) for p in case["planes"]]
    per_arena = _t(case["arena"])
    j_planes = [jnp.asarray(p) for p in case["planes"]]
    j_arena = jnp.asarray(case["arena"])
    for kw, (p, off) in zip(kws, case["at"]):
        refs = case["refs"][p]
        out = jmc.warp8x8_batch(jnp.asarray(refs), jnp.asarray(kw["rows"]),
                                bd, kw.get("prep", False))
        if off is None:
            mc.warp_plane(per_planes[p], _t(refs), _t(kw["rows"]),
                          _t(kw["ys"]), _t(kw["xs"]), bd)
            j_planes[p] = jmc.scatter_units(j_planes[p], out,
                                            jnp.asarray(kw["ys"]),
                                            jnp.asarray(kw["xs"]), 8, 8)
        else:
            n = kw["buf"].size
            mc.warp_slots(per_arena[off:off + n].view(kw["buf"].shape),
                          _t(refs), _t(kw["rows"]), _t(kw["base"]), bd,
                          kw["prep"])
            buf = jmc.scatter_slot_units(
                j_arena[off:off + n].reshape(kw["buf"].shape),
                jnp.asarray(kw["base"]), out, 8, 8, kw["buf"].shape[2])
            j_arena = j_arena.at[off:off + n].set(buf.reshape(-1))
    for got, per, want in zip(planes + [arena], per_planes + [per_arena],
                              j_planes + [j_arena]):
        assert torch.equal(got, per)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(planes[0].numpy(), case["planes"][0])
    assert not np.array_equal(arena.numpy(), case["arena"])


@pytest.mark.parametrize("bd", BDS)
def test_obmc_run_matches_per_record_and_jax(bd):
    """A mixed OBMC list on three planes: the run equals the per-record
    plain calls and obmc_blend_batch, in order; its laps are disjoint,
    some are cut by the planes' edges, and only the real laps' blended
    pixels are work of the list."""
    case = tc.obmc_run_case(np.random.default_rng(100 + bd), bd)
    got = tc.run_obmc_list(mc, case, case["planes"], CPU)
    per = [_t(p) for p in case["planes"]]
    want = [jnp.asarray(p) for p in case["planes"]]
    px = 0
    cut = False
    for r in case["recs"]:
        nL, lh, lw = r["laps"].shape
        mc.obmc_plane(per[r["pl"]], _t(r["laps"]), _t(r["ys"]), _t(r["xs"]),
                      r["region"], r["vert"])
        want[r["pl"]] = jmc.obmc_blend_batch(
            want[r["pl"]], jnp.asarray(r["laps"]), jnp.asarray(r["ys"]),
            jnp.asarray(r["xs"]), lh, lw, r["region"], r["vert"])
        rows, cols = mc.obmc_area(lh, lw, r["region"], r["vert"])
        real = r["ys"] != mc.PAD_OOB
        assert real.sum() < nL
        px += int(real.sum()) * rows * cols
        H, W = case["planes"][r["pl"]].shape
        cut |= bool(((r["ys"][real] + lh > H) | (r["xs"][real] + lw > W))
                    .any())
    assert case["work"] == (len(case["recs"]), px) and cut
    assert {r["vert"] for r in case["recs"]} == {False, True}
    for g, p, w, p0 in zip(got, per, want, case["planes"]):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert not np.array_equal(g.numpy(), p0)
    for pl in range(3):
        _assert_disjoint([(r["ys"], r["xs"]) + r["laps"].shape[1:]
                          for r in case["recs"] if r["pl"] == pl],
                         case["planes"][pl].shape)


def _assert_disjoint(laps, shape):
    """No two real laps [(ys, xs, lh, lw)] share a pixel of a plane of
    `shape`."""
    H, W = shape
    cover = np.zeros((H, W), np.int32)
    for ys, xs, lh, lw in laps:
        for y, x in zip(ys[ys != mc.PAD_OOB], xs[ys != mc.PAD_OOB]):
            cover[max(y, 0):max(min(y + lh, H), 0),
                  max(x, 0):max(min(x + lw, W), 0)] += 1
    assert cover.max() <= 1


# ---------------------------------------------------------------------
# the planner's runs on a miniature tools stream
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def programs():
    """The programs of the miniature tools stream with warped compound
    sides ("w" sub-ops) and both OBMC phases."""
    return ttp.tools_programs(1)


def _arr(desc, h):
    return desc[h[0]:h[0] + int(np.prod(h[1]))].reshape(h[1])


def test_obmc_laps_of_a_phase_are_disjoint(programs):
    """The blend kernel runs a phase's records of every plane in one
    launch: exact only if no two real laps of a phase, across records,
    share a plane pixel."""
    n = 0
    for sig, desc, *_ in programs:
        for phase in (False, True):
            for pl, shape in enumerate(sig[3]):
                laps = [(_arr(desc, r[8]), _arr(desc, r[9]), r[2], r[3])
                        for r in sig[0] if r[0] == "obmc" and r[1] == pl and
                        r[5] == phase]
                _assert_disjoint(laps, shape)
                n += len(laps) > 1
    assert n


def test_planner_tables_hold_real_rows_and_laps(programs):
    """The warprun table: an entry for each warp record, then for each "w"
    sub-op of the comp records, in order, with its real rows (those before
    its pad rows); after the frame's mcarena and its last warp record,
    before its first comp. Each phase's obmcrun table: an entry for each
    obmc record of the phase, with its arena offset and real laps (those
    before its PAD_OOB laps), after the phase's last obmc record."""
    seen = set()
    for sig, desc, *_ in programs:
        ops = sig[0]
        kinds = [r[0] for r in ops]
        want = []
        for r in ops:
            if r[0] == "warp":
                ys = _arr(desc, r[3])
                want.append((0, r[1], r[2][0], r[3][0], r[4][0],
                             int((ys != mc.PAD_OOB).sum()), len(ys)))
            elif r[0] == "comp":
                for side in r[5]:
                    for s in side:
                        if s[0] != "w":
                            continue
                        rows, base = _arr(desc, s[1]), _arr(desc, s[2])
                        n = len(base)
                        while n > 1 and base[n - 1] == base[n - 2] and \
                                (rows[n - 1] == rows[n - 2]).all():
                            n -= 1
                        want.append((1, r[1], s[1][0], s[2][0], 0, n,
                                     len(base)))
        if want:
            at = kinds.index("warprun")
            assert kinds.count("warprun") == 1
            assert kinds.index("mcarena") < at < kinds.index("comprun")
            assert "warp" not in kinds[at:]
            assert kinds[at - 1] == "warp" or "warp" not in kinds
            _, h_tab, work = ops[at]
            tab = mc.table_rows(_arr(desc, h_tab), work[0], mc.WENTRY)
            got = [(e[mc.W_FLAGS] & mc.WF_SLOT, e[mc.W_PLANE], e[mc.W_ROWS],
                    e[mc.W_YS], e[mc.W_XS], e[mc.W_NREAL]) for e in tab]
            assert got == [w[:6] for w in want]
            starts = [e[mc.W_START] for e in tab]
            assert starts == list(np.cumsum([0] + [w[5] for w in want])[:-1])
            assert work == (len(want), sum(w[5] for w in want))
            if any(w[5] < w[6] for w in want):
                seen.add("warp pads")
            seen.update("warp slot" if w[0] else "warp plane" for w in want)
        offs = iter(next(r for r in ops if r[0] == "mcarena")[2])
        laps = {0: [], 1: []}
        for i, r in enumerate(ops):
            if r[0] == "comp":
                next(offs)
            elif r[0] == "obmc":
                ys = _arr(desc, r[8])
                laps[int(r[5])].append(
                    (r[1], next(offs)[0], r[2], r[3], r[4], int(r[5]),
                     r[8][0], r[9][0], int((ys != mc.PAD_OOB).sum())))
                assert int((ys != mc.PAD_OOB).sum()) < r[6]
            elif r[0] == "obmcrun":
                ph, h_tab, work = r[1], r[2], r[3]
                assert laps[ph] and kinds[i - 1] == "obmc"
                tab = mc.table_rows(_arr(desc, h_tab), work[0], mc.OENTRY)
                assert [tuple(e[:mc.O_NREAL + 1]) for e in tab] == laps[ph]
                area = [e[mc.O_NREAL] * e[mc.O_ROWS] * e[mc.O_COLS]
                        for e in tab]
                assert [e[mc.O_START] for e in tab] == list(
                    np.cumsum([0] + area)[:-1])
                assert work == (len(tab), sum(area))
                assert all((e[mc.O_ROWS], e[mc.O_COLS]) == mc.obmc_area(
                    e[mc.O_LH], e[mc.O_LW], e[mc.O_REGION], e[mc.O_VERT])
                    for e in tab)
                seen.add(f"obmcrun {ph}")
                laps[ph] = None
        assert all(v is None or not v for v in laps.values())
    assert seen >= {"warp plane", "warp slot", "warp pads", "obmcrun 0",
                    "obmcrun 1"}


def test_executor_runs_each_frame_s_warps_and_laps_in_one_call_each(
        programs, monkeypatch):
    """The executor equals the JAX interpreter on a program with warp
    records, "w" sub-ops and OBMC laps of both phases, with one warp_run
    call, one obmc_run call a phase and one comp_run call for the comp
    records."""
    calls = {}
    for name in ("warp_run", "obmc_run", "comp_run"):
        def spy(*a, _fn=getattr(tools_cuda, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(tools_cuda, name, spy)
    sig, desc, desc16, desc8, refsrc = next(
        p for p in programs
        if {"warp", "warprun", "obmcrun"} <= {r[0] for r in p[0][0]} and
        len({r[1] for r in p[0][0] if r[0] == "obmcrun"}) == 2)
    assert any(s[0] == "w" for r in sig[0] if r[0] == "comp"
               for side in r[5] for s in side)
    planes, _ = tfe.execute_program(sig, *tfe.frame_program_to_torch(
        desc, desc16, desc8, refsrc, "cpu"))
    assert calls == {"warp_run": 1, "obmc_run": 2, "comp_run": 1}
    j_planes, _ = jfe._interpreter(sig)(desc, desc16, desc8, refsrc)
    for t, j in zip(planes, j_planes):
        np.testing.assert_array_equal(t.numpy().astype(np.int32),
                                      np.asarray(j).astype(np.int32))


def _moved(ops, kind, before):
    """ops with the first `kind` record moved right before the first
    record of a kind in `before` (or after it, with a leading '>')."""
    rec = next(r for r in ops if r[0] == kind)
    ops = [r for r in ops if r is not rec]
    after = before.startswith(">")
    i = next(i for i, r in enumerate(ops) if r[0] == before.lstrip(">"))
    return ops[:i + after] + [rec] + ops[i + after:]


def _obmc(ops, phase, last=False):
    """The index of the first (or last) obmc record of a phase."""
    idx = [i for i, r in enumerate(ops) if r[0] == "obmc" and
           r[5] == bool(phase)]
    return idx[-1] if last else idx[0]


BAD = {
    "no warprun": lambda o: [r for r in o if r[0] != "warprun"],
    "warprun twice": lambda o: o + [next(r for r in o if r[0] == "warprun")],
    "warprun before mcarena": lambda o: _moved(o, "warprun", "mcarena"),
    "warprun after a comp": lambda o: _moved(o, "warprun", ">comp"),
    "warp after warprun": lambda o: _moved(o, "warp", ">warprun"),
    "no obmcrun 0": lambda o: [r for r in o if r[:2] != ("obmcrun", 0)],
    "no obmcrun 1": lambda o: [r for r in o if r[:2] != ("obmcrun", 1)],
    "obmcrun 0 short": lambda o: [
        r if r[:2] != ("obmcrun", 0) else r[:3] + ((r[3][0] - 1, r[3][1]),)
        for r in o],
    "obmcrun 1 twice": lambda o: o + [next(
        r for r in o if r[:2] == ("obmcrun", 1))],
    "phase 1 before obmcrun 0": lambda o: o[:_obmc(o, 0, True) + 1] + [
        o[_obmc(o, 1)]] + [r for r in o[_obmc(o, 0, True) + 1:]
                           if r is not o[_obmc(o, 1)]],
    "obmc after its obmcrun": lambda o: _moved(o, "obmc", ">obmcrun"),
}


@pytest.mark.parametrize("how", sorted(BAD))
def test_check_ops_refuses_uncovered_warp_and_obmc_work(programs, how):
    sig = next(p[0] for p in programs
               if {"warp", "warprun", "mcarena"} <= {r[0] for r in p[0][0]}
               and len({r[1] for r in p[0][0] if r[0] == "obmcrun"}) == 2)
    ops = list(sig[0])
    tfe.check_ops(ops)
    bad = BAD[how](ops)
    assert bad != ops
    with pytest.raises(ValueError, match="warprun|obmcrun|obmc record"):
        tfe.check_ops(bad)
