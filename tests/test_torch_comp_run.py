"""The compound joins as one work list a frame on the CPU
(dav1d_mirror_tpu_torch/ops/mc.py comp_run, the plain version of
csrc/comp.cu, and its table, comp_build_table; the planner's comprun
record, models/frame_exec.McRun; the executor's run and check_ops; the
tile-sharded decode's joins, parallel/tile_decode.py):

- mixed lists (tools/tools_cases.comp_case: two luma and two chroma
  records, every join kind, seg chroma rows whose luma slot lies in
  another record, pad slots, blocks cut by the planes' edges) at bit
  depths 8, 10 and 12 in the 4:2:0, 4:2:2 and 4:4:4 layouts through
  comp_run (seg chroma masks derived from the luma sides, as the kernel
  derives them), equal to the per-record comp_record (seg luma slots
  writing their chroma masks into an arena, seg chroma slots reading
  them), to the JAX interpreter's comp_join_wavg, comp_join_wmask and
  comp_join_mask with scatter_units, and to the list's one-entry lists
  run in order;
- on the programs of a miniature tools stream: the executor equals the
  JAX interpreter with one comp_run call a frame; the comprun table holds
  real slots only and each seg chroma row names the luma slot of its
  block; only comp records lie between the comprun and the frame's last
  comp record, and the joins' pixels are disjoint;
- check_ops refuses comp work that no comprun covers and a comprun out of
  place; comp_build_table refuses a seg chroma row without its luma row
  and a slot width the kernel's four-pixel work items cannot cover;
- the tile-sharded decode (world size 1, gloo) joins its compound
  buckets through tools_cuda.comp_run, one call a frame, with no eager
  join outside it, and decodes as the port's Decoder does.

Tolerance: exact."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import torch_tools_programs as ttp  # noqa: E402
from dav1d_mirror_tpu.models import frame_exec as jfe  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
from dav1d_mirror_tpu_torch.ops import mc, tools_cuda  # noqa: E402
from dav1d_mirror_tpu_torch.tools import tools_cases as tc  # noqa: E402

CPU = torch.device("cpu")
LAYOUTS = [(1, 1), (1, 0), (0, 0)]


@pytest.mark.parametrize("ssh,ssv", LAYOUTS)
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_mixed_list_matches_per_record_and_jax(bd, ssh, ssv):
    c = tc.comp_case(np.random.default_rng(bd * 10 + ssh * 2 + ssv), bd,
                     ssh, ssv, bw=32, bh=16, H=72, W=104)
    ents, rows = mc.comp_table_parts(c["tab"], c["work"])
    ent = np.repeat(np.arange(len(ents)), ents[:, mc.C_NREAL])
    segc = np.flatnonzero(rows[:, mc.R_KIND] == mc.CJ_SEGC)
    assert set(rows[:, mc.R_KIND]) == {mc.CJ_WAVG, mc.CJ_SEGL, mc.CJ_SEGC,
                                      mc.CJ_WEDGE}
    # the last chroma record reads the masks of both luma records
    assert {ent[rows[g, mc.R_MOFF]] for g in segc if ent[g] == 3} == {0, 1}
    # the records' real slots are disjoint, as the planner's are: the
    # kernel joins them all in one launch
    for pl, shape in enumerate(p.shape for p in c["planes"]):
        cover = np.zeros(shape, np.int32)
        for r in c["records"]:
            dy, dx = (tc.comp_slice(c["desc"], r[h]) for h in ("h_dy", "h_dx"))
            for y, x in zip(dy[dy != mc.PAD_OOB], dx[dy != mc.PAD_OOB]):
                if r["pl"] == pl:
                    cover[y:y + r["bhp"], x:x + r["bwp"]] += 1
        assert cover.max() == 1
    got = tc.run_comp(mc, c, CPU)
    per = tc.run_comp_records(c, CPU)
    want = ttp.jax_comp(c)
    split = tc.to_torch(c["planes"], CPU)
    for tab, work in tc.one_entry_lists(c["tab"], c["work"], "comp"):
        mc.comp_run(torch.from_numpy(tab), work, torch.from_numpy(c["desc"]),
                    split, torch.from_numpy(c["arena"]), bd)
    for g, p, s, w, p0 in zip(got, per, split, want, c["planes"]):
        assert torch.equal(g, p) and torch.equal(g, s)
        np.testing.assert_array_equal(g.numpy(), w)
        assert not np.array_equal(g.numpy(), p0)


# ---------------------------------------------------------------------
# the planner's comprun record on a miniature tools stream
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def programs():
    """The programs of the miniature tools stream whose frames hold all
    four joins (seg chroma rows among them), warps and OBMC laps."""
    return ttp.tools_programs(5)


def _arr(desc, h):
    return desc[h[0]:h[0] + int(np.prod(h[1]))].reshape(h[1])


def test_executor_runs_a_frame_s_joins_in_one_comp_run_call(programs,
                                                             monkeypatch):
    """The executor equals the JAX interpreter on the program whose comp
    records hold only seg joins (luma and chroma: the joins whose masks
    cross records), with one comp_run call and no comp_record call
    outside it (tests/test_torch_tools_runs.py holds a whole tools frame
    to the interpreter)."""
    calls = {"comp_run": 0, "comp_record": 0}
    inside = []

    def run_spy(*a, _fn=tools_cuda.comp_run, **k):
        calls["comp_run"] += 1
        inside.append(True)
        try:
            return _fn(*a, **k)
        finally:
            inside.pop()

    def rec_spy(*a, _fn=mc.comp_record, **k):
        assert inside, "comp_record outside comp_run"
        calls["comp_record"] += 1
        return _fn(*a, **k)
    monkeypatch.setattr(tools_cuda, "comp_run", run_spy)
    monkeypatch.setattr(mc, "comp_record", rec_spy)
    sig, desc, desc16, desc8, refsrc = programs[1]
    assert {j[0] for r in sig[0] if r[0] == "comp" for j in r[6]} == {
        "segl", "segc"}
    planes, _ = tfe.execute_program(sig, *tfe.frame_program_to_torch(
        desc, desc16, desc8, refsrc, "cpu"))
    assert calls == {"comp_run": 1, "comp_record": sum(
        r[0] == "comp" for r in sig[0])}
    j_planes, _ = jfe._interpreter(sig)(desc, desc16, desc8, refsrc)
    for t, j in zip(planes, j_planes):
        np.testing.assert_array_equal(t.numpy().astype(np.int32),
                                      np.asarray(j).astype(np.int32))


def _comprun(sig, desc):
    """(index, entries, rows, work) of the program's comprun record."""
    at = next(i for i, r in enumerate(sig[0]) if r[0] == "comprun")
    _, h_tab, work = sig[0][at]
    return (at,) + mc.comp_table_parts(_arr(desc, h_tab), work) + (work,)


def test_table_holds_real_slots_and_seg_rows_name_their_luma_slot(programs):
    """The comprun table has a row for each real slot (those before the
    PAD_OOB pad slots) and none for a pad slot; each seg chroma row names
    a seg luma row whose block is its own (its origin, subsampled, is the
    chroma slot's), with that luma slot's sides, shape and sign."""
    n_segc = 0
    for sig, desc, *_ in programs:
        _, ents, rows, work = _comprun(sig, desc)
        comps = [r for r in sig[0] if r[0] == "comp"]
        real = [int((_arr(desc, r[9]) != mc.PAD_OOB).sum()) for r in comps]
        assert list(ents[:, mc.C_NREAL]) == real
        assert sum(real) == len(rows) == work[1] < sum(r[4] for r in comps)
        ent = np.repeat(np.arange(len(ents)), ents[:, mc.C_NREAL])
        slot = np.arange(len(rows)) - ents[ent, mc.C_FIRST]

        def origin(g):
            e = ents[ent[g]]
            return (desc[e[mc.C_DY] + slot[g]], desc[e[mc.C_DX] + slot[g]])
        for g in np.flatnonzero(rows[:, mc.R_KIND] == mc.CJ_SEGC):
            lg = rows[g, mc.R_MOFF]
            le, ce = ents[ent[lg]], ents[ent[g]]
            assert rows[lg, mc.R_KIND] == mc.CJ_SEGL and le[mc.C_PLANE] == 0
            ly, lx = origin(lg)
            assert origin(g) == (ly >> ce[mc.C_CV], lx >> ce[mc.C_CH])
            area = le[mc.C_BH] * le[mc.C_BW]
            assert tuple(rows[g, mc.R_L0:]) == (
                le[mc.C_S0] + slot[lg] * area, le[mc.C_S1] + slot[lg] * area,
                le[mc.C_BH], le[mc.C_BW], rows[lg, mc.R_PAR])
            n_segc += 1
    assert n_segc


def test_joins_are_disjoint_and_alone_until_the_last_comp_record(programs):
    """The kernel writes every join at the comprun record: exact only if
    no record between it and the frame's last comp record reads or writes
    a joined pixel (only comp records lie there, which the executor passes
    over) and no two real slots share a plane pixel."""
    for sig, desc, *_ in programs:
        ops = sig[0]
        at = _comprun(sig, desc)[0]
        last = max(i for i, r in enumerate(ops) if r[0] == "comp")
        assert {r[0] for r in ops[at + 1:last + 1]} == {"comp"}
        assert "comp" not in {r[0] for r in ops[:at]}
        cover = [np.zeros(s, np.int32) for s in sig[3]]
        for r in ops[at + 1:last + 1]:
            _, pl, bwp, bhp = r[:4]
            H, W = sig[3][pl]
            for y, x in zip(_arr(desc, r[9]), _arr(desc, r[10])):
                if y != mc.PAD_OOB:
                    cover[pl][max(y, 0):max(min(y + bhp, H), 0),
                              max(x, 0):max(min(x + bwp, W), 0)] += 1
        assert max(int(c.max()) for c in cover) == 1


def _moved(ops, kind, before):
    """ops with the first `kind` record moved right before the first
    record of kind `before`."""
    rec = next(r for r in ops if r[0] == kind)
    ops = [r for r in ops if r is not rec]
    i = next(i for i, r in enumerate(ops) if r[0] == before)
    return ops[:i] + [rec] + ops[i:]


def _between(ops):
    """ops with the first obmc record moved between the first two comp
    records."""
    rec = next(r for r in ops if r[0] == "obmc")
    ops = [r for r in ops if r is not rec]
    i = next(i for i, r in enumerate(ops) if r[0] == "comp")
    return ops[:i + 1] + [rec] + ops[i + 1:]


BAD = {
    "no comprun": lambda o: [r for r in o if r[0] != "comprun"],
    "comprun short": lambda o: [
        r if r[0] != "comprun" else r[:2] + ((r[2][0] - 1,) + r[2][1:],)
        for r in o],
    "comprun twice": lambda o: o + [next(r for r in o if r[0] == "comprun")],
    "comprun before mcarena": lambda o: _moved(o, "comprun", "mcarena"),
    "comprun before warprun": lambda o: _moved(o, "comprun", "warprun"),
    "comp before comprun": lambda o: _moved(o, "comp", "comprun"),
    "a record between the comp records": _between,
}


@pytest.mark.parametrize("how", sorted(BAD))
def test_check_ops_refuses_uncovered_or_misplaced_comp_work(programs, how):
    sig = programs[0][0]
    ops = list(sig[0])
    assert {"mcarena", "warprun", "comprun", "obmc"} <= {r[0] for r in ops}
    tfe.check_ops(ops)
    bad = BAD[how](ops)
    assert bad != ops
    with pytest.raises(ValueError, match="comprun|comp record"):
        tfe.check_ops(bad)


@pytest.mark.parametrize("how", ["seg chroma row names a wedge row",
                                 "seg chroma row outside the mask",
                                 "slot width not a multiple of four"])
def test_build_table_refuses_what_the_kernel_cannot_run(how):
    luma = dict(plane=0, bhp=8, bwp=16, ch=1, cv=1, s0=0, s1=512, dy=0, dx=4,
                rows=[(mc.CJ_WEDGE, 0, 0), (mc.CJ_SEGL, 1, 0)])
    chroma = dict(luma, plane=1, bhp=4, bwp=8, s0=1024, s1=1088,
                  rows=[(mc.CJ_SEGC, 1, 1)])
    mc.comp_build_table([luma, chroma])
    if how.endswith("wedge row"):
        chroma["rows"] = [(mc.CJ_SEGC, 1, 0)]
    elif how.endswith("mask"):
        chroma.update(bhp=8)
    else:
        chroma.update(bwp=6)
    with pytest.raises(ValueError, match="seg chroma row|multiple of 4"):
        mc.comp_build_table([luma, chroma])


# ---------------------------------------------------------------------
# the tile-sharded decode
# ---------------------------------------------------------------------
def _compound_chain():
    """A 64x64 keyframe and 2 inter frames of one tile, every block of
    the inter frames inter, compound allowed (the streamgen chain of
    tests/test_torch_parallel.py)."""
    from dav1d_mirror_tpu.data.tables import new_cdf_context, qcat_from_qidx
    from dav1d_mirror_tpu.host import headers as h
    from dav1d_mirror_tpu.testing.streamgen import (
        RandomPolicy, gen_frame_tiles, gen_ivf, make_inter_frame_hdr,
        make_key_frame_hdr, make_seq_hdr)

    class InterOnly(RandomPolicy):
        def __call__(self, key, maxv):
            return 1 if key == "is_inter" else super().__call__(key, maxv)
    lf = (28, 28, 20, 20, 1)
    seq = make_seq_hdr(64, 64)
    kf = make_key_frame_hdr(seq, qidx=100, txfm_mode=h.TX_SWITCHABLE,
                            loopfilter=lf, tiles=(0, 0))
    cdf = new_cdf_context(qcat_from_qidx(100))
    frames = [(kf, gen_frame_tiles(seq, kf, InterOnly(9), cdf=cdf.copy())[0],
               None)]
    for i in range(2):
        fi = make_inter_frame_hdr(seq, qidx=100, txfm_mode=h.TX_SWITCHABLE,
                                  loopfilter=lf, tiles=(0, 0),
                                  switchable_comp=True)
        frames.append((fi, gen_frame_tiles(
            seq, fi, InterOnly(50 + 7 * i), cdf=cdf.copy(),
            ref_poc=[0] * 7)[0], [kf] * 8))
    return gen_ivf(seq, frames)


def test_tile_sharded_decode_joins_through_comp_run(monkeypatch):
    """Each inter frame's compound buckets go through tools_cuda.comp_run
    as one list (average and distance-weighted rows), and no join runs
    outside it: the decode equals the port's Decoder."""
    from dav1d_mirror_tpu_torch import api
    from dav1d_mirror_tpu_torch.parallel import dryrun
    from dav1d_mirror_tpu_torch.parallel.mesh import close_mesh, init_mesh
    data = _compound_chain()
    lists = []
    inside = []

    def run_spy(tab, work, *a, _fn=tools_cuda.comp_run, **k):
        ents, rows = mc.comp_table_parts(tab, work)
        lists.append((len(ents), set(rows[:, mc.R_KIND].tolist())))
        inside.append(True)
        try:
            return _fn(tab, work, *a, **k)
        finally:
            inside.pop()

    def no_eager(name):
        def spy(*a, _fn=getattr(mc, name), **k):
            assert inside, f"{name} outside comp_run"
            return _fn(*a, **k)
        return spy
    assert not hasattr(mc, "comp_join_wavg")
    monkeypatch.setattr(tools_cuda, "comp_run", run_spy)
    for name in ("w_avg_batch", "mask_batch", "w_mask_batch"):
        monkeypatch.setattr(mc, name, no_eager(name))
    mesh = init_mesh(1, 0, f"tcp://127.0.0.1:{dryrun.free_port()}", "cpu")
    try:
        got = dryrun.sharded_stream_decode(data, mesh)
    finally:
        close_mesh()
    assert len(lists) == 2, lists     # one list an inter frame
    assert all(n >= 1 and kinds == {mc.CJ_WAVG} for n, kinds in lists)
    lists.clear()
    want = dryrun._md5_decode(api.Decoder(api.Settings(device="cpu",
                                                       logger=None)), data)
    assert got == want and want[1] == 3
