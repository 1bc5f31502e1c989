"""The inter tool kernels' plain versions and records on the CPU
(dav1d_mirror_tpu_torch/ops/mc.py warp_run, comp_run and obmc_run, the
plain versions of csrc/warp.cu, csrc/comp.cu and csrc/obmc.cu, here on
one-entry lists: warp_plane, warp_slots and obmc_plane an entry, and a
comp case's records through comp_record and as one comp_run list; their
wrappers' CPU route in ops/tools_cuda.py; the planner's comprun record,
models/frame_exec.McRun):

- the synthetic cases of dav1d_mirror_tpu_torch/tools/tools_cases.py
  (the ones chip_smoke.py holds the kernels to) through the plain
  versions, equal to the JAX package's composition on the same numpy
  inputs: mc_tpu.warp8x8_batch with scatter_units or scatter_slot_units;
  the JAX interpreter's joins (comp_join_wavg, comp_join_wmask,
  comp_join_mask, its seg-mask registry) with scatter_units;
  mc_tpu.obmc_blend_batch. Bit depths 8, 10 and 12, the 4:2:0, 4:2:2 and
  4:4:4 layouts, every join kind with pad slots and both signs, both OBMC
  phases (the blended rows above the lap's own), warp put and prep with
  units cut by the plane's edges and phases past the filter table;
- the wrappers send CPU tensors to the plain versions and refuse other
  devices;
- on the planner's programs of a miniature tools stream: the real laps
  of each obmc record are disjoint (the blend kernel reads and writes the
  plane in one launch), and each comp record's rows of the comprun table
  are what its JAX-form joins imply;
- the executor refuses comp records that no comprun covers, a comprun
  of too few entries, and a comprun before the frame's mcarena.

Tolerance: exact."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))

import torch_tools_programs as ttp  # noqa: E402
from dav1d_mirror_tpu.ops import mc_tpu as jmc  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
from dav1d_mirror_tpu_torch.ops import mc, tools_cuda  # noqa: E402
from dav1d_mirror_tpu_torch.tools import tools_cases as tc  # noqa: E402

CPU = torch.device("cpu")
RNG_SEED = 2027     # tools_cases.check_all's seed: the card's cases
WARP = tc.warp_cases(np.random.default_rng(RNG_SEED))
COMP = tc.comp_cases(np.random.default_rng(RNG_SEED + 1))
OBMC = tc.obmc_cases(np.random.default_rng(RNG_SEED + 2))


def _ids(cases):
    return [label for label, _ in cases]


@pytest.mark.parametrize("case", WARP, ids=_ids(WARP))
def test_warp_plain_matches_jax(case):
    _, kw = case
    out = jmc.warp8x8_batch(jnp.asarray(kw["refs"]), jnp.asarray(kw["rows"]),
                            kw["bd"], kw.get("prep", False))
    if "plane" in kw:
        want = jmc.scatter_units(jnp.asarray(kw["plane"]), out,
                                 jnp.asarray(kw["ys"]), jnp.asarray(kw["xs"]),
                                 8, 8)
    else:
        want = jmc.scatter_slot_units(jnp.asarray(kw["buf"]),
                                      jnp.asarray(kw["base"]), out, 8, 8,
                                      kw["buf"].shape[2])
    got = tc.run_warp(tools_cuda, kw, CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the phases past the table: rows above it, in [-193, -1] and below
    # -193 (warp_rows' rows 1-3)
    rows = kw["rows"].astype(np.int64)
    x, y = np.arange(8)[None, :], np.arange(15)[:, None]
    tab = 64 + ((rows[1:4, 3, None, None] + x * rows[1:4, 5, None, None] +
                 y * rows[1:4, 6, None, None] + 512) >> 10)
    assert tab.max() > 192 and tab.min() < -193
    assert ((tab < 0) & (tab >= -193)).any()


@pytest.mark.parametrize("case", COMP, ids=_ids(COMP))
def test_comp_record_plain_matches_jax(case):
    """The case's records through the per-record comp_record (seg luma
    slots writing their chroma masks into an arena, seg chroma slots
    reading them) and as one list through the wrapper's CPU route (the
    plain comp_run), each equal to the JAX interpreter's joins."""
    _, c = case
    kinds = {j[0] for r in c["records"] for j in r["joins"]}
    assert kinds == {"wavg", "segl", "segc", "wedge"}
    specs = {j[3][0] for r in c["records"] for j in r["joins"]
             if j[0] == "segc"}
    assert specs == {"one", "mix"}
    _, rows = mc.comp_table_parts(c["tab"], c["work"])
    assert {0, 1} <= set(rows[rows[:, mc.R_KIND] != mc.CJ_WAVG,
                              mc.R_PAR].tolist())
    want = ttp.jax_comp(c)
    _, n_masks = tc.comp_record_tables(c)
    assert n_masks > 0
    for got in (tc.run_comp_records(c, CPU), tc.run_comp(tools_cuda, c, CPU)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert not np.array_equal(got[0].numpy(), c["planes"][0])


@pytest.mark.parametrize("case", OBMC, ids=_ids(OBMC))
def test_obmc_plane_plain_matches_jax(case):
    _, kw = case
    lh, lw = kw["laps"].shape[1:]
    want = jmc.obmc_blend_batch(jnp.asarray(kw["plane"]),
                                jnp.asarray(kw["laps"]), jnp.asarray(kw["ys"]),
                                jnp.asarray(kw["xs"]), lh, lw, kw["region"],
                                kw["vert"])
    got = tc.run_obmc(tools_cuda, kw, CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), kw["plane"])
    # the real laps are disjoint (the kernel blends in place), and some
    # are cut by the plane's edges
    real = kw["ys"] != mc.PAD_OOB
    cover = np.zeros((kw["plane"].shape[0] + lh, kw["plane"].shape[1] + lw),
                     np.int32)
    for y, x in zip(kw["ys"][real], kw["xs"][real]):
        cover[y:y + lh, x:x + lw] += 1
    assert cover.max() == 1
    assert cover[kw["plane"].shape[0]:].any() or \
        cover[:, kw["plane"].shape[1]:].any()


def test_obmc_mask_table_is_cached_per_device():
    t = mc.obmc_mask_table(CPU)
    assert t is mc.obmc_mask_table(torch.device("cpu"))
    assert t.dtype == torch.int32 and t.tolist() == mc.OBMC_MASKS.tolist()


def test_wrappers_route_cpu_and_refuse_other_devices():
    """CPU tensors go to the plain versions (the same result); tensors on
    any other device than the CPU or a CUDA card raise."""
    _, kw = OBMC[0]
    assert torch.equal(tc.run_obmc(tools_cuda, kw, CPU),
                       tc.run_obmc(mc, kw, CPU))
    m = torch.zeros(120, dtype=torch.int32, device="meta")
    p, m3 = m[:64].view(8, 8), m[:64].view(1, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tools_cuda.warp_run(m[:mc.WENTRY], (1, 1), m, m.to(torch.int16),
                            [p], [m3], m, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tools_cuda.comp_run(m[:mc.CENTRY + mc.CROW], (1, 1, 64), m, [p], m,
                            8)
    with pytest.raises(ValueError, match="CUDA"):
        tools_cuda.obmc_run(m[:mc.OENTRY], (1, 1), m, [p], m)


# ---------------------------------------------------------------------
# the planner's records on a miniature tools stream
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def tools_programs():
    """(sig, desc) of the recon programs of a lossless 128x64 stream with
    every tool (its frame 1 holds all four joins, warps and OBMC laps of
    both phases)."""
    return [(p[0], p[1]) for p in ttp.tools_programs()]


def test_obmc_laps_of_a_record_are_disjoint(tools_programs):
    """The blend kernel reads and writes the plane in one launch: exact
    only if no two real laps of an obmc record share a plane pixel."""
    n_recs = 0
    for sig, desc in tools_programs:
        shapes = sig[3]
        for op in sig[0]:
            if op[0] != "obmc":
                continue
            _, pl, lh, lw, _, _, nL, _, h_ys, h_xs = op
            ys, xs = tc.comp_slice(desc, h_ys), tc.comp_slice(desc, h_xs)
            real = ys != mc.PAD_OOB
            yy = ys[real, None, None] + np.arange(lh)[None, :, None]
            xx = xs[real, None, None] + np.arange(lw)[None, None, :]
            yy, xx = np.broadcast_arrays(yy, xx)
            H, W = shapes[pl]
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            lin = (yy * W + xx)[inside]
            assert len(np.unique(lin)) == len(lin), (op[:6], "laps overlap")
            n_recs += 1
    assert n_recs


def _real_slots(desc, rec):
    dy = tc.comp_slice(desc, rec[9])
    return int(np.sum(dy != mc.PAD_OOB))


def test_comp_tables_and_mask_arena_match_the_joins(tools_programs):
    """The frame's one comprun record, right before its first comp record,
    holds an entry for each comp record, in order: its plane, slot shape,
    mask cell, sides' arena offsets (the mcarena record's), origins and
    real slots (those before the pad slots), each with a row holding the
    kind and weight or sign of the join that covers it; a wedge row's
    offset holds its mask, and each seg chroma row names the seg luma row
    that its registry entry names, with that luma slot's sides, shape and
    sign (from which the kernel derives the mask)."""
    kinds_seen = set()
    for sig, desc in tools_programs:
        ops = sig[0]
        kinds = [r[0] for r in ops]
        at = kinds.index("comprun")
        assert kinds.count("comprun") == 1 and kinds[at + 1] == "comp"
        assert "comp" not in kinds[:at]
        _, h_tab, work = ops[at]
        ents, rows = mc.comp_table_parts(tc.comp_slice(desc, h_tab), work)
        offs = iter(next(r for r in ops if r[0] == "mcarena")[2])
        seg = {}        # (seg luma join id, list index) -> its luma row
        n_ent = 0
        for rec in ops:
            if rec[0] == "obmc":
                next(offs)
            if rec[0] != "comp":
                continue
            s0, s1 = next(offs)
            _, pl, bwp, bhp, N, _, joins, ssh, ssv, h_dy, h_dx = rec
            n = _real_slots(desc, rec)
            e = ents[n_ent]
            n_ent += 1
            assert n < N
            assert tuple(e[:mc.C_NREAL + 1]) == (
                pl, bhp, bwp, int(bool(ssh)), int(bool(ssh and ssv)), s0, s1,
                h_dy[0], h_dx[0], n)
            f = e[mc.C_FIRST]
            for j in joins:
                sl = tc.comp_slice(desc, j[1])
                par = tc.comp_slice(desc, j[2])
                kind = {"wavg": mc.CJ_WAVG, "segl": mc.CJ_SEGL,
                        "segc": mc.CJ_SEGC, "wedge": mc.CJ_WEDGE}[j[0]]
                kinds_seen.add(j[0])
                for k, s in enumerate(sl):
                    if j[0] == "segl" and s < n:
                        seg[(j[3], k)] = (f + s, s0 + s * bhp * bwp,
                                          s1 + s * bhp * bwp, bhp, bwp,
                                          par[k])
                    if s >= n:
                        continue
                    row = rows[f + s]
                    assert tuple(row[:2]) == (kind, par[k]), (j[0], s)
                    moff = int(row[mc.R_MOFF])
                    if j[0] == "wedge":
                        m = tc.comp_slice(desc, j[3])[k]
                        np.testing.assert_array_equal(
                            desc[moff:moff + bhp * bwp].reshape(bhp, bwp), m)
                    elif j[0] == "segc":
                        spec = j[3]
                        ref = (spec[1], int(tc.comp_slice(desc, spec[2])[k])) \
                            if spec[0] == "one" else spec[1][k]
                        assert (moff,) + tuple(row[mc.R_L0:]) == seg[ref], \
                            (ref, row)
        assert n_ent == len(ents) == work[0]
        assert ents[:, mc.C_NREAL].sum() == len(rows) == work[1]
        items = ents[:, mc.C_NREAL] * ents[:, mc.C_BH] * ents[:, mc.C_BW] // \
            mc.COMP_ITEM
        assert list(ents[:, mc.C_START]) == list(np.cumsum(items) - items)
        assert work[2] == items.sum()
    assert kinds_seen == {"wavg", "segl", "segc", "wedge"}


@pytest.mark.parametrize("how", ["no comprun", "comprun short",
                                 "comprun before mcarena"])
def test_executor_refuses_comp_records_without_their_tables(
        tools_programs, how):
    sig, desc = next((s, d) for s, d in tools_programs
                     if any(j[0] == "segc" for r in s[0] if r[0] == "comp"
                            for j in r[6]))
    ops = list(sig[0])
    if how == "no comprun":
        ops = [r for r in ops if r[0] != "comprun"]
    elif how == "comprun short":
        ops = [r if r[0] != "comprun" else
               r[:2] + ((r[2][0] - 1,) + r[2][1:],) for r in ops]
    else:
        rec = next(r for r in ops if r[0] == "comprun")
        ops.remove(rec)
        ops.insert(0, rec)
    with pytest.raises(ValueError, match="comprun"):
        tfe.check_ops(ops)
    tfe.check_ops(sig[0])
