"""The inter tool kernels' plain versions and records on the CPU
(dav1d_mirror_tpu_torch/ops/mc.py warp_run, comp_record and obmc_run, the
plain versions of csrc/warp.cu, csrc/comp.cu and csrc/obmc.cu, here on
one-entry lists: warp_plane, warp_slots and obmc_plane an entry; their
wrappers' CPU route in ops/tools_cuda.py; the planner's comptab and
cmarena records, models/frame_exec.McRun):

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
  plane in one launch), and each comp record's table and the seg-mask
  arena are what its JAX-form joins imply;
- the executor refuses a comp record without its comptab, a comptab
  without its comp, and seg joins without the frame's cmarena.

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


def _jax_comp(case):
    """The JAX interpreter's comp branch (models/frame_exec._interpreter)
    on each record of the case, in order: (luma plane, chroma plane)."""
    desc = case["desc"]

    def get(h):
        return jnp.asarray(tc.comp_slice(desc, h))
    planes = [jnp.asarray(p) for p in case["planes"]]
    cms = {}
    bd, ssh, ssv = case["bd"], case["ssh"], case["ssv"]
    for r in case["records"]:
        t0, t1 = jnp.asarray(r["tmp0"]), jnp.asarray(r["tmp1"])
        out = jnp.zeros((r["N"], r["bhp"], r["bwp"]), jnp.int32)
        for j in r["joins"]:
            if j[0] == "wavg":
                out = jmc.comp_join_wavg(out, t0, t1, get(j[1]),
                                         get(j[2])[:, None, None], bd)
            elif j[0] == "segl":
                out, cms[j[3]] = jmc.comp_join_wmask(
                    out, t0, t1, get(j[1]), get(j[2]), ssh, ssv, bd)
            elif j[0] == "segc":
                spec = j[3]
                m = cms[spec[1]][get(spec[2])] if spec[0] == "one" else \
                    jnp.stack([cms[c][jj] for c, jj in spec[1]])
                out = jmc.comp_join_mask(out, t0, t1, get(j[1]), get(j[2]),
                                         m, bd)
            else:
                out = jmc.comp_join_mask(out, t0, t1, get(j[1]), get(j[2]),
                                         get(j[3]), bd)
        planes[r["pl"]] = jmc.scatter_units(
            planes[r["pl"]], out, get(r["h_dy"]), get(r["h_dx"]), r["bhp"],
            r["bwp"])
    return planes


@pytest.mark.parametrize("case", COMP, ids=_ids(COMP))
def test_comp_record_plain_matches_jax(case):
    _, c = case
    kinds = {j[0] for r in c["records"] for j in r["joins"]}
    assert kinds == {"wavg", "segl", "segc", "wedge"}
    specs = {j[3][0] for r in c["records"] for j in r["joins"]
             if j[0] == "segc"}
    assert specs == {"one", "mix"}
    signs = np.concatenate([tc.comp_slice(c["desc"], r["h_tab"])[:, 1]
                            for r in c["records"]])
    assert {0, 1} <= set(signs.tolist())
    luma, chroma, masks = tc.run_comp(tools_cuda, c, CPU)
    want = _jax_comp(c)
    np.testing.assert_array_equal(luma.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(chroma.numpy(), np.asarray(want[1]))
    assert not np.array_equal(luma.numpy(), c["planes"][0])
    assert masks.numel() == c["cm_n"] > 0


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
        tools_cuda.comp_record(p, m3, m3, m.view(40, 3)[:1], m, m, m, m, 1,
                               1, 8)
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
    """Each comp record follows its comptab record: a row a real slot
    (those before the pad slots) with the kind, weight or sign of the
    join that covers it; a wedge row's offset holds its mask; the seg
    luma rows' spans lie disjoint inside the cmarena record's arena, and
    each seg chroma row names the span of the luma slot that its
    registry entry names."""
    kinds_seen = set()
    for sig, desc in tools_programs:
        ops = sig[0]
        arena = [r[1] for r in ops if r[0] == "cmarena"]
        spans = {}       # (seg luma join id, slot) -> span
        used = []
        for i, rec in enumerate(ops):
            if rec[0] != "comp":
                continue
            tab_rec = ops[i - 1]
            assert tab_rec[0] == "comptab"
            tab = tc.comp_slice(desc, tab_rec[1])
            _, pl, bwp, bhp, N, _, joins, ssh, ssv, _, _ = rec
            n = _real_slots(desc, rec)
            assert tab.shape == (n, mc.CJ_COLS) and n < N
            seg_luma = {}
            for j in joins:
                sl = tc.comp_slice(desc, j[1])
                par = tc.comp_slice(desc, j[2])
                kind = {"wavg": mc.CJ_WAVG, "segl": mc.CJ_SEGL,
                        "segc": mc.CJ_SEGC, "wedge": mc.CJ_WEDGE}[j[0]]
                kinds_seen.add(j[0])
                for k, s in enumerate(sl):
                    if s >= n:
                        continue
                    assert tuple(tab[s, :2]) == (kind, par[k]), (j[0], s)
                    moff = int(tab[s, 2])
                    if j[0] == "wedge":
                        m = tc.comp_slice(desc, j[3])[k]
                        np.testing.assert_array_equal(
                            desc[moff:moff + bhp * bwp].reshape(bhp, bwp), m)
                    elif j[0] == "segl":
                        seg_luma[s] = moff
                        spans[(j[3], k)] = moff
                    elif j[0] == "segc":
                        spec = j[3]
                        ref = (spec[1], int(tc.comp_slice(desc, spec[2])[k])) \
                            if spec[0] == "one" else spec[1][k]
                        assert moff == spans[ref], (ref, moff)
            if seg_luma:
                mh, mw = mc.seg_mask_shape(bhp, bwp, ssh, ssv)
                used.extend((o, o + mh * mw) for o in seg_luma.values())
        if used:
            assert len(arena) == 1
            used.sort()
            assert used[0][0] >= 0 and used[-1][1] <= arena[0]
            assert all(a[1] <= b[0] for a, b in zip(used, used[1:]))
        else:
            assert not arena
    assert kinds_seen == {"wavg", "segl", "segc", "wedge"}


@pytest.mark.parametrize("how", ["no comptab", "comptab alone",
                                 "no cmarena"])
def test_executor_refuses_comp_records_without_their_tables(
        tools_programs, how):
    sig, desc = next((s, d) for s, d in tools_programs
                     if any(r[0] == "cmarena" for r in s[0]))
    ops = list(sig[0])
    if how == "no comptab":
        ops = [r for r in ops if r[0] != "comptab"]
    elif how == "comptab alone":
        i = next(i for i, r in enumerate(ops) if r[0] == "comp")
        ops.pop(i)
    else:
        ops = [r for r in ops if r[0] != "cmarena"]
    with pytest.raises(ValueError, match="comptab|cmarena"):
        tfe.check_ops(ops)
    tfe.check_ops(sig[0])
