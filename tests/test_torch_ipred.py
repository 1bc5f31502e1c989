"""The PyTorch port's batched intra predictors (dav1d_mirror_tpu_torch/
ops/ipred.py) against the JAX package's per-unit ones (ops/ipred_tpu.py,
under jax.vmap), exact.

The unit parameter rows come from real plans: the port's planner over
the port's entropy decode of intra streams (test_e2e_intra.build_stream)
that together use every predictor mode, CFL at 4:2:0, 4:2:2 and 4:4:4,
intra edge filtering and upsampling, palette and filter-intra, at bit
depths 8, 10 and 12. The plane strips and windows the predictors read
are random, made from a seed with numpy."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: E402
from dav1d_mirror_tpu.ops import ipred_tpu as JP  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.models import intra as TI  # noqa: E402
from dav1d_mirror_tpu_torch.ops import ipred as TP  # noqa: E402
from test_e2e_intra import build_stream  # noqa: E402
from test_ipred_tpu import FAST_CASES, SLOW_CASES  # noqa: E402

# name: (stream configuration, seed). FAST_CASES / SLOW_CASES are
# test_ipred_tpu's; "fi" is FAST_CASES[2] at a seed whose stream has
# filter-intra blocks, "444" SLOW_CASES[2] at one with CFL blocks, "ief"
# a 4:2:2 stream with edge filtering and upsampling on both edges, CFL
# and palette.
CASES = {
    "dir_mix": (FAST_CASES[0], 5),
    "rect_odd": (FAST_CASES[1], 6),
    "fi": (FAST_CASES[2], 4),
    "palette": (FAST_CASES[3], 8),
    "bd10": (SLOW_CASES[1], 12),
    "444": (SLOW_CASES[2], 5),
    "422": (SLOW_CASES[3], 14),
    "mono": (SLOW_CASES[4], 15),
    "bd12": (SLOW_CASES[5], 16),
    "ief": (dict(w=64, h=64, q=120, ief=1, txsw=True, layout=2), 7),
}

_FRAMES = {}


def port_frame(name):
    """(seq, fhdr, coders) of the port's entropy decode of CASES[name]'s
    keyframe, through Decoder(Settings(device="cpu", intra_engine=True))."""
    if name not in _FRAMES:
        cfg, seed = CASES[name]
        _, _, ivf = build_stream(cfg, seed)
        box = {}
        orig = tapi.build_intra_frame

        def spy(seq, fhdr, coders, bufs):
            box.update(seq=seq, fhdr=fhdr, coders=coders)
            return orig(seq, fhdr, coders, bufs)

        tapi.build_intra_frame = spy
        try:
            d = tapi.Decoder(tapi.Settings(device="cpu", intra_engine=True))
            for fr in parse_ivf(ivf)[3]:
                d.send_data(fr.data)
        finally:
            tapi.build_intra_frame = orig
        _FRAMES[name] = (box["seq"], box["fhdr"], box["coders"])
    return _FRAMES[name]


def subsampling(seq):
    return (1 if seq.layout != 3 else 0), (1 if seq.layout == 1 else 0)


def port_plan(name):
    seq, fhdr, coders = port_frame(name)
    bw, bh = coders[0].bw, coders[0].bh
    done = [np.zeros((bh, bw), np.int32) for _ in range(3)]
    plan = TI.IntraPlan()
    for c in coders:
        TI.build_intra_plan(seq, fhdr, c, done, plan)
    return plan


# (bit depth, ss_hor, ss_ver) groups: one jit of the JAX predictor each
GROUPS = {(8, 1, 1): ("dir_mix", "rect_odd", "fi", "palette", "mono"),
          (10, 1, 1): ("bd10",), (12, 1, 1): ("bd12",),
          (8, 0, 0): ("444",), (8, 1, 0): ("422", "ief")}
PAD_TO = 128


def _group_rows(names):
    rows = np.concatenate([port_plan(n).wave_rows()[0][0] for n in names])
    n = len(rows)
    pad = -n % PAD_TO     # a fixed batch multiple: few jit shapes
    return np.concatenate([rows, np.repeat(rows[-1:], pad, 0)]), n


def _inputs(rng, K, bd):
    hi = 1 << bd
    return (rng.integers(0, hi, (K, 130)).astype(np.int32),
            rng.integers(0, hi, (K, 130)).astype(np.int32),
            rng.integers(0, hi, (K, TP.TILE, TP.TILE)).astype(np.int32),
            rng.integers(0, hi, (K, 64, 64)).astype(np.int32))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("group", sorted(GROUPS),
                         ids=lambda g: "bd%d_ss%d%d" % g)
def test_pred_main_tile_matches_jax(group):
    bd, ssh, ssv = group
    rows, n = _group_rows(GROUPS[group])
    rng = np.random.default_rng(bd * 10 + ssh * 2 + ssv)
    ts, ls, own, luma = _inputs(rng, len(rows), bd)
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b, c, d, p: JP.pred_main_tile(a, b, c, d, p, bd, ssh,
                                                ssv)))(ts, ls, own, luma,
                                                       rows))
    got = TP.pred_main_tile(*_t(ts, ls, own, luma, rows), bd, ssh,
                            ssv).numpy()
    bad = np.nonzero((got != want).reshape(len(rows), -1).any(1))[0]
    assert not len(bad), (
        f"{len(bad)} of {n} units differ, modes "
        f"{sorted(set(rows[bad, TP.P_MODE].tolist()))}")


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_edge_build_matches_jax(bd):
    rows = np.concatenate([port_plan(n).wave_rows()[0][0] for n in CASES])
    rows = rows[:len(rows) - len(rows) % PAD_TO]
    rng = np.random.default_rng(bd)
    ts, ls, _, _ = _inputs(rng, len(rows), bd)
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b, p: JP.edge_build(a, b, p, bd)))(ts, ls, rows))
    got = TP.edge_build(*_t(ts, ls, rows), bd).numpy()
    np.testing.assert_array_equal(got, want)


def test_filter_and_upsample_edge_match_jax():
    """filter_edge_j / upsample_edge_j on random edges and random
    (size, limit, clip range, strength) arguments, every strength."""
    rng = np.random.default_rng(7)
    K = 256
    edge = rng.integers(0, 1024, (K, 257)).astype(np.int32)
    base = rng.integers(1, 200, K).astype(np.int32)
    sz = rng.integers(1, 64, K).astype(np.int32)
    lim_from = rng.integers(0, 8, K).astype(np.int32)
    lim_to = rng.integers(0, 72, K).astype(np.int32)
    frm = rng.integers(-2, 4, K).astype(np.int32)
    to = rng.integers(1, 64, K).astype(np.int32)
    strength = (np.arange(K) % 4).astype(np.int32)
    args = (base, sz, lim_from, lim_to, frm, to, strength)
    want = np.asarray(jax.jit(jax.vmap(
        lambda e, *a: JP.filter_edge_j(e, *a, 129)))(edge, *args))
    got = TP.filter_edge_j(*_t(edge, *args), 129).numpy()
    np.testing.assert_array_equal(got, want)
    for bd in (8, 10):
        want = np.asarray(jax.jit(jax.vmap(
            lambda e, b, hs, f, t: JP.upsample_edge_j(e, b, hs, f, t, bd,
                                                      129)))(
            edge, base, sz, frm, to))
        got = TP.upsample_edge_j(*_t(edge, base, sz, frm, to), bd,
                                 129).numpy()
        np.testing.assert_array_equal(got, want)


def test_pred_filter_cell_matches_jax():
    seq, _, coders = port_frame("fi")
    frows = port_plan("fi").wave_rows()[1][0]
    assert len(frows) > 0
    bw, bh = coders[0].bw, coders[0].bh
    Hp, Wp = bh * 4 + TP.PADT + TP.PAD, bw * 4 + TP.PADT + TP.PAD
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 256, (Hp, Wp)).astype(np.int32)
    predp = rng.integers(0, 256, (Hp, Wp)).astype(np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda p: JP.pred_filter_cell(plane, predp, p, 8)))(frows))
    got = TP.pred_filter_cell(*_t(plane, predp, frows), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["ief", "dir_mix"])
def test_family_subset_equals_the_full_select(name):
    """The scan computes only the mode families a wave uses
    (wave_families): on each wave that equals computing all of them."""
    seq, _, _ = port_frame(name)
    ssh, ssv = subsampling(seq)
    rows, offs = port_plan(name).wave_rows()[0]
    fams = TI.wave_families(rows, offs)
    rng = np.random.default_rng(1)
    ts, ls, own, luma = _t(*_inputs(rng, len(rows), seq.bitdepth))
    p = torch.from_numpy(rows)
    full = TP.pred_main_tile(ts, ls, own, luma, p, seq.bitdepth, ssh, ssv)
    for w in range(len(offs) - 1):
        a, b = offs[w], offs[w + 1]
        if b > a:
            sub = TP.pred_main_tile(ts[a:b], ls[a:b], own[a:b], luma[a:b],
                                    p[a:b], seq.bitdepth, ssh, ssv, fams[w])
            assert torch.equal(sub, full[a:b]), (w, fams[w])


def test_cases_cover_every_mode_and_edge_option():
    modes, layouts, bds = set(), set(), set()
    flags = dict.fromkeys(("P_US_ABOVE", "P_US_LEFT", "P_FS_ABOVE",
                           "P_FS_LEFT", "P_Z2TLF"), 0)
    for name in CASES:
        seq, _, _ = port_frame(name)
        rows = port_plan(name).wave_rows()[0][0]
        m = set(rows[:, TP.P_MODE].tolist())
        modes |= m
        if TP.CFL_MODE in m:
            layouts.add(seq.layout)
        bds.add(seq.bitdepth)
        for f in flags:
            flags[f] += int((rows[:, getattr(TP, f)] != 0).sum())
    assert modes == set(range(16)) - {TP.FILTER_PRED}, modes
    assert layouts == {1, 2, 3}, layouts     # CFL at 4:2:0, 4:2:2, 4:4:4
    assert bds == {8, 10, 12}
    assert all(flags.values()), flags
    assert len(port_plan("fi").wave_rows()[1][0]) > 0   # filter-intra
