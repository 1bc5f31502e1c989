"""The inverse transform's work lists on the CPU (the kernel itself runs
only on the card, where chip_smoke.py holds it to its plain version).

- the planner's tables (``models/frame_exec.ItxRun``, ``ops/itx.build_table``)
  hold, for every run of a frame's residual records, each record's tx
  size, plane, coefficient and selector offsets in the right buffer (int16
  or int32), origins, real rows (pad rows not counted), the CTA starts and
  the work-item map (the longest items first), and the hres offsets: on the tools
  stream's frames (compound, OBMC; no WHT), a lossless stream's (WHT) and
  an engine-route frame's (raw);
- the plain work-list function ``ops/itx.itx_run`` (and the wrapper's CPU
  route) equals the per-bucket ``itx_bucket`` calls and the JAX package's
  numpy path (``_residual_multi_core``/``_residual_core`` with xp=np and
  ``ops/mc_tpu.scatter_add_units``/``scatter_units``) on runs that mix
  every tx size, WHT, dense tails, int16 and int32 coefficients and
  positions, pad rows and units cut by the planes' edges, at bd 8/10/12
  in the three modes;
- the wrapper sends a CPU work list to the plain version and refuses
  other devices; the executor refuses residual records without their
  work list; a run's hres views download with one host copy.
Tolerance: exact."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import torch_streams as ts  # noqa: E402
from dav1d_mirror_tpu.ops import itx as jitx  # noqa: E402
from dav1d_mirror_tpu.ops import mc_tpu  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
from dav1d_mirror_tpu_torch.ops import itx as titx  # noqa: E402
from dav1d_mirror_tpu_torch.ops import itx_cuda  # noqa: E402
from dav1d_mirror_tpu_torch.ops.itx_meta import (TX_INFO, WHT_WHT,  # noqa
                                                 allowed_txtypes)
from dav1d_mirror_tpu_torch.ops.mc import PAD_OOB  # noqa: E402

STREAMS = Path(__file__).parent / "streams"
# record kind -> positions of (plane, tx, fixed type, vals, pos, row sel,
# col sel, ys, xs) in the record (None: absent), as the planners emit them
LAYOUT = {"residc": (1, 4, 5, 6, 7, None, None, 8, 9),
          "residmc": (1, 4, None, 5, 6, 7, 8, 9, 10),
          "hresc": (None, 1, 2, 5, 6, None, None, None, None),
          "hresmc": (None, 1, None, 4, 5, 6, 7, None, None),
          "resrawc": (1, 2, 3, 6, 7, None, None, 8, 9),
          "resrawmc": (1, 4, None, 5, 6, 7, 8, 9, 10)}


def _programs(data, **settings):
    """(sig, desc, desc16) of every program a CPU decode of `data` runs."""
    seen = []
    orig = tfe.execute_program

    def spy(sig, desc, desc16, desc8, refsrc):
        seen.append((sig, desc.numpy().copy(), desc16.numpy().copy()))
        return orig(sig, desc, desc16, desc8, refsrc)
    tfe.execute_program = spy
    try:
        dec = tapi.Decoder(tapi.Settings(device="cpu", apply_grain=False,
                                         **settings))
        for fr in parse_ivf(data)[3]:
            dec.send_data(fr.data)
            while dec.get_picture() is not None:
                pass
        dec.drain()
        while dec.get_picture() is not None:
            pass
    finally:
        tfe.execute_program = orig
    return seen


def _runs(ops):
    """[(residual records, itxrun record)] of a program, checking that each
    run's records are consecutive and followed by its itxrun."""
    runs, cur = [], []
    for rec in ops:
        if rec[0] in tfe.RESID_KINDS:
            cur.append(rec)
        elif rec[0] == "itxrun":
            runs.append((cur, rec))
            cur = []
        else:
            assert not cur, f"{rec[0]} inside a run"
    assert not cur
    return runs


def _buf(desc, desc16, h):
    """(flat buffer, offset, shape, narrow) of a descriptor handle."""
    return (desc16, h[0], h[1], True) if len(h) == 3 else \
        (desc, h[0], h[1], False)


def _check_tables(sig, desc, desc16):
    """Every run's table against its records. Returns {mode: entries}."""
    seen = {}
    for recs, (_, mode, h_tab, work, views) in _runs(sig[0]):
        n, n_items = work
        assert n == len(recs) and n > 0
        assert {tfe.RESID_KINDS[r[0]] for r in recs} == {mode}
        assert len(h_tab) == 2, "the table rides the int32 buffer"
        tab = desc[h_tab[0]:h_tab[0] + h_tab[1][0]]
        assert len(tab) == n * titx.ENTRY + n_items
        ents = tab[:n * titx.ENTRY].reshape(n, titx.ENTRY).tolist()
        items, hoff, vi = {}, 0, 0
        for i, (rec, e) in enumerate(zip(recs, ents)):
            pl_i, tx_i, tp_i, v_i, p_i, rs_i, cs_i, ys_i, xs_i = \
                LAYOUT[rec[0]]
            tx = rec[tx_i]
            w, h, _ = TX_INFO[tx]
            S = min(w, 32) * min(h, 32)
            vb, voff, (B, K), v16 = _buf(desc, desc16, rec[v_i])
            pb, poff, pshape, p16 = _buf(desc, desc16, rec[p_i])
            assert pshape == (B, K)
            assert (e[titx.E_TX], e[titx.E_PLANE], e[titx.E_K],
                    e[titx.E_B], e[titx.E_VALS], e[titx.E_POS]) == \
                (tx, 0 if pl_i is None else rec[pl_i], K, B, voff, poff)
            flags = (titx.F_VALS16 if v16 else 0) | \
                (titx.F_POS16 if p16 else 0)
            if tp_i is not None:
                assert rec[tp_i] == WHT_WHT and tx == 0
                flags |= titx.F_WHT | titx.F_FIXED
            else:
                for f, j in ((titx.E_RSEL, rs_i), (titx.E_CSEL, cs_i)):
                    assert len(rec[j]) == 2 and rec[j][1] == (B,)
                    assert e[f] == rec[j][0]
            assert e[titx.E_FLAGS] == flags
            vals = vb[voff:voff + B * K].reshape(B, K)
            pos = pb[poff:poff + B * K].reshape(B, K)
            n_real = e[titx.E_NREAL]
            if mode == "hres":
                # pad rows: zero coefficients at the dropped position
                assert not vals[n_real:].any() and (pos[n_real:] == S).all()
                # the planner pads B to a power of two, at least 8
                assert B == max(8, 1 << max(n_real - 1, 0).bit_length())
                assert vals[:n_real].any(axis=1).all()
                assert e[titx.E_HRES] == hoff and \
                    views[vi] == (hoff, B, h, w)
                hoff += B * h * w
                vi += 1
            else:
                for f, j in ((titx.E_YS, ys_i), (titx.E_XS, xs_i)):
                    assert len(rec[j]) == 2 and rec[j][1] == (B,)
                    assert e[f] == rec[j][0]
                ys = desc[rec[ys_i][0]:rec[ys_i][0] + B]
                real = ys != PAD_OOB
                assert n_real == int(real.sum()) and real[:n_real].all()
                if mode == "raw":
                    assert n_real == B
            rows = B if mode == "hres" else n_real
            items[i] = (titx.item_order(tx, K), e[titx.E_CTA0],
                        -(-rows // titx.cta_geometry(tx)[1]))
        # each entry's items together at its CTA start, longest first
        order = sorted(items, key=lambda i: (items[i][0], i))
        want, start = [], 0
        for i in order:
            assert items[i][1] == start
            want += [i] * items[i][2]
            start += items[i][2]
        assert n_items == start and list(tab[n * titx.ENTRY:]) == want
        assert mode == "hres" or views == ()
        seen.setdefault(mode, []).extend(ents)
    return seen


@pytest.fixture(scope="module")
def tools_programs():
    _, data, _ = ts.build_tools_stream(dict(ts.TOOLS, w=128, h=64,
                                            n_inter=3), 9)
    return _programs(data)


def test_planner_tables_tools_stream(tools_programs):
    """Compound, OBMC and inter-intra frames: clip-add runs on every inter
    frame, hres runs, no WHT."""
    modes = {}
    for sig, desc, desc16 in tools_programs:
        kinds = {op[0] for op in sig[0]}
        if "comp" in kinds or "obmc" in kinds:
            assert "itxrun" in kinds
        for mode, ents in _check_tables(sig, desc, desc16).items():
            modes.setdefault(mode, []).extend(ents)
    assert {"add", "hres"} <= set(modes)
    ents = [e for v in modes.values() for e in v]
    assert not any(e[titx.E_FLAGS] & titx.F_WHT for e in ents)
    assert any(e[titx.E_FLAGS] & titx.F_VALS16 for e in ents)  # 8 bpc


def test_planner_tables_lossless_and_engine():
    """WHT entries from a lossless stream (both routes), raw runs from the
    engine route, int32 coefficients at 10 bit."""
    lossless = (ts.DIR / "lossless_128x64.ivf").read_bytes()
    flags, modes = set(), set()
    for data, engine in ((lossless, False), (lossless, True),
                         ((STREAMS / "intra_444_10bit.ivf").read_bytes(),
                          True)):
        for sig, desc, desc16 in _programs(data, intra_engine=engine):
            for mode, ents in _check_tables(sig, desc, desc16).items():
                modes.add((mode, engine))
                flags |= {e[titx.E_FLAGS] for e in ents}
    assert ("raw", True) in modes and ("add", False) in modes
    assert any(f & titx.F_WHT for f in flags)
    assert any(not f & titx.F_VALS16 for f in flags)


# ---------------------------------------------------------------------
# the plain work list against the per-bucket calls and the JAX package
# ---------------------------------------------------------------------
EXTREMES32 = (-(1 << 31), (1 << 31) - 1, -(1 << 19), (1 << 19) - 1)
EXTREMES16 = (-32768, 32767)
W_PLANE = 160


def _synthetic_run(mode, bd, seed, narrow_planes=False):
    """A run of buckets as a planner emits them: every tx size (sparse,
    K = 16), a WHT 4x4 bucket and dense tails (one block with every
    coefficient set), each of 3 real blocks and 1 pad row, over three
    planes. vals ride the int16 buffer where they fit (bd 8, every other
    bucket), pos the int16 or int32 one by turns. Each bucket's units lie
    in a band of its plane, the third cut by the right edge, the last
    band of each plane cut by the bottom edge. Returns (prog, buckets,
    plane shapes): buckets [(pl, tx, cf (B, sh, sw), sel or WHT_WHT,
    ys, xs, n_real)]."""
    rng = np.random.default_rng(seed)
    specs = [(tx, "sparse") for tx in range(19)] + \
        [(0, "wht"), (3, "dense"), (5, "dense"), (17, "dense")]
    band = [0, 0, 0]
    placed = []
    for i, (tx, kind) in enumerate(specs):
        pl = i % 3
        placed.append((pl, band[pl]))
        band[pl] += TX_INFO[tx][1]
    last = {pl: max(i for i, (p, _) in enumerate(placed) if p == pl)
            for pl in range(3)}
    shapes = [(band[pl] - TX_INFO[specs[last[pl]][0]][1] // 2, W_PLANE)
              for pl in range(3)]
    prog = tfe.FrameProgram(3, bd, shapes)
    amp = 900 << (bd - 8)
    buckets = []
    with tfe.ItxRun(prog, mode) as run:
        for i, ((tx, kind), (pl, y0)) in enumerate(zip(specs, placed)):
            w, h, _ = TX_INFO[tx]
            sh, sw = min(h, 32), min(w, 32)
            S = sh * sw
            B, n_real = 4, 3
            cf = np.zeros((B, S), np.int64)
            for b in range(n_real):
                nz = int(rng.integers(1, min(16, S) + 1))
                cf[b, rng.choice(S, nz, replace=False)] = \
                    rng.integers(1, amp, nz) * rng.choice([-1, 1], nz)
            narrow = bd == 8 and i % 2 == 0
            ext = EXTREMES16 if narrow else EXTREMES32
            if kind == "dense":
                v = rng.integers(-amp, amp, S)
                v[v == 0] = 1
                cf[1] = v
            cf[2, rng.choice(S, 2, replace=False)] = rng.choice(ext, 2)
            cf = cf.astype(np.int32).reshape(B, sh, sw)
            vals, pos, K = tfe.compact_cf(cf)
            Kp = 1 << (K - 1).bit_length()
            vals = np.pad(vals, ((0, 0), (0, Kp - K)))
            pos = np.pad(pos, ((0, 0), (0, Kp - K)), constant_values=S)
            h_v = prog.emit16(vals) if narrow else prog.emit(vals)
            h_p = prog.emit16(pos) if i % 3 != 1 else prog.emit(pos)
            ys = np.array([y0, y0, y0, PAD_OOB], np.int32)
            xs = np.array([0, w, W_PLANE - w // 2, 0], np.int32)
            if kind == "wht":
                sel = WHT_WHT
            else:
                types = [t for t in allowed_txtypes(tx) if t != WHT_WHT]
                sel = np.array([titx.itx_multi_sel(
                    tx, types[int(rng.integers(len(types)))])
                    for _ in range(B)], np.int32)
            if mode == "hres":
                if kind == "wht":
                    run.op("hresc", tx, WHT_WHT, sh, sw, h_v, h_p,
                           n_real=n_real)
                else:
                    run.op("hresmc", tx, sh, sw, h_v, h_p,
                           prog.emit(sel[:, 0]), prog.emit(sel[:, 1]),
                           n_real=n_real)
            else:
                h_ys, h_xs = prog.emit(ys), prog.emit(xs)
                c, mc = ("residc", "residmc") if mode == "add" else \
                    ("resrawc", "resrawmc")
                if kind == "wht":
                    rec = (c, pl, sh, sw, tx, WHT_WHT, h_v, h_p, h_ys, h_xs)
                    if mode == "raw":
                        rec = (c, pl, tx, WHT_WHT, sh, sw, h_v, h_p, h_ys,
                               h_xs)
                else:
                    rec = (mc, pl, sh, sw, tx, h_v, h_p,
                           prog.emit(sel[:, 0]), prog.emit(sel[:, 1]),
                           h_ys, h_xs)
                run.op(*rec, n_real=n_real)
            buckets.append((pl, tx, cf, sel, ys, xs, n_real))
    return prog, buckets, shapes


def _jax_residuals(cf, sel, tx, bd):
    if isinstance(sel, int):
        return np.asarray(jitx._residual_core(cf, tx, WHT_WHT, bd, np))
    return np.asarray(jitx._residual_multi_core(cf, sel[:, 0], sel[:, 1], tx,
                                                bd, np))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("mode", ["add", "raw", "hres"])
def test_plain_run_matches_buckets_and_jax(mode, bd):
    prog, buckets, shapes = _synthetic_run(mode, bd, 7 * bd + len(mode))
    sig, desc, desc16, _ = prog.finalize()
    (_, _, h_tab, work, views), = [r for r in sig[0] if r[0] == "itxrun"]
    assert work[0] == len(buckets) and work[1] > 0
    t = torch.from_numpy
    desc_t, desc16_t = t(desc), t(desc16)
    tab = desc_t[h_tab[0]:h_tab[0] + h_tab[1][0]]
    rng = np.random.default_rng(bd)
    hres_dt = torch.int16 if bd == 8 else torch.int32
    dts = (np.int32,) if mode == "hres" else \
        (np.int32, np.uint8 if bd == 8 else np.int16)
    res = [_jax_residuals(cf, sel, tx, bd)
           for _, tx, cf, sel, _, _, _ in buckets]
    for dt in dts:
        planes = [rng.integers(0, 1 << bd, s).astype(dt) for s in shapes]
        # the per-bucket calls on every row, pad rows included
        per_bucket = [t(p.copy()) for p in planes]
        for (pl, tx, cf, sel, ys, xs, _), r in zip(buckets, res):
            vals, pos, _ = tfe.compact_cf(cf)
            tsel = sel if isinstance(sel, int) else \
                (t(sel[:, 0].copy()), t(sel[:, 1].copy()))
            if mode == "hres":
                got = titx.itx_bucket("hres", t(vals), t(pos), tsel, tx, bd,
                                      out_dtype=hres_dt)
                assert torch.equal(got, t(r).to(hres_dt))
            else:
                titx.itx_bucket(mode, t(vals), t(pos), tsel, tx, bd,
                                per_bucket[pl], t(ys), t(xs))
        if dt is np.int32 and mode != "hres":
            # the JAX package's scatters (the narrow planes' through the
            # per-bucket calls, held to them in test_torch_itx_kernel.py)
            want = [jnp.asarray(p) for p in planes]
            for (pl, tx, _, _, ys, xs, _), r in zip(buckets, res):
                w, h, _ = TX_INFO[tx]
                args = (want[pl], jnp.asarray(r), jnp.asarray(ys),
                        jnp.asarray(xs), h, w)
                want[pl] = mc_tpu.scatter_add_units(*args, bd) \
                    if mode == "add" else mc_tpu.scatter_units(*args)
            for pb, wnt in zip(per_bucket, want):
                assert torch.equal(pb, t(np.array(wnt)))
        # the plain work list, and the wrapper's CPU route on int32 planes
        fns = (titx.itx_run, itx_cuda.itx_run) if dt is np.int32 else \
            (titx.itx_run,)
        for fn in fns:
            got_planes = [t(p.copy()) for p in planes]
            out = fn(mode, tab, work, desc_t, desc16_t, bd,
                     got_planes if mode != "hres" else (), views, hres_dt)
            if mode == "hres":
                assert len(out) == len(res)
                for o, r in zip(out, res):
                    assert o.dtype == hres_dt
                    assert torch.equal(o, t(r).to(hres_dt))
                assert out[0]._base is out[-1]._base   # one flat output
            else:
                assert out is None
                for g, pb in zip(got_planes, per_bucket):
                    assert torch.equal(g, pb)


def test_wrapper_routes_cpu_to_plain_and_refuses_other_devices():
    prog, _, shapes = _synthetic_run("add", 10, 5)
    sig, desc, desc16, _ = prog.finalize()
    (_, _, h_tab, work, views), = [r for r in sig[0] if r[0] == "itxrun"]
    t = torch.from_numpy
    tab = t(desc)[h_tab[0]:h_tab[0] + h_tab[1][0]]
    planes = [torch.zeros(s, dtype=torch.int32) for s in shapes]
    n, n_e = itx_cuda.ITX_LAUNCHES, itx_cuda.ITX_ENTRIES
    itx_cuda.itx_run("add", tab, work, t(desc), t(desc16), 10, planes)
    assert any(p.any() for p in planes)
    assert (itx_cuda.ITX_LAUNCHES, itx_cuda.ITX_ENTRIES) == (n, n_e)
    with pytest.raises(ValueError):
        itx_cuda.itx_run("add", tab.to("meta"), work, t(desc).to("meta"),
                         t(desc16).to("meta"), 10,
                         [p.to("meta") for p in planes])
    with pytest.raises(ValueError):
        titx.itx_run("sub", tab, work, t(desc), t(desc16), 10, planes)


def test_executor_refuses_records_without_their_work_list():
    prog, _, _ = _synthetic_run("raw", 8, 3)
    sig = prog.finalize()[0]
    ops = sig[0]
    z = torch.zeros(1, dtype=torch.int32)
    for bad in ([r for r in ops if r[0] != "itxrun"],      # no work list
                [r for r in ops if r[0] != "resrawc"],     # one entry short
                ops[-1:] + ops[:-1]):                      # list first
        with pytest.raises(ValueError, match="residual records|itxrun"):
            tfe.execute_program((tuple(bad),) + sig[1:], z,
                                z.to(torch.int16), z.to(torch.int8), ())


def test_hres_views_download_in_one_copy():
    flat, views = titx.hres_flat(((0, 2, 4, 8), (64, 4, 8, 4)), torch.int16,
                                 "cpu")
    flat.copy_(torch.arange(flat.numel(), dtype=torch.int16))
    other = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    got = tfe.download_views(views + [other])
    for g, v in zip(got, views + [other]):
        np.testing.assert_array_equal(g, v.numpy())
    assert got[0].base is not None and got[0].base is got[1].base
