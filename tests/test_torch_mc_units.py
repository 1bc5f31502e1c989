"""Unit MC with its destination write (dav1d_mirror_tpu_torch/ops/mc.py
mc_units_plane / mc_units_slots / mc_scaled_plane / mc_scaled_slots, the
plain versions of csrc/mc_units.cu and csrc/mc_scaled.cu, and the CPU
route of their wrappers in ops/mcu_cuda.py) against the JAX package's
composition on the same seeded numpy inputs: mc_tpu.mc_unit_batch with
scatter_units or set_slots, mc_tpu.mc_scaled_batch with scatter_units or
scatter_slot_units. Bit depths 8/10/12, the four (has_h, has_v) cases,
put and prep, every Filter2d, units 2x2 to 128x128, window origins far
outside the reference, units cut by the plane's edge, PAD_OOB and OOB16
pad rows, duplicate slots, scaled steps 512-2048 with subpel-0 columns
and rows. Tolerance: exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dav1d_mirror_tpu.ops import mc_tpu as jmc
from dav1d_mirror_tpu_torch.models.frame_exec import OOB16
from dav1d_mirror_tpu_torch.ops import mc, mcu_cuda
from dav1d_mirror_tpu_torch.tools.mcu_cases import (
    grid_origins as _dst, pad_dup as _pad_dup, scaled_rows, slot_bases,
    unit_rows)

BDS = [8, 10, 12]
CASES = [(0, 0), (1, 0), (0, 1), (1, 1)]
# (uw, uh): chroma 2-wide and 2-tall, non-square, whole 128x128 blocks;
# each test takes two of them by its index, so all are covered
UNITS = [(2, 2), (8, 8), (2, 4), (16, 4), (4, 2), (8, 32), (4, 4),
         (32, 32), (2, 8), (64, 16), (4, 16), (128, 128)]
PARAMS = [(bd, hh, hv, prep) for bd in BDS for hh, hv in CASES
          for prep in (False, True)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _units(i):
    return UNITS[i % len(UNITS)], UNITS[(i + 5) % len(UNITS)]


def _refs(rng, bd, r=3, h=48, w=72):
    return rng.integers(0, 1 << bd, (r, h, w)).astype(np.int32)


def _jax_units(refs, arr, uw, uh, hh, hv, bd, prep):
    return jmc.mc_unit_batch((jnp.asarray(refs),) + tuple(
        jnp.asarray(arr[:, i]) for i in range(6)), uw, uh, bool(hh),
        bool(hv), bd, prep)


@pytest.mark.parametrize("i,bd,hh,hv,prep", [
    (i,) + p for i, p in enumerate(PARAMS)])
def test_units_plane_matches_jax(i, bd, hh, hv, prep):
    rng = np.random.default_rng(100 + i)
    refs = _refs(rng, bd)
    for uw, uh in _units(i):
        H, W = 3 * uh + uh // 2 + 1, 3 * uw + uw // 2 + 1
        plane = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
        n = min(12, (H // uh + 1) * (W // uw + 1)) + 2
        arr = _pad_dup(unit_rows(rng, n - 2, refs.shape, uw, uh))
        ys, xs = _dst(rng, n, uw, uh, H, W)
        units = _jax_units(refs, arr, uw, uh, hh, hv, bd, prep)
        want = np.asarray(jmc.scatter_units(jnp.asarray(plane), units,
                                     jnp.asarray(ys), jnp.asarray(xs),
                                     uh, uw))
        got = mc.mc_units_plane(_t(plane.copy()), _t(refs), _t(arr), _t(ys),
                                _t(xs), uw, uh, bool(hh), bool(hv), bd, prep)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), (uw, uh)


@pytest.mark.parametrize("hh,hv", CASES)
def test_units_plane_int16_descriptors_and_oob16(hh, hv):
    """The put record's form: every column int16 views, pad rows at
    OOB16 (the JAX executor widens them to PAD_OOB)."""
    rng = np.random.default_rng(7 + 2 * hh + hv)
    refs = _refs(rng, 10)
    uw, uh = 8, 4
    H, W = 30, 45
    arr = _pad_dup(unit_rows(rng, 14, refs.shape, uw, uh), 4)
    ys, xs = _dst(rng, 18, uw, uh, H, W)
    ys[-4:] = mc.PAD_OOB
    xs[-4:] = xs[-5]
    plane = np.zeros((H, W), np.int32)
    want = np.asarray(jmc.scatter_units(
        jnp.asarray(plane), _jax_units(refs, arr, uw, uh, hh, hv, 10, False),
        jnp.asarray(ys), jnp.asarray(xs), uh, uw))
    ys16 = np.where(ys == mc.PAD_OOB, OOB16, ys).astype(np.int16)
    got = mcu_cuda.mc_units_plane(
        _t(plane.copy()), _t(refs), _t(arr.astype(np.int16)), _t(ys16),
        _t(xs.astype(np.int16)), uw, uh, bool(hh), bool(hv), 10)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("i,bd,hh,hv,prep", [
    (i,) + p for i, p in enumerate(PARAMS)])
def test_units_slots_match_jax(i, bd, hh, hv, prep):
    """Whole-slot units: N slots, the real units in some of them, pad
    rows repeating the last one (same slot, same values)."""
    rng = np.random.default_rng(300 + i)
    refs = _refs(rng, bd, h=40, w=150)
    for uw, uh in _units(i + 3):
        N = 8
        buf = rng.integers(-100, 100, (N, uh, uw)).astype(np.int32)
        arr = _pad_dup(unit_rows(rng, 5, refs.shape, uw, uh), 3)
        slots = _pad_dup(rng.permutation(N - 1)[:5].astype(np.int32), 3)
        units = _jax_units(refs, arr, uw, uh, hh, hv, bd, prep)
        want = np.asarray(jmc.set_slots(jnp.asarray(buf), jnp.asarray(slots),
                                 units))
        got = mc.mc_units_slots(_t(buf.copy()), _t(refs), _t(arr),
                                _t(slots), bool(hh), bool(hv), bd, prep)
        assert np.array_equal(got.numpy(), want), (uw, uh)


SCALED_UNITS = [(8, 8), (2, 2), (4, 8), (8, 4), (64, 32)]


def _jax_scaled(refs, rows, uw, uh, bd, prep):
    return jmc.mc_scaled_batch(jnp.asarray(refs), jnp.asarray(rows), uw, uh,
                               2 * uw + 10, 2 * uh + 10, bd, prep)


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("prep", [False, True])
def test_scaled_plane_matches_jax(bd, prep):
    rng = np.random.default_rng(500 + bd + prep)
    refs = _refs(rng, bd, r=2, h=60, w=90)
    units = SCALED_UNITS if not prep else SCALED_UNITS[:4]
    for uw, uh in units:
        H, W = 3 * uh + 1, 4 * uw + 3
        plane = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
        n = min(14, (H // uh + 1) * (W // uw + 1)) + 2
        rows = _pad_dup(scaled_rows(rng, n - 2, refs.shape, uw, uh))
        ys, xs = _dst(rng, n, uw, uh, H, W)
        want = np.asarray(jmc.scatter_units(
            jnp.asarray(plane), _jax_scaled(refs, rows, uw, uh, bd, prep),
            jnp.asarray(ys), jnp.asarray(xs), uh, uw))
        got = mc.mc_scaled_plane(_t(plane.copy()), _t(refs), _t(rows),
                                 _t(ys), _t(xs), uw, uh, bd, prep)
        assert np.array_equal(got.numpy(), want), (uw, uh)


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("prep", [False, True])
def test_scaled_slots_match_jax(bd, prep):
    """Sub-rect writes at flat offsets of an (N, bhp, bwp) slot buffer
    (compound sides: 8x8 sub-units of a block's slot) and whole-slot
    writes (OBMC laps), pad rows repeating the last unit."""
    rng = np.random.default_rng(700 + bd + prep)
    refs = _refs(rng, bd, r=1, h=50, w=70)
    for (bwp, bhp), (uw, uh) in (((16, 16), (8, 8)), ((32, 8), (8, 8)),
                                 ((4, 8), (4, 8)), ((8, 2), (8, 2))):
        N = 4
        buf = np.zeros((N, bhp, bwp), np.int32)
        base = _pad_dup(slot_bases(N, bwp, bhp, uw, uh))
        rows = _pad_dup(scaled_rows(rng, len(base) - 2, refs.shape, uw, uh))
        want = np.asarray(jmc.scatter_slot_units(
            jnp.asarray(buf), jnp.asarray(base),
            _jax_scaled(refs, rows, uw, uh, bd, prep), uh, uw, bwp))
        got = mc.mc_scaled_slots(_t(buf.copy()), _t(refs), _t(rows),
                                 _t(base), uw, uh, bd, prep)
        assert np.array_equal(got.numpy(), want), (bwp, bhp, uw, uh)


def test_scaled_reads_a_strided_reference_view():
    """A scaled reference is the crop refsrc[:h, :w] of a wider plane: the
    plain route reads it as the contiguous copy reads it."""
    rng = np.random.default_rng(9)
    full = _t(rng.integers(0, 256, (40, 64)).astype(np.int32))
    view = full[:30, :50][None]
    rows = _t(scaled_rows(rng, 8, view.numpy().shape, 8, 8))
    rows[:, 0] = 0
    ys = _t(np.arange(8, dtype=np.int32) // 4 * 8)
    xs = _t(np.arange(8, dtype=np.int32) % 4 * 8)
    a = mcu_cuda.mc_scaled_plane(torch.zeros((16, 32), dtype=torch.int32),
                                 view, rows, ys, xs, 8, 8, 8)
    b = mc.mc_scaled_plane(torch.zeros((16, 32), dtype=torch.int32),
                           view.contiguous(), rows, ys, xs, 8, 8, 8)
    assert torch.equal(a, b)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    rng = np.random.default_rng(11)
    refs = _refs(rng, 8)
    arr = _t(unit_rows(rng, 6, refs.shape, 4, 4))
    ys = _t(np.array([0, 0, 4, 4, mc.PAD_OOB, 8], np.int32))
    xs = _t(np.array([0, 4, 0, 4, 0, 8], np.int32))
    slots = _t(np.array([0, 1, 2, 2, 3, 3], np.int32))
    srows = _t(scaled_rows(rng, 6, refs.shape, 4, 4))
    base = _t(np.arange(6, dtype=np.int32) * 16)
    refs = _t(refs)
    n0 = (mcu_cuda.UNITS_LAUNCHES, mcu_cuda.SCALED_LAUNCHES)
    zp = lambda: torch.zeros((12, 12), dtype=torch.int32)   # noqa: E731
    zs = lambda: torch.zeros((7, 4, 4), dtype=torch.int32)  # noqa: E731
    for wrapped, plain, args in (
            (mcu_cuda.mc_units_plane, mc.mc_units_plane,
             (refs, arr, ys, xs, 4, 4, True, True, 8)),
            (mcu_cuda.mc_units_slots, mc.mc_units_slots,
             (refs, arr, slots, True, False, 10, True)),
            (mcu_cuda.mc_scaled_plane, mc.mc_scaled_plane,
             (refs, srows, ys, xs, 4, 4, 12)),
            (mcu_cuda.mc_scaled_slots, mc.mc_scaled_slots,
             (refs, srows, base, 4, 4, 8, True))):
        zero = zp if wrapped.__name__.endswith("plane") else zs
        assert torch.equal(wrapped(zero(), *args), plain(zero(), *args))
    # the counters count kernel launches only
    assert (mcu_cuda.UNITS_LAUNCHES, mcu_cuda.SCALED_LAUNCHES) == n0


def test_wrappers_refuse_other_devices():
    def m(*shape):
        return torch.zeros(shape, dtype=torch.int32, device="meta")
    refs, arr, col = m(1, 8, 8), m(4, 6), m(4)
    with pytest.raises(ValueError):
        mcu_cuda.mc_units_plane(m(8, 8), refs, arr, col, col, 4, 4, True,
                                True, 8)
    with pytest.raises(ValueError):
        mcu_cuda.mc_units_slots(m(2, 4, 4), refs, arr, col, False, True, 8,
                                True)
    with pytest.raises(ValueError):
        mcu_cuda.mc_scaled_plane(m(8, 8), refs, m(4, 9), col, col, 4, 4, 8)
    with pytest.raises(ValueError):
        mcu_cuda.mc_scaled_slots(m(2, 4, 4), refs, m(4, 9), col, 4, 4, 8,
                                 True)


def _branch_program(rng, bd):
    """A one-plane program with every record the unit MC kernels run:
    three put buckets (copy, H, V; int16 descriptors, OOB16 pad rows), a
    scaled bucket, a compound block batch whose sides are a "t" and an
    "s" sub-op, and an OBMC lap batch of the same two, gathered into the
    frame's two work lists by McRun. The scaled reference is an int32
    crop of a wider plane (a strided view)."""
    from dav1d_mirror_tpu_torch.models.frame_exec import (
        FrameProgram, McRun, pack_put_case)
    H, W = 32, 48
    dt = np.uint8 if bd == 8 else np.uint16
    ref = rng.integers(0, 1 << bd, (H, W)).astype(dt)
    sref = rng.integers(0, 1 << bd, (2 * H, 2 * W + 6)).astype(np.int32)
    prog = FrameProgram(1, bd, [(H, W)],
                        refspec=[((H, W), (0,) + (-1,) * 6)],
                        srefspec=[(1, 2 * H - 5, 2 * W - 3)])
    run = McRun(prog)
    for k, (uw, uh, hh, hv) in enumerate(((8, 8, 0, 0), (8, 4, 1, 0),
                                          (4, 8, 0, 1))):
        arr = unit_rows(rng, 6, (1, H, W), uw, uh)
        ys, xs = _dst(rng, 8, uw, uh, H, W)
        pack_put_case(prog, 0, (uw, uh, hh, hv), np.concatenate(
            [_pad_dup(arr), ys[:, None], xs[:, None]], 1), run)
    rows = _pad_dup(scaled_rows(rng, 6, sref[None].shape, 8, 8))
    rows[:, 0] = 0
    ys, xs = _dst(rng, 8, 8, 8, H, W)
    run.op("scaled", 0, 0, 8, 8, prog.emit(rows), prog.emit(ys),
           prog.emit(xs), n_real=6)

    def sides(N, bwp, bhp, uw, uh, hh, hv):
        """A "t" sub-op into slots 0..N-2 and an "s" sub-op into their
        (uw, uh) sub-rects, pad rows repeating the last."""
        arr = _pad_dup(unit_rows(rng, N - 1, (1, H, W), bwp, bhp),
                       8 - (N - 1))
        sl = _pad_dup(np.arange(N - 1, dtype=np.int32), 8 - (N - 1))
        base = slot_bases(N, bwp, bhp, uw, uh)
        srows = scaled_rows(rng, len(base), sref[None].shape, uw, uh)
        srows[:, 0] = 0
        return (("t", bool(hh), bool(hv), prog.emit(arr), prog.emit(sl)),
                ("s", 0, uw, uh, prog.emit(srows), prog.emit(base)),
                (N - 1, len(base)))
    t, s, (nt, ns) = sides(4, 8, 8, 8, 8, 1, 1)
    t2, s2, n2 = sides(4, 8, 8, 4, 4, 0, 1)
    sl = np.arange(8, dtype=np.int32) % 3
    run.op("comp", 0, 8, 8, 4, ((t,), (s,)),
           (("wavg", prog.emit(sl), prog.emit(np.full(8, 8, np.int32))),),
           1, 1, prog.emit(np.array([0, 8, 16, mc.PAD_OOB], np.int32)),
           prog.emit(np.array([40, 40, 40, 0], np.int32)),
           n_real=((nt,), (ns,)))
    run.op("obmc", 0, 8, 8, 8, False, 4, (t2, s2),
           prog.emit(np.array([24, 24, 0, mc.PAD_OOB], np.int32)),
           prog.emit(np.array([0, 8, 24, 0], np.int32)), n_real=n2)
    run.close()
    return prog, (ref, sref)


@pytest.mark.parametrize("bd", [10])
def test_executor_branches_match_jax_interpreter(bd, monkeypatch):
    """The executor runs the program's put, scaled, t and s work through
    the unit MC run wrappers, one call of each a frame (its 3 puts and 2
    "t" sub-ops in one list, its scaled record and 2 "s" sub-ops in the
    other; no one-bucket call), and the program's planes equal the JAX
    interpreter's."""
    from dav1d_mirror_tpu.models import frame_exec as jfe
    from dav1d_mirror_tpu_torch.models import frame_exec as tfe
    rng = np.random.default_rng(40 + bd)
    prog, refsrc = _branch_program(rng, bd)
    sig, desc, desc16, desc8 = prog.finalize()
    calls = {}
    for name in ("mc_units_plane", "mc_units_slots", "mc_scaled_plane",
                 "mc_scaled_slots", "mc_units_run", "mc_scaled_run"):
        def spy(*a, _fn=getattr(mcu_cuda, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mcu_cuda, name, spy)
    args = tfe.frame_program_to_torch(desc, desc16, desc8, refsrc, "cpu")
    assert args[3][1][:2 * 32 - 5, :2 * 48 - 3].stride(0) == 2 * 48 + 6
    planes, _ = tfe.execute_program(sig, *args)
    j_planes, _ = jfe._interpreter(sig)(desc, desc16, desc8, refsrc)
    assert calls == {"mc_units_run": 1, "mc_scaled_run": 1}
    runs = {r[0]: r[2] for r in sig[0] if r[0] in ("mcurun", "mcsrun")}
    assert (runs["mcurun"][0], runs["mcsrun"][0]) == (5, 3)
    assert np.array_equal(planes[0].numpy(), np.asarray(j_planes[0]))
    assert planes[0].abs().sum() > 0


def _read_pixels(kind, dst, args, uw, uh):
    """The (ref, row, col) reference pixels the real units' nonzero taps
    read, by a loop over every output and tap."""
    R, H, W = args[0].shape
    desc = args[1].numpy().astype(np.int64)
    if kind in ("put", "scaled"):
        ys, xs = (a.numpy().astype(np.int64) for a in args[2:4])
        real = [min(y + uh, dst.shape[0]) > max(y, 0) and
                min(x + uw, dst.shape[1]) > max(x, 0) for y, x in zip(ys, xs)]
    else:
        real = np.zeros(len(desc), bool)
        real[np.unique(args[2].numpy(), return_index=True)[1]] = True

    def nz(t, sub, small):
        row = 3 + (t & 1) if small else t
        return [k for k in range(8) if mc.SUBPEL[row, sub - 1, k]]

    def clip(v, n):
        return min(max(v, 0), n - 1)
    seen = set()
    for d in desc[np.asarray(real, bool)]:
        if kind in ("put", "t"):
            hh, hv = args[6:8] if kind == "put" else args[3:5]
            th, tv = mc._F2D[d[5]]
            kv = nz(tv, d[4], uh <= 4) if hv else [0]
            kh = nz(th, d[3], uw <= 4) if hh else [0]
            seen |= {(d[0], clip(d[1] + y + a, H), clip(d[2] + x + c, W))
                     for y in range(uh) for x in range(uw) for a in kv
                     for c in kh}
            continue
        th, tv = mc._F2D[d[7]]

        def taps(f, step, n, t, i):
            ph = f + i * step
            sub, off = (ph & 1023) >> 6, ph >> 10
            ks = nz(t, sub, n <= 4) if sub else [3]
            return {clip(off + k, 2 * n + 10) for k in ks}
        rows = set().union(*(taps(d[4], d[6], uh, tv, y) for y in range(uh)))
        cols = set().union(*(taps(d[3], d[5], uw, th, x) for x in range(uw)))
        seen |= {(d[0], clip(d[1] - 3 + r, H), clip(d[2] - 3 + c, W))
                 for r in rows for c in cols}
    return len(seen), int(np.sum(real))


def test_chip_smoke_bound_counts_each_read_pixel_once(monkeypatch):
    """chip_smoke.mcu_bound's bytes: the reference pixels the real units'
    nonzero taps read, overlapping windows counted once, against a loop
    over every output and tap, on synthetic cases of each record kind."""
    import chip_smoke
    rng = np.random.default_rng(17)
    cases = chip_smoke.mcu_synthetic_cases(np, torch, rng,
                                           torch.device("cpu"))
    kinds = {v: k for k, v in chip_smoke.MCU_KINDS.items()}
    picked = {}
    for fn, label, dst, args in cases:
        kind = kinds[fn]
        uw, uh = chip_smoke.mcu_unit(kind, dst, args[2:])
        # 4-tap and 8-tap sides, H+V, one case a (kind, unit)
        if (uw, uh) in ((2, 2), (8, 4), (4, 8)) and \
                ("h1v1" in label or "scaled" in label):
            picked.setdefault(kind, {}).setdefault(
                (uw, uh), (label, dst, args, uw, uh))
    assert {k: len(v) for k, v in picked.items()} == dict.fromkeys(
        ("put", "t", "scaled", "s"), 3)
    touched = []
    real_touched = chip_smoke._touched
    monkeypatch.setattr(chip_smoke, "_touched",
                        lambda *a: touched.append(real_touched(*a)) or
                        touched[-1])
    for kind, rows in picked.items():
        for label, dst, args, uw, uh in rows.values():
            _, _, real = chip_smoke.mcu_bound(np, mc, kind, dst, args)
            assert (touched[-1], real) == _read_pixels(kind, dst, args,
                                                       uw, uh), label
