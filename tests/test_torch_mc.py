"""MC ops of the PyTorch port (dav1d_mirror_tpu_torch/ops/mc.py and the
CPU route of ops/mc_cuda.py) against the JAX package's ops/mc_tpu.py on
the same numpy inputs. Tolerance: exact (torch.equal / array_equal)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dav1d_mirror_tpu.ops import mc_tpu as jmc
from dav1d_mirror_tpu_torch.ops import mc, mc_cuda

UNITS = [(8, 8), (8, 4), (4, 8), (4, 4)]
H, W = 40, 56


def _refs(rng, bd):
    return rng.integers(0, 1 << bd, (3, H, W)).astype(np.int32)


def _descs(rng, n, ref_n=3):
    # origins far outside the frame exercise the clamped gathers
    return np.stack([rng.integers(0, ref_n, n),
                     rng.integers(-40, H + 30, n),
                     rng.integers(-40, W + 30, n),
                     rng.integers(1, 16, n), rng.integers(1, 16, n),
                     rng.integers(0, 9, n)], 1).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("hh,hv", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("prep", [False, True])
def test_mc_unit_batch_matches_jax(bd, hh, hv, prep):
    rng = np.random.default_rng(bd * 10 + hh * 4 + hv * 2 + prep)
    refs = _refs(rng, bd)
    for uw, uh in UNITS:
        arr = _descs(rng, 37)
        want = np.asarray(jmc.mc_unit_batch(
            (jnp.asarray(refs), *(jnp.asarray(arr[:, i]) for i in range(6))),
            uw, uh, bool(hh), bool(hv), bd, prep))
        got = mc.mc_unit_batch(
            (_t(refs), *(_t(arr[:, i]) for i in range(6))),
            uw, uh, bool(hh), bool(hv), bd, prep)
        assert got.dtype == torch.int32
        assert torch.equal(got, torch.from_numpy(np.array(want))), (uw, uh)


def _hp_case(rng, bd, case):
    """(refs, combos) of an H-plane case: the base shape, or one of the
    edge shapes the kernel's vector stores, row bands and combo runs can
    get wrong."""
    r, h, w, c = 3, H, W, 12
    if case == "odd_w":          # odd row length, H off the row band
        h, w = 13, 37
    elif case == "h1":
        h = 1
    elif case == "c1":
        c = 1
    hi = 1 << (15 if case == "wrap12" else bd)
    refs = rng.integers(0, hi, (r, h, w)).astype(np.int32)
    combos = np.stack([rng.integers(0, r, c), rng.integers(0, 6, c),
                       rng.integers(1, 16, c)], 1).astype(np.int32)
    if case == "alternating":    # unsorted, references alternate
        combos[:, 0] = np.arange(c) % 2 * 2
    elif case == "dup":          # duplicate combos, as the planner pads
        combos[c // 2:] = combos[:c - c // 2]
    return refs, combos


# "wrap12": reference values up to 2^15, beyond 12-bit pixels (whose mid
# values peak at 23546), so the int16 store wraps.
HP_CASES = [pytest.param(bd, "base", id=str(bd)) for bd in (8, 10, 12)] + [
    pytest.param(bd, case, id=f"{case}-{bd}") for bd, case in (
        (8, "odd_w"), (10, "h1"), (8, "c1"), (8, "alternating"),
        (10, "dup"), (12, "wrap12"))]


@pytest.mark.parametrize("bd,case", HP_CASES)
def test_mc_hplanes_matches_jax(bd, case):
    rng = np.random.default_rng(bd)
    refs, combos = _hp_case(rng, bd, case)
    want = np.asarray(jmc.mc_hplanes(jnp.asarray(refs),
                                     jnp.asarray(combos), bd))
    got = mc.mc_hplanes(_t(refs), _t(combos), bd)
    assert got.dtype == torch.int16
    assert torch.equal(got, torch.from_numpy(np.array(want)))
    if case == "wrap12":
        assert np.abs(want.astype(np.int64)).max() > 16384


_TS_UNITS = UNITS + [(2, 2), (2, 4), (4, 2)]
# "b1": one unit; "extreme": ox at -15 and W-1 after the clamp, oy far
# above and below the plane; both over all nine unit sizes
TS_CASES = [pytest.param(bd, unit, prep, "base", id=f"{prep}-unit{i}-{bd}")
            for prep in (False, True) for i, unit in enumerate(_TS_UNITS)
            for bd in (8, 10, 12)] + [
    pytest.param(bd, (uw, uh), prep, case,
                 id=f"{case}-{prep}-{uw}x{uh}-{bd}")
    for case, bd in (("b1", 8), ("extreme", 12)) for prep in (False, True)
    for uw in (2, 4, 8) for uh in (2, 4, 8)]


@pytest.mark.parametrize("bd,unit,prep,case", TS_CASES)
def test_mc_two_stage_matches_jax_and_window_kernel(bd, unit, prep, case):
    """Port two-stage (hplanes + hv) == JAX two-stage == JAX single-stage
    window kernel, on the packer's combo/slot mapping."""
    uw, uh = unit
    rng = np.random.default_rng(bd * 100 + uw * 10 + uh + prep)
    refs = _refs(rng, bd)
    arr = _descs(rng, 1 if case == "b1" else 45)
    if case == "extreme":
        n = len(arr)
        arr[:, 2] = np.where(np.arange(n) % 2, -10 ** 4, W + 10 ** 4)
        arr[:, 1] = np.where(np.arange(n) % 3 == 0, -10 ** 4,
                             np.where(np.arange(n) % 3 == 1, H + 10 ** 4,
                                      arr[:, 1]))
    combos, slot, tv = mc.mc_hv_combos(arr, uw)
    j_combos, j_slot, j_tv = jmc.mc_hv_combos(arr, uw)
    for a, b in ((combos, j_combos), (slot, j_slot), (tv, j_tv)):
        np.testing.assert_array_equal(a, b)
    ox = np.clip(arr[:, 2], -mc.HPAD_L, W - 1).astype(np.int32)
    hs = mc.mc_hplanes(_t(refs), _t(combos), bd)
    got = mc.mc_unit_batch_hv(
        (hs, _t(slot), _t(arr[:, 1]), _t(ox), _t(arr[:, 4]), _t(tv)),
        uw, uh, bd, prep)
    j_hs = jmc.mc_hplanes(jnp.asarray(refs), jnp.asarray(combos), bd)
    want = np.asarray(jmc.mc_unit_batch_hv(
        (j_hs, jnp.asarray(slot), jnp.asarray(arr[:, 1]), jnp.asarray(ox),
         jnp.asarray(arr[:, 4]), jnp.asarray(tv)), uw, uh, bd, prep))
    assert torch.equal(got, torch.from_numpy(np.array(want)))
    window = np.asarray(jmc.mc_unit_batch(
        (jnp.asarray(refs), *(jnp.asarray(arr[:, i]) for i in range(6))),
        uw, uh, True, True, bd, prep))
    np.testing.assert_array_equal(want, window)


@pytest.mark.parametrize("unit", UNITS)
def test_scatter_units_drops_pad_rows(unit):
    uw, uh = unit
    rng = np.random.default_rng(uw * 10 + uh)
    plane = rng.integers(0, 255, (32, 48)).astype(np.int32)
    # disjoint unit origins on the unit grid, then PAD_OOB pad rows
    cells = rng.permutation((32 // uh) * (48 // uw))[:20]
    ys = (cells // (48 // uw) * uh).astype(np.int32)
    xs = (cells % (48 // uw) * uw).astype(np.int32)
    ys = np.concatenate([ys, np.full(12, mc.PAD_OOB, np.int32)])
    xs = np.concatenate([xs, rng.integers(0, 48, 12).astype(np.int32)])
    units = rng.integers(0, 255, (32, uh, uw)).astype(np.int32)
    # debug check of the disjointness the scatter relies on
    yy, xx, ok = mc.unit_index(_t(ys), _t(xs), uh, uw, (32, 48))
    lin = (yy[ok] * 48 + xx[ok]).numpy()
    assert len(np.unique(lin)) == len(lin)
    want = np.asarray(jmc.scatter_units(jnp.asarray(plane),
                                        jnp.asarray(units), jnp.asarray(ys),
                                        jnp.asarray(xs), uh, uw))
    got = mc.scatter_units(_t(plane.copy()), _t(units), _t(ys), _t(xs),
                           uh, uw)
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_cuda_wrappers_route_cpu_tensors_to_plain_versions():
    rng = np.random.default_rng(5)
    refs = _t(_refs(rng, 8))
    combos = _t(np.array([[0, 0, 3], [1, 2, 9], [2, 4, 15]], np.int32))
    n_hp, n_vp = mc_cuda.HPLANES_LAUNCHES, mc_cuda.VPASS_LAUNCHES
    hs = mc_cuda.mc_hplanes(refs, combos, 8)
    assert torch.equal(hs, mc.mc_hplanes(refs, combos, 8))
    args = (hs, _t(np.array([0, 2, 1], np.int32)),
            _t(np.array([-5, 10, 39], np.int32)),
            _t(np.array([-15, 0, 55], np.int32)),
            _t(np.array([1, 8, 15], np.int32)),
            _t(np.array([0, 1, 2], np.int32)))
    out = mc_cuda.mc_unit_batch_hv(args, 8, 8, 8, False)
    assert torch.equal(out, mc.mc_unit_batch_hv(args, 8, 8, 8, False))
    # the counters count kernel launches only
    assert (mc_cuda.HPLANES_LAUNCHES, mc_cuda.VPASS_LAUNCHES) == (n_hp, n_vp)


def test_cuda_wrappers_refuse_other_devices():
    refs = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    combos = torch.zeros((1, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        mc_cuda.mc_hplanes(refs, combos, 8)
