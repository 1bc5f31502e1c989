"""The deblock kernel's CPU-side checks (its CUDA source runs only on the
card, where chip_smoke.py and tools/filter_cases.py hold it to its plain
version).

- ``tools/deblock_model.py``, a numpy model of the kernel's two phases
  (every edge's candidate outputs and store mask, then each pixel's last
  set store in the plain version's order, its writers found by inverting
  the plain column map), equals the plain ``ops/loopfilter._apply_pass``
  on random maps, on maps where neighbouring 16 px (6 px) edges store
  into the same pixels, on views exactly as wide as their edges (clamped
  taps) and with edges 0 and 1 active (wrapped taps), and on a band's
  transposed view behind its halo rows (base > 0); the plain
  ``deblock_plane`` on every synthetic plane of ``tools/filter_cases``
  (the model's two passes); and every pixel's writers are its tile's
  phase-1 edges (at the tile sizes of ``csrc/deblock.cu``) or a wrapped
  write, which the kernel computes on the spot;
- the wrapper's CPU route equals the JAX package's ``deblock_plane_tpu``
  at 64x64 luma (monochrome), 32x32 (4:2:0), 64x32 (4:2:2) and 64x64
  (4:4:4) chroma and odd edge counts, bd 8/10/12, int8 and int32 maps;
- ``DbkArgs`` mirrors the source's struct field by field, and
  ``pass_args`` packs the strides of both passes (the horizontal one on
  transposed views), the element widths of int8/int16/int32 maps and
  LUTs, and a band's base;
- ``chip_smoke.deblock_cost`` counts the plane read once and written
  once, with the maps and LUTs;
- the launch counter counts kernel launches only, and a tensor on another
  device, or on a CUDA device without the kernel library, raises instead
  of reaching the plain version.
Tolerance: exact."""
import ctypes as ct
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dav1d_mirror_tpu.ops.loopfilter_tpu import deblock_plane_tpu
from dav1d_mirror_tpu_torch.ops import deblock_cuda, loopfilter
from dav1d_mirror_tpu_torch.tools import deblock_model as dm
from dav1d_mirror_tpu_torch.tools import filter_cases as fc

SRC = (Path(deblock_cuda.__file__).resolve().parent.parent / "csrc" /
       "deblock.cu").read_text()


def _t(a):
    return torch.from_numpy(np.array(a))


def _of_shape(label, shape):
    """A deblock_plane case of tools/filter_cases of this DBK_SHAPES
    entry."""
    name, (Hp, Wp) = shape[:2]
    return label.startswith(f"deblock_plane {name} {Hp}x{Wp} ")


def _plain_pass(view, maps, luts, luma, bd, base):
    out = _t(view.copy())
    loopfilter._apply_pass(out, *(_t(m) for m in maps), *(_t(x) for x in luts),
                           luma, bd, base)
    return out.numpy()


@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("kind", ["random", "conflict"])
@pytest.mark.parametrize("geometry", ["exact", "wider", "band", "wrap"])
def test_model_matches_plain_apply_pass(luma, bd, kind, geometry):
    rng = np.random.default_rng([bd, luma, len(kind), len(geometry)])
    n_er, n_e = 7, 11
    base = fc.HALO if geometry == "band" else 0
    W = 4 * n_e + base + (9 if geometry == "wider" else 0)
    view = fc.content(rng, 4 * n_er, W, bd, kind)
    maps = list(fc.lf_maps(rng, n_er, n_e, luma, kind))
    if geometry == "wrap":       # edges 0 and 1 read and write wrapped
        maps[0][:, :2] = 2 if luma else 1
    luts = fc.lf_luts(int(rng.integers(0, 8)))
    want = _plain_pass(view, maps, luts, luma, bd, base)
    tile = deblock_cuda.TILE[geometry == "band"]
    got = dm.apply_pass(view, *maps, *luts, luma, bd, base, tile=tile)
    assert np.array_equal(got, want)
    assert not np.array_equal(want, view), "nothing was filtered"
    if kind == "conflict" and luma:
        # neighbouring edges both store into some pixel in the plain order
        # (chroma's 6 px edges store 2 px a side: never the same pixel)
        outs, masks = dm.edge_outputs(view, *maps, *luts, luma, bd, base)
        ns = 6 if luma else 2
        writers = np.zeros(view.shape, np.int64)
        c = np.arange(W)
        for k in range(ns):
            for wr in (dm.p_writer, dm.q_writer):
                i = wr(c, k, base, n_e, W)
                cols = np.nonzero(i >= 0)[0]
                writers[:, cols] += (masks[:, i[cols]] >> k) & 1
        assert writers.max() > 1


def test_model_band_pass_on_a_transposed_view():
    """A band's horizontal pass as filter_shard runs it: ext.T[:4 w4]
    behind HALO rows, transposed maps, the band's top edge reading its
    halo."""
    rng = np.random.default_rng(5)
    for luma in (True, False):
        for _, ext, view_of, kw, transposed in [
                c for c in fc.deblock_pass_cases(rng) if c[4]]:
            if kw["luma"] != luma:
                continue
            maps = [kw[k].T for k in ("edge_idx", "lvl_cur", "lvl_prev")]
            luts = (kw["e_lut"], kw["i_lut"])
            plain = _t(ext.copy())
            loopfilter._apply_pass(view_of(plain), *(_t(m) for m in maps),
                                   *(_t(x) for x in luts), luma,
                                   kw["bitdepth"], kw["base"])
            view = view_of(torch.from_numpy(ext.copy())).numpy()
            got = dm.apply_pass(view, *maps, *luts, luma, kw["bitdepth"],
                                kw["base"], tile=deblock_cuda.TILE[True])
            assert np.array_equal(got, view_of(plain).numpy())
            assert not np.array_equal(plain.numpy(), ext)


@pytest.mark.parametrize("shape", fc.DBK_SHAPES, ids=lambda s: s[0])
def test_model_deblock_plane_matches_plain(shape):
    """The model's vertical pass on the plane, then its horizontal pass on
    the transpose, as deblock_cuda.deblock_plane launches them, equal the
    plain deblock_plane on the synthetic planes of tools/filter_cases."""
    cases = [kw for label, kw in fc.deblock_plane_cases(
        np.random.default_rng(11)) if _of_shape(label, shape)]
    assert len(cases) == 6
    for kw in cases:
        a = {k: np.asarray(v, np.int64) if isinstance(v, np.ndarray) else v
             for k, v in kw.items()}
        luts = (a["e_lut"], a["i_lut"])
        mid = a["plane"].copy()
        h4, w4 = a["edge_v"].shape
        ev = a["edge_v"].copy()
        mid[:4 * h4] = dm.apply_pass(mid, ev, a["lvl_v"], a["lvl_v_prev"],
                                     *luts, a["luma"], a["bitdepth"],
                                     first_edge=1,
                                     tile=deblock_cuda.TILE[False])
        out = mid.copy()
        out.T[:4 * w4] = dm.apply_pass(
            mid.T, a["edge_h"].T, a["lvl_h"].T, a["lvl_h_prev"].T, *luts,
            a["luma"], a["bitdepth"], first_edge=1,
            tile=deblock_cuda.TILE[True])
        want = loopfilter.deblock_plane(*(
            _t(kw[k]) for k in ("plane", "edge_v", "edge_h", "lvl_v",
                                "lvl_v_prev", "lvl_h", "lvl_h_prev",
                                "e_lut", "i_lut")), kw["luma"],
            kw["bitdepth"])
        assert np.array_equal(out, want.numpy())


def test_chip_smoke_bound_moves_the_plane_once():
    """chip_smoke.deblock_cost's bytes: the plane read once and the
    result written once (int32), plus the six maps and the two LUTs; the
    kernel's second round trip of the plane between its two passes is
    not the function's and is not counted."""
    import chip_smoke
    for label, kw in fc.deblock_plane_cases(np.random.default_rng(5))[:6]:
        names = ("plane", "edge_v", "edge_h", "lvl_v", "lvl_v_prev",
                 "lvl_h", "lvl_h_prev", "e_lut", "i_lut")
        args = [_t(kw[k]) for k in names] + [kw["luma"], kw["bitdepth"]]
        n_bytes, _ = chip_smoke.deblock_cost(np, args, {})
        want = 2 * 4 * args[0].numel() + sum(
            t.numel() * t.element_size() for t in args[1:9])
        assert n_bytes == want, label


def test_tiles_match_the_source():
    """The model's tile sizes and phase-1 edge range are the kernel's."""
    tr = re.search(r"constexpr int TR = ROWS_FAST \? (\d+) : (\d+);", SRC)
    tc = re.search(r"constexpr int TC = ROWS_FAST \? (\d+) : (\d+);", SRC)
    launch = re.search(r"const int tr = rows_fast \? (\d+) : (\d+), "
                       r"tc = rows_fast \? (\d+) : (\d+);", SRC)
    assert tr and tc and launch
    assert deblock_cuda.TILE == {True: (int(tr[1]), int(tc[1])),
                                 False: (int(tr[2]), int(tc[2]))}
    assert launch.groups() == tr.groups() + tc.groups()
    assert "i_lo = max(floordiv4(c0 - a.base - 2), 0)" in SRC
    assert "i_hi = min(floordiv4(c0 + TC + 5 - a.base), a.n_e - 1)" in SRC
    assert "constexpr int NE = TC / 4 + 4;" in SRC
    # the closed form of a pixel's writers below the last 8 columns, as
    # the model's `writers` takes it
    flat = " ".join(SRC.split())
    for line in ("if (r < rf && c < a.W - 8) {",
                 "const int cp = c - a.base, m = cp & 3, j = cp >> 2;",
                 "const int ks[3] = {lo ? m : 3 - m, lo ? 3 - m : m, "
                 "lo ? m + 4 : 7 - m};",
                 "const int qs[3] = {lo, !lo, lo};",
                 "const int es[3] = {lo ? j : j + 1, lo ? j + 1 : j, "
                 "lo ? j - 1 : j + 2};"):
        assert line in flat, line
    for base in (0, 3, 8):
        for c0 in range(0, 512, 64):
            lo, hi = dm.tile_edges(c0, 64, base, 1000)
            assert hi - lo + 1 <= 64 // 4 + 4


def _jax_case(kw):
    return np.asarray(deblock_plane_tpu(
        jnp.asarray(kw["plane"]),
        *(jnp.asarray(kw[k].astype(np.int32)) for k in (
            "edge_v", "edge_h", "lvl_v", "lvl_v_prev", "lvl_h",
            "lvl_h_prev")),
        jnp.asarray(kw["e_lut"]), jnp.asarray(kw["i_lut"]),
        luma=kw["luma"], bitdepth=kw["bitdepth"]))


@pytest.mark.parametrize("shape", fc.DBK_SHAPES, ids=lambda s: s[0])
def test_wrapper_cpu_route_matches_jax(shape):
    cases = [(label, kw) for label, kw in fc.deblock_plane_cases(
        np.random.default_rng(7)) if _of_shape(label, shape)]
    # bd 8/10/12, one random and one conflicting map each, int8 and int32
    assert len(cases) == 6
    n0 = deblock_cuda.DEBLOCK_LAUNCHES
    for label, kw in cases:
        src = _t(kw["plane"])
        got = deblock_cuda.deblock_plane(**{
            k: _t(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()})
        assert torch.equal(src, _t(kw["plane"])), "input plane modified"
        assert got.dtype == torch.int32
        assert torch.equal(got, _t(_jax_case(kw))), label
    assert deblock_cuda.DEBLOCK_LAUNCHES == n0     # kernel launches only


def _struct_fields(name):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, SRC, re.S)[1]
    out = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        ctype, names = re.match(r"(.*?)(\w+(?:\s*,\s*\w+)*)$",
                                line).groups()
        for n in names.split(","):
            out.append((ctype.strip(), n.strip()))
    return out


def test_args_struct_mirrors_the_source():
    kinds = {ct.c_void_p: lambda c: c.endswith("*"),
             ct.c_longlong: lambda c: c == "long long",
             ct.c_int: lambda c: c == "int"}
    fields = _struct_fields("DbkArgs")
    assert len(fields) == len(deblock_cuda.DbkArgs._fields_)
    for (ctype, name), (pname, ptype) in zip(fields,
                                             deblock_cuda.DbkArgs._fields_):
        assert pname == {"in": "inp"}.get(name, name)
        assert kinds[ptype](ctype), (ctype, ptype)


def test_pass_args_packing():
    """Strides, element widths, base and counts as the kernel reads
    them."""
    plane = torch.zeros((72, 96), dtype=torch.int32)
    mid = torch.zeros_like(plane)
    h4, w4 = 17, 21
    ev = torch.zeros((h4, w4), dtype=torch.int8)
    lv = torch.zeros((h4, w4), dtype=torch.int16)
    lvp = torch.zeros((h4, w4), dtype=torch.int32)
    e_lut = torch.zeros(64, dtype=torch.int16)
    i_lut = torch.zeros(64, dtype=torch.int32)
    a = deblock_cuda.pass_args(plane, mid, 72, ev, lv, lvp, e_lut, i_lut,
                               True, 10, first_edge=1)
    assert (a.in_sr, a.in_sc, a.out_sr, a.out_sc) == (96, 1, 96, 1)
    assert (a.edge_s0, a.edge_s1, a.edge_es) == (w4, 1, 1)
    assert (a.lvl_s0, a.lvl_s1, a.lvl_es) == (w4, 1, 2)
    assert (a.lvlp_es, a.elut_es, a.ilut_es) == (4, 2, 4)
    assert (a.rows, a.W, a.n_er, a.n_e) == (72, 96, h4, w4)
    assert (a.base, a.first_edge, a.luma, a.bd) == (0, 1, 1, 10)
    assert (a.inp, a.out, a.edge) == (plane.data_ptr(), mid.data_ptr(),
                                      ev.data_ptr())
    # the horizontal pass: the transposes, read and written in place
    eh = torch.zeros((h4, w4), dtype=torch.int32)
    a = deblock_cuda.pass_args(mid.T, plane.T, 96, eh.T, eh.T, eh.T, e_lut,
                               i_lut, False, 8, first_edge=1)
    assert (a.in_sr, a.in_sc, a.out_sr, a.out_sc) == (1, 96, 1, 96)
    assert (a.edge_s0, a.edge_s1) == (1, w4)
    assert (a.rows, a.W, a.n_er, a.n_e, a.luma) == (96, 72, w4, h4, 0)
    # a band's H pass: ext.T[:4 w4] behind HALO rows
    ext = torch.zeros((fc.HALO + 20, 96), dtype=torch.int32)
    band = torch.zeros((5, w4), dtype=torch.int32)
    view = ext.T[:4 * w4]
    a = deblock_cuda.pass_args(view, torch.empty(view.shape,
                                                 dtype=torch.int32),
                               4 * w4, band.T, band.T, band.T, e_lut, i_lut,
                               True, 12, base=fc.HALO)
    assert (a.in_sr, a.in_sc, a.out_sr, a.out_sc) == (1, 96, fc.HALO + 20, 1)
    assert (a.W, a.n_er, a.n_e, a.base, a.bd) == (fc.HALO + 20, w4, 5,
                                                  fc.HALO, 12)


def _meta(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _meta_args():
    m = [_meta(4, 4) for _ in range(6)]
    return (_meta(16, 16), *m, _meta(64), _meta(64))


def test_other_devices_raise():
    with pytest.raises(ValueError):
        deblock_cuda.deblock_plane(*_meta_args(), luma=True, bitdepth=8)
    with pytest.raises(ValueError):
        deblock_cuda.apply_pass(_meta(16, 16), *(_meta(4, 4) for _ in
                                                 range(3)),
                                _meta(64), _meta(64), True, 8)


def test_cuda_route_without_the_library_raises(monkeypatch):
    """A tensor taken for a CUDA one, with no kernel library to load: the
    call raises and never reaches the plain version."""
    def no_library(*a, **k):
        raise RuntimeError("no kernel library")

    def plain(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(deblock_cuda, "cuda_device", lambda t, what: t.device)
    monkeypatch.setattr(deblock_cuda, "load", no_library)
    monkeypatch.setattr(loopfilter, "deblock_plane", plain)
    monkeypatch.setattr(loopfilter, "_apply_pass", plain)
    n0 = deblock_cuda.DEBLOCK_LAUNCHES
    with pytest.raises(RuntimeError, match="no kernel library"):
        deblock_cuda.deblock_plane(*_meta_args(), luma=True, bitdepth=8)
    with pytest.raises(RuntimeError, match="no kernel library"):
        deblock_cuda.apply_pass(_meta(16, 16), *(_meta(4, 4) for _ in
                                                 range(3)),
                                _meta(64), _meta(64), True, 8)
    assert deblock_cuda.DEBLOCK_LAUNCHES == n0


def test_views_the_kernel_cannot_take_raise(monkeypatch):
    """Geometry the kernel does not compute as the plain version does
    raises on the CUDA route: edges past the view, a view under 8
    columns, rows that are not 4 a map row."""
    monkeypatch.setattr(deblock_cuda, "cuda_device", lambda t, what: t.device)
    m = lambda *s: _meta(*s)
    with pytest.raises(ValueError, match="edges from column"):
        deblock_cuda.apply_pass(m(16, 16), m(4, 5), m(4, 5), m(4, 5),
                                m(64), m(64), True, 8)
    with pytest.raises(ValueError, match="edges from column"):
        deblock_cuda.apply_pass(m(16, 12), m(4, 2), m(4, 2), m(4, 2),
                                m(64), m(64), True, 8, base=8)
    with pytest.raises(ValueError, match="rows for"):
        deblock_cuda.apply_pass(m(12, 16), m(4, 4), m(4, 4), m(4, 4),
                                m(64), m(64), True, 8)
    with pytest.raises(ValueError):
        deblock_cuda.apply_pass(m(4, 4), m(1, 1), m(1, 1), m(1, 1),
                                m(64), m(64), True, 8)
