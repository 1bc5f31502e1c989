"""The deblock kernels' CPU-side checks (their CUDA source runs only on
the card, where chip_smoke.py and tools/filter_cases.py hold them to their
plain versions). The pass kernel (``apply_pass``, ``deblock_plane``):

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

The frame kernel (``deblock_frame``, the decode's):

- ``deblock_model.fused_tile`` (its tile: the input staged with its halo
  at logical coordinates, both passes, each store the largest (key,
  value), edge 1's wrapped stores computed on the spot) equals the plain
  ``deblock_plane`` with the neighbour levels on the synthetic frames of
  ``tools/filter_cases`` (4:2:0, 4:2:2, 4:4:4, monochrome, pad rows and
  columns, a frame of several 64x64 tiles; random and conflicting maps
  and 16 px luma edges at x = 4 and y = 4 whose taps and stores wrap),
  at the kernel's tile and at smaller ones; its tile, halos and edge
  ranges are the source's;
- the CPU route equals the JAX package's ``deblock_plane_tpu`` plane by
  plane; ``DbkPlane`` and ``DbkFrameArgs`` mirror the source and
  ``frame_args`` packs planes, maps, tiles and LUTs;
  ``chip_smoke.deblock_frame_cost`` counts each plane read and written
  once and each map storage once, where the chroma planes' maps alias;
- the planner emits one ``dbkrun`` record a frame after its ``dbk``
  records, which the executor runs as one ``deblock_frame`` call (a
  corpus stream's md5 is the JAX host path's), and refuses ``dbk``
  records no ``dbkrun`` covers.
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


# ---- the frame kernel (deblock_frame) ----

def _frame_cases():
    """One deblock_frame case of tools/filter_cases a (frame, kind), the
    bit depth turning with them (the many-tile frame's random and wrap
    maps only: its model is the slowest)."""
    out = {}
    for i, (label, kw) in enumerate(fc.deblock_frame_cases(
            np.random.default_rng(11))):
        frame, bd, kind = i // 9, i // 3 % 3, i % 3
        if bd == (frame + kind) % 3 and (frame, kind) != (5, 1):
            name = label.split(" bd")[0].removeprefix("deblock_frame ")
            out[(name, label.split()[-3])] = kw
    return out


FRAME_CASES = _frame_cases()


def _with_prev(kw, i):
    """Plane i's deblock_plane arguments: its maps with the neighbour
    levels (the previous edge's entry of the level map)."""
    lv, lh = _t(kw["lvl_v"][i]), _t(kw["lvl_h"][i])
    lvp, lhp = loopfilter.neighbour_levels(lv, lh)
    return (_t(kw["planes"][i]), _t(kw["edge_v"][i]), _t(kw["edge_h"][i]),
            lv, lvp, lh, lhp, _t(kw["e_lut"]), _t(kw["i_lut"]), i == 0,
            kw["bitdepth"])


@pytest.mark.parametrize("key", sorted(FRAME_CASES), ids=" ".join)
def test_fused_tile_model_matches_plain_deblock_plane(key):
    """tools/deblock_model.fused_tile (the frame kernel's tile: staged
    halo, both passes, stores as the largest (key, value), edge 1's
    wrapped stores computed on the spot) equals the plain deblock_plane
    with the neighbour levels, at the kernel's 64x64 tile and, on the
    small frames, at 16x32 tiles (more tile borders, and the last two
    rows and columns in other tiles than edge 1)."""
    kw = FRAME_CASES[key]
    big = key[0].startswith("4:2:0 tiles")
    tiles = [dm.FRAME_TILE] + ([] if big else [(16, 32)])
    for i, plane in enumerate(kw["planes"]):
        want = loopfilter.deblock_plane(*_with_prev(kw, i)).numpy()
        assert not np.array_equal(want, plane), "nothing was filtered"
        for tile in tiles:
            got = dm.deblock_frame_plane(
                plane, kw["edge_v"][i], kw["edge_h"][i], kw["lvl_v"][i],
                kw["lvl_h"][i], (kw["e_lut"], kw["i_lut"]), i == 0,
                kw["bitdepth"], tile)
            assert np.array_equal(got, want), (i, tile)
        if key[1] == "wrap" and i == 0 and ("odd" in key[0] or big):
            # pad rows and columns: only edge 1's wrapped p4 and p5 store
            # into the last two (the 64x64 frames have no pad)
            Hp, Wp = plane.shape
            assert not np.array_equal(want[:, Wp - 2:], plane[:, Wp - 2:])
            mid = plane.copy()
            mid[:4 * kw["edge_v"][i].shape[0]] = dm.apply_pass(
                plane, kw["edge_v"][i], kw["lvl_v"][i],
                loopfilter.neighbour_levels(
                    _t(kw["lvl_v"][i]), _t(kw["lvl_h"][i]))[0].numpy(),
                kw["e_lut"], kw["i_lut"], True, kw["bitdepth"],
                first_edge=1)
            assert not np.array_equal(want[Hp - 2:], mid[Hp - 2:])


def test_frame_model_tiles_match_the_source():
    """The model's tile, halos and edge ranges are the frame kernel's."""
    flat = " ".join(SRC.split())
    th = re.search(r"#define DBF_TH (\d+)", SRC)
    tw = re.search(r"#define DBF_TW (\d+)", SRC)
    assert (int(th[1]), int(tw[1])) == dm.FRAME_TILE == \
        deblock_cuda.FRAME_TILE
    assert "constexpr int HL = LUMA ? 12 : 4;" in SRC
    assert (dm.halo(True), dm.halo(False)) == (12, 4)
    for line in ("const int i_lo = max(ceil4(x0 - NS + 1), 1);",
                 "const int i_hi = min((x0 + DBF_TW - 1 + NS) >> 2, w4 - 1);",
                 "const int j_lo = max(ceil4(y0 - NS + 1), 1);",
                 "const int j_hi = min((y0 + DBF_TH - 1 + NS) >> 2, h4 - 1);",
                 "const bool v_wrap = LUMA && w4 > 1 && i_lo > 1 && "
                 "x0 + DBF_TW >= Wp - 1;",
                 "if (LUMA && h4 > 1 && j_lo > 1 && y0 + DBF_TH >= Hp - 1) {",
                 "atomicMax(buf + t * st, (2 * k + side) << 16 | v);"):
        assert line in flat, line
    for x0 in range(0, 512, 64):
        for luma in (True, False):
            lo, hi = dm.edge_range(x0, 64, 1000, luma)
            assert hi - lo + 1 <= 64 // 4 + 3
            # every tap of those edges lies in the staged columns
            ns = 7 if luma else 3
            assert 4 * max(lo, 1) - ns >= x0 - dm.halo(luma)
            assert 4 * hi + ns - 1 < x0 + 64 + dm.halo(luma)


@pytest.mark.parametrize("frame", ["4:2:0 odd 80x96", "4:2:2 64x64"])
def test_deblock_frame_cpu_route_matches_jax(frame):
    """deblock_frame's CPU route against the JAX package's
    deblock_plane_tpu, plane by plane, the neighbour levels the level
    maps shifted by one edge (as the JAX interpreter derives them)."""
    kw = FRAME_CASES[(frame, "wrap")]
    n0 = deblock_cuda.DEBLOCK_LAUNCHES
    got = deblock_cuda.deblock_frame(
        *(tuple(_t(m) for m in kw[k]) for k in ("planes", "edge_v", "edge_h",
                                                 "lvl_v", "lvl_h")),
        _t(kw["e_lut"]), _t(kw["i_lut"]), kw["bitdepth"])
    assert len(got) == len(kw["planes"]) == 3
    for i, g in enumerate(got):
        lv, lh = (kw[k][i].astype(np.int32) for k in ("lvl_v", "lvl_h"))
        lvp, lhp = np.zeros_like(lv), np.zeros_like(lh)
        lvp[:, 1:], lhp[1:] = lv[:, :-1], lh[:-1]
        want = _jax_case(dict(plane=kw["planes"][i], edge_v=kw["edge_v"][i],
                              edge_h=kw["edge_h"][i], lvl_v=lv,
                              lvl_v_prev=lvp, lvl_h=lh, lvl_h_prev=lhp,
                              e_lut=kw["e_lut"], i_lut=kw["i_lut"],
                              luma=i == 0, bitdepth=kw["bitdepth"]))
        assert g.dtype == torch.int32
        assert torch.equal(g, _t(want)), i
    assert deblock_cuda.DEBLOCK_LAUNCHES == n0     # kernel launches only


@pytest.mark.parametrize("mirror", [deblock_cuda.DbkPlane,
                                    deblock_cuda.DbkFrameArgs],
                         ids=lambda m: m.__name__)
def test_frame_args_structs_mirror_the_source(mirror):
    kinds = {ct.c_void_p: lambda c: c.endswith("*"),
             ct.c_longlong: lambda c: c == "long long",
             ct.c_int: lambda c: c == "int"}
    body = re.search(r"struct %s \{(.*?)\n\};" % mirror.__name__, SRC,
                     re.S)[1]
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if line:
            ctype, names = re.match(r"(.*?)(\w+(?:\[\w+\])?(?:\s*,\s*\w+)*)$",
                                    line).groups()
            fields += [(ctype.strip(), n.strip()) for n in names.split(",")]
    assert len(fields) == len(mirror._fields_)
    for (ctype, name), (pname, ptype) in zip(fields, mirror._fields_):
        if name == "pl[3]":
            assert (pname, ptype, ctype) == ("pl", deblock_cuda.DbkPlane * 3,
                                             "DbkPlane")
            continue
        assert pname == {"in": "inp"}.get(name, name)
        assert kinds[ptype](ctype), (ctype, ptype)


def test_frame_args_packing():
    """Each plane's pointers, strides, element widths, tiles and first
    CTA; the LUTs; a plane whose rows cannot be read as 16-byte loads."""
    luma = torch.zeros((80, 96), dtype=torch.int32)
    chroma = [torch.zeros((40, 50), dtype=torch.int32)[:, :48]
              for _ in range(2)]
    planes = [luma] + chroma
    outs = [torch.empty((p.shape[0], p.shape[1]), dtype=torch.int32)
            for p in planes]
    ev = [torch.zeros((20, 24), dtype=torch.int8), *(torch.zeros(
        (10, 12), dtype=torch.int8) for _ in range(2))]
    lv = [torch.zeros((24, 20), dtype=torch.int16).T] + [
        torch.zeros((10, 12), dtype=torch.int32)] * 2
    e_lut = torch.zeros(64, dtype=torch.int16)
    i_lut = torch.zeros(64, dtype=torch.int8)
    a = deblock_cuda.frame_args(planes, outs, ev, ev, lv, lv, e_lut, i_lut,
                                10)
    assert (a.n_planes, a.bd, a.elut_es, a.ilut_es) == (3, 10, 2, 1)
    # luma 80x96: 2 x 2 tiles of 64x64; chroma 40x48: one each
    assert [(a.pl[i].tiles_x, a.pl[i].tile0) for i in range(3)] == \
        [(2, 0), (1, 4), (1, 5)]
    assert a.n_tiles == 6
    p0, p1 = a.pl[0], a.pl[1]
    assert (p0.Hp, p0.Wp, p0.h4, p0.w4, p0.luma) == (80, 96, 20, 24, 1)
    assert (p0.in_sr, p0.out_sr, p0.vec) == (96, 96, 1)
    assert (p0.ev_s0, p0.ev_s1, p0.ev_es) == (24, 1, 1)
    assert (p0.lv_s0, p0.lv_s1, p0.lv_es) == (1, 20, 2)
    assert (p1.Hp, p1.Wp, p1.luma, p1.in_sr, p1.out_sr) == (40, 48, 0, 50,
                                                            48)
    assert (p1.vec, p1.lv_es) == (0, 4)    # rows of 50 ints: no int4 rows
    assert (p0.inp, p0.out, a.elut) == (luma.data_ptr(), outs[0].data_ptr(),
                                        e_lut.data_ptr())


def test_chip_smoke_frame_bound_moves_each_plane_once():
    """chip_smoke.deblock_frame_cost's bytes: every plane read once and
    written once (int32), its four maps and the LUTs once; its operations
    those of deblock_cost on each plane with the neighbour levels."""
    import chip_smoke
    kw = FRAME_CASES[("4:2:0 odd 80x96", "random")]
    args = [tuple(_t(m) for m in kw[k]) for k in ("planes", "edge_v",
                                                  "edge_h", "lvl_v",
                                                  "lvl_h")]
    args += [_t(kw["e_lut"]), _t(kw["i_lut"]), kw["bitdepth"]]
    n_bytes, n_ops = chip_smoke.deblock_frame_cost(np, args, {})
    want = sum(2 * 4 * p.numel() for p in args[0]) + sum(
        m.numel() * m.element_size() for maps in args[1:5] for m in maps) + \
        sum(t.numel() * t.element_size() for t in args[5:7])
    assert n_bytes == want
    assert n_ops == sum(chip_smoke.deblock_cost(np, _with_prev(kw, i), {})[1]
                        for i in range(3))
    # as the executor passes them: both chroma planes on one edge_v and
    # one edge_h view, each chroma plane's one level map for lvl_v and
    # lvl_h; each map storage counted once
    ev, eh = args[1][1], args[2][1]
    lv = [args[3][0], args[3][1], args[3][2]]
    lh = [args[4][0], args[3][1], args[3][2]]
    alias = [args[0], (args[1][0], ev, ev), (args[2][0], eh, eh),
             tuple(lv), tuple(lh)] + args[5:]
    n_bytes, _ = chip_smoke.deblock_frame_cost(np, alias, {})
    distinct = (args[1][0], args[2][0], args[3][0], args[4][0], ev, eh,
                args[3][1], args[3][2])
    assert n_bytes == sum(2 * 4 * p.numel() for p in args[0]) + sum(
        m.numel() * m.element_size() for m in distinct) + \
        sum(t.numel() * t.element_size() for t in args[5:7])
    # the copies chip_smoke keeps of a call (FilterLog) alias as the call's
    # arguments did
    kept_a, kept_k = chip_smoke._clone((alias, {}))
    assert kept_a[1][1] is kept_a[1][2] and kept_a[3][1] is kept_a[4][1]
    assert kept_a[1][1].data_ptr() != ev.data_ptr()
    assert chip_smoke.deblock_frame_cost(np, kept_a, kept_k)[0] == n_bytes


def test_frame_route_raises_off_the_cpu(monkeypatch):
    """deblock_frame on another device, or on a CUDA device without the
    kernel library: it raises and never reaches the plain version."""
    m = [_meta(4, 4)]
    call = lambda: deblock_cuda.deblock_frame(
        (_meta(16, 16),), m, m, m, m, _meta(64), _meta(64), 8)
    with pytest.raises(ValueError):
        call()

    def no_library(*a, **k):
        raise RuntimeError("no kernel library")

    def plain(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(deblock_cuda, "cuda_device", lambda t, what: t.device)
    monkeypatch.setattr(deblock_cuda, "load", no_library)
    monkeypatch.setattr(loopfilter, "deblock_frame", plain)
    n0 = deblock_cuda.DEBLOCK_LAUNCHES
    with pytest.raises(RuntimeError, match="no kernel library"):
        call()
    with pytest.raises(ValueError, match="1 or 3"):
        deblock_cuda.deblock_frame((_meta(16, 16),) * 2, m * 2, m * 2,
                                   m * 2, m * 2, _meta(64), _meta(64), 8)
    assert deblock_cuda.DEBLOCK_LAUNCHES == n0


def test_planner_emits_one_dbkrun_record_a_frame():
    """intra_420_8bit (a frame deblocking its three planes) through the
    port's CPU route: its filter program carries a dbk record a plane
    (the JAX interpreter's form) and one dbkrun record with every plane's
    maps, which the executor runs as one deblock_frame call; the md5 is
    the JAX package's host path's (and tests/streams/md5.txt's)."""
    import dav1d_mirror_tpu.api as japi
    from dav1d_mirror_tpu.output import MD5Muxer as JMD5Muxer
    from dav1d_mirror_tpu_torch import api as tapi
    from dav1d_mirror_tpu_torch.host.ivf import parse_ivf
    from dav1d_mirror_tpu_torch.models import frame_exec as tfe
    from dav1d_mirror_tpu_torch.output import MD5Muxer
    streams = Path(__file__).parent / "streams"
    data = (streams / "intra_420_8bit.ivf").read_bytes()
    _, _, _, frames = parse_ivf(data)

    def decode(api, mux, settings):
        dec, m = api.Decoder(settings), mux()
        for fr in frames:
            dec.send_data(fr.data)
            while (pic := dec.get_picture()) is not None:
                m.write(pic)
        return m.digest()
    records, calls = [], []
    orig_exec, orig_frame = tfe.execute_program, deblock_cuda.deblock_frame

    def spy_exec(sig, *a):
        records.append([r for r in sig[0] if r[0] in ("dbk", "dbkrun")])
        return orig_exec(sig, *a)

    def spy_frame(planes, *a):
        calls.append(len(planes))
        return orig_frame(planes, *a)
    tfe.execute_program, deblock_cuda.deblock_frame = spy_exec, spy_frame
    try:
        got = decode(tapi, MD5Muxer, tapi.Settings(device="cpu"))
    finally:
        tfe.execute_program, deblock_cuda.deblock_frame = orig_exec, \
            orig_frame
    want = decode(japi, JMD5Muxer, japi.Settings(use_tpu_inter=False,
                                                 use_tpu_filters=False))
    assert got == want == dict(line.split()[::-1] for line in (
        streams / "md5.txt").read_text().splitlines())["intra_420_8bit.ivf"]
    (recs,) = [r for r in records if r]
    assert [r[0] for r in recs] == ["dbk", "dbk", "dbk", "dbkrun"]
    dbkrun = recs[-1]
    assert [m for m in dbkrun[1]] == [tuple(r[4:8]) for r in recs[:3]]
    assert calls == [3]


@pytest.mark.parametrize("how", ["no dbkrun", "twice", "too few maps",
                                 "dbk after"])
def test_executor_refuses_dbk_records_no_dbkrun_covers(how):
    from dav1d_mirror_tpu_torch.models import frame_exec as tfe
    h = (0, (4, 4), 8)
    dbk = ("dbk", 0, True, 16, h, h, h, h, h, h)
    run = ("dbkrun", ((h, h, h, h),), h, h)
    ops = {"no dbkrun": [dbk], "twice": [dbk, run, run],
           "too few maps": [dbk, dbk, run], "dbk after": [dbk, run, dbk]}[how]
    with pytest.raises(ValueError, match="dbk"):
        tfe.check_ops(ops)
    tfe.check_ops([dbk, run])
