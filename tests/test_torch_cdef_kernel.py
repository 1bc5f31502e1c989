"""The CDEF kernels' CPU-side checks (their CUDA source runs only on the
card, where chip_smoke.py and tools/filter_cases.py hold them to their
plain versions).

- the wrappers' CPU route equals the JAX package's ``cdef_frame_tpu`` on
  synthetic frames of ``tools/filter_cases``: 64x64 luma in 4:2:0,
  4:2:2, 4:4:4 and monochrome, odd block counts (80x96 with 17x21 4x4
  units), bd 8/10/12, a skipped 64x64 unit, random noskip and strengths;
  ``cdef_dir`` and ``cdef_filter_plane`` equal the JAX package's
  ``cdef_dir_tpu`` and ``cdef_filter_plane_tpu`` on some of theirs
  (smooth and high-contrast planes; per-block maps at 8x8 and 4x4
  blocks; the plain version's halo rows, which the JAX function lacks,
  against the same region one block row lower in a taller plane);
- the kernel's direction table is ``spec_consts.CDEF_DIRECTIONS`` and
  ``cdef.UV_DIRS_TBL``, its cost weights dav1d's div_table, and the
  ctypes mirrors of its three argument structs match the source field by
  field;
- the packing of the frame, plane and direction arguments: strides of
  transposed and sliced views, element widths of int8/int16/int32/bool
  maps and strength tables, the chroma block sizes, damping and
  UV_DIRS_TBL row of each layout, halo rows;
- the launch counter counts kernel launches only, and a tensor on another
  device, or on a CUDA device without the kernel library, raises instead
  of reaching the plain version;
- the frame kernel's direction search (a thread a class, eight a block):
  its bins are the plain version's, and a numpy model of it (row
  partials reduced in another order, the 128s taken off once a bin)
  equals ``cdef.cdef_dir`` at bd 8, 10 and 12 on extreme, random and
  flat pixels, with bins whose uint32 sums wrap.
Tolerance: exact."""
import ctypes as ct
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dav1d_mirror_tpu.ops.cdef_tpu import (cdef_dir_tpu, cdef_filter_plane_tpu,
                                           cdef_frame_tpu)
from dav1d_mirror_tpu_torch.ops import cdef, cdef_cuda
from dav1d_mirror_tpu_torch.ops.spec_consts import CDEF_DIRECTIONS
from dav1d_mirror_tpu_torch.tools import filter_cases as fc

SRC = (Path(cdef_cuda.__file__).resolve().parent.parent / "csrc" /
       "cdef.cu").read_text()


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_kw(kw):
    return {k: tuple(_t(x) for x in v) if isinstance(v, (list, tuple))
            else _t(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


# the cases held to the JAX package (its functions compile for each
# shape, about 1.6 s on the CPU): every layout, bit depth and block size,
# odd block counts, a halo
JAX_FRAMES = {"4:2:0": (8,), "4:2:0 odd": (10,), "4:2:2": (12,),
              "4:4:4": (10,), "monochrome": (8,)}
JAX_PLANES = ("cdef_filter_plane 8x8 blocks bd8",
              "cdef_filter_plane 8x8 blocks bd10 halo",
              "cdef_filter_plane 4x4 blocks bd12")


@pytest.mark.parametrize("shape", fc.CDEF_SHAPES, ids=lambda s: s[0])
def test_cdef_frame_cpu_route_matches_jax(shape):
    cases = [(lb, kw) for lb, kw in fc.cdef_frame_cases(
        np.random.default_rng(3)) if lb.startswith(
            f"cdef_frame {shape[0]} {shape[1][0]}x{shape[1][1]} ")
        and kw["bitdepth"] in JAX_FRAMES[shape[0]]]
    assert len(cases) == len(JAX_FRAMES[shape[0]])
    n0 = cdef_cuda.CDEF_LAUNCHES
    for label, kw in cases:
        want = cdef_frame_tpu(
            tuple(jnp.asarray(p) for p in kw["planes"]),
            jnp.asarray(kw["cdef_idx_map"]), jnp.asarray(kw["noskip4"]),
            jnp.asarray(kw["y_strengths"]), jnp.asarray(kw["uv_strengths"]),
            damping=kw["damping"], bitdepth=kw["bitdepth"],
            ss_hor=kw["ss_hor"], ss_ver=kw["ss_ver"],
            monochrome=kw["monochrome"])
        got = cdef_cuda.cdef_frame(**_torch_kw(kw))
        assert len(got) == (1 if kw["monochrome"] else 3)
        for w, g in zip(want, got):
            assert torch.equal(g, _t(w)), label
        assert not torch.equal(got[0], _t(kw["planes"][0])), label
    assert cdef_cuda.CDEF_LAUNCHES == n0      # kernel launches only


def test_cdef_dir_and_filter_plane_cpu_route_match_jax():
    rng = np.random.default_rng(4)
    for label, kw in fc.cdef_dir_cases(rng):
        if kw["bitdepth"] != 12:    # the frames cover bd 8 and 10
            continue
        want = cdef_dir_tpu(jnp.asarray(kw["plane"]), kw["h8"], kw["w8"],
                            kw["bitdepth"])
        got = cdef_cuda.cdef_dir(**_torch_kw(kw))
        for w, g in zip(want, got):
            assert torch.equal(g, _t(w)), label
    for label, kw in fc.cdef_plane_cases(rng):
        if label not in JAX_PLANES:
            continue
        got = cdef_cuda.cdef_filter_plane(**_torch_kw(kw))
        if "halo" not in kw:
            want = cdef_filter_plane_tpu(*(jnp.asarray(kw[k]) for k in (
                "plane", "src", "dir_map", "pri_map", "sec_map")),
                kw["damping"], jnp.asarray(kw["active"]), kw["bitdepth"],
                kw["bw"], kw["bh"])
            assert torch.equal(got, _t(want)), label
            continue
        # the JAX function has no halo rows: the same region one block row
        # lower in a taller plane, the halo rows just above it and an
        # inactive block row on top (its other rows are never read)
        top, bot = kw["halo"]
        assert (bot == cdef.MISSING).all()
        bh, plane = kw["bh"], kw["plane"]
        H = kw["dir_map"].shape[0] * bh
        tall = np.concatenate([np.zeros((bh - 2, plane.shape[1]), np.int32),
                               top, plane[:H]])

        def lower(m):
            return np.concatenate([np.zeros((1,) + m.shape[1:], m.dtype),
                                   m])
        want = cdef_filter_plane_tpu(
            jnp.asarray(tall), jnp.asarray(tall),
            *(jnp.asarray(lower(kw[k])) for k in ("dir_map", "pri_map",
                                                   "sec_map")),
            kw["damping"], jnp.asarray(lower(kw["active"])), kw["bitdepth"],
            kw["bw"], bh)
        assert torch.equal(got[:H], _t(np.asarray(want)[bh:])), label
        assert torch.equal(got[H:], _t(plane[H:])), label
        plain = cdef_cuda.cdef_filter_plane(**_torch_kw(
            {**kw, "halo": None}))
        assert not torch.equal(got, plain), f"{label}: the halo was unread"


def test_tables_match_the_source():
    """The __constant__ tables come from spec_consts and cdef (uploaded
    from cdef_cuda.TABLE), laid out as the kernel declares them, and the
    cost weights are dav1d's div_table."""
    assert "__constant__ int c_dirs[12][2][2];" in SRC
    assert "__constant__ int c_uv_dirs[2][8];" in SRC
    assert "cudaMemcpyToSymbol(c_uv_dirs, t + 48" in SRC
    t = cdef_cuda.TABLE
    assert t.dtype == np.int32 and t.shape == (64,)
    assert t[:48].reshape(12, 2, 2).tolist() == [
        [list(p) for p in row] for row in CDEF_DIRECTIONS]
    assert t[48:].reshape(2, 8).tolist() == cdef.UV_DIRS_TBL.tolist()
    assert "#define CDEF_DIV(n) (840u / ((n) + 1u))" in SRC
    assert [840 // (n + 1) for n in range(7)] == cdef._DIV.tolist()
    assert f"#define MISSING ({cdef.MISSING})" in SRC


def _struct_fields(name):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, SRC, re.S)[1]
    out = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        ctype, names = re.match(r"(.*?)(\w+(?:\[\w+\])?(?:\s*,\s*\w+)*)$",
                                line).groups()
        for n in names.split(","):
            out.append((ctype.strip(), n.strip()))
    return out


@pytest.mark.parametrize("mirror", [cdef_cuda.DirArgs, cdef_cuda.PlaneArgs,
                                    cdef_cuda.FilterArgs],
                         ids=lambda m: m.__name__)
def test_args_structs_mirror_the_source(mirror):
    kinds = {ct.c_void_p: lambda c: c.endswith("*"),
             ct.c_longlong: lambda c: c == "long long",
             ct.c_int: lambda c: c == "int"}
    fields = _struct_fields(mirror.__name__)
    assert len(fields) == len(mirror._fields_)
    for (ctype, name), (pname, ptype) in zip(fields, mirror._fields_):
        if name == "pl[MAX_PLANES]":
            assert (pname, ptype) == ("pl", cdef_cuda.PlaneArgs *
                                      cdef_cuda.MAX_PLANES)
            assert ctype == "PlaneArgs"
            continue
        assert pname == name
        assert kinds[ptype](ctype), (name, ctype, ptype)


def test_frame_args_packing():
    """Each layout's chroma block size, damping and UV_DIRS_TBL row; the
    maps' strides and element widths."""
    luma = torch.zeros((72, 96), dtype=torch.int32)
    for ssh, ssv, row in ((1, 1, 0), (1, 0, 1), (0, 0, 0)):
        chroma = [torch.zeros((72 >> ssv, 96 >> ssh), dtype=torch.int32)
                  for _ in range(2)]
        planes = [luma] + chroma
        outs = [torch.empty_like(p) for p in planes]
        idx = torch.zeros((2, 3), dtype=torch.int8)
        ns = torch.zeros((17, 23), dtype=torch.bool)
        ystr = torch.zeros(8, dtype=torch.int16)
        uvstr = torch.zeros(8, dtype=torch.int32)
        a = cdef_cuda.frame_args(planes, outs, idx.T.contiguous().T, ns,
                                 ystr, uvstr, 7, 10, ssh, ssv)
        assert (a.hb, a.wb, a.bh4, a.bw4) == (9, 12, 17, 23)
        assert (a.uv_row, a.bd) == (row, 10)
        assert (a.idx_s0, a.idx_s1, a.idx_es) == (1, 2, 1)
        assert (a.ns_s0, a.ns_s1, a.ns_es) == (23, 1, 1)
        assert (a.ystr_s0, a.ystr_es, a.uvstr_es) == (1, 2, 4)
        for i, (p, o) in enumerate(zip(planes, outs)):
            pa = a.pl[i]
            assert (pa.src, pa.plane, pa.out) == (p.data_ptr(), p.data_ptr(),
                                                  o.data_ptr())
            assert (pa.Hp, pa.Wp, pa.src_sr, pa.out_sr) == (
                p.shape[0], p.shape[1], p.shape[1], o.shape[1])
            assert (pa.bw, pa.bh) == ((8 >> ssh, 8 >> ssv) if i else (8, 8))
            assert (pa.damping, pa.vec) == ((6, 1) if i else (7, 1))
            assert (pa.top, pa.bot) == (None, None)


def test_plane_and_dir_args_packing():
    plane = torch.zeros((40, 64), dtype=torch.int32)
    view = plane.T                  # a transposed view: strides (1, 64)
    out = torch.empty((64, 40), dtype=torch.int32)
    top = torch.zeros((2, 80), dtype=torch.int32)[:, 8:]
    bot = torch.zeros((2, 72), dtype=torch.int32)
    p = cdef_cuda.plane_args(view, view, out, 4, 8, 5, halo=(top, bot))
    assert (p.src_sr, p.src_sc, p.pl_sr, p.pl_sc) == (1, 64, 1, 64)
    assert (p.out_sr, p.out_sc, p.Hp, p.Wp) == (40, 1, 64, 40)
    assert (p.top_sr, p.top_sc, p.bot_sr, p.bot_sc) == (80, 1, 72, 1)
    assert (p.top, p.bot) == (top.data_ptr(), bot.data_ptr())
    assert (p.bw, p.bh, p.damping, p.vec) == (4, 8, 5, 0)   # column
    # stride 64: no 16-byte rows
    dirm = torch.empty((5, 8), dtype=torch.int32)
    d = cdef_cuda.dir_args(view, dirm, dirm, 5, 8, 12)
    assert (d.sr, d.sc, d.h8, d.w8, d.bd) == (1, 64, 5, 8, 12)


def _meta(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _frame_meta():
    return ((_meta(64, 64), _meta(32, 32), _meta(32, 32)), _meta(1, 1),
            _meta(16, 16, dtype=torch.bool), _meta(8), _meta(8))


def _calls():
    m = _meta
    return (lambda: cdef_cuda.cdef_frame(*_frame_meta(), 5, 8, 1, 1, False),
            lambda: cdef_cuda.cdef_dir(m(64, 64), 8, 8, 8),
            lambda: cdef_cuda.cdef_filter_plane(
                m(64, 64), m(64, 64), m(8, 8), m(8, 8), m(8, 8), 5,
                m(8, 8, dtype=torch.bool), 8, 8, 8))


def test_other_devices_raise():
    for call in _calls():
        with pytest.raises(ValueError):
            call()


def test_cuda_route_without_the_library_raises(monkeypatch):
    """A tensor taken for a CUDA one, with no kernel library to load: each
    call raises and never reaches the plain version."""
    def no_library(*a, **k):
        raise RuntimeError("no kernel library")

    def plain(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(cdef_cuda, "cuda_device", lambda t, what: t.device)
    monkeypatch.setattr(cdef_cuda, "_lib_on", no_library)
    for name in ("cdef_frame", "cdef_dir", "cdef_filter_plane"):
        monkeypatch.setattr(cdef, name, plain)
    n0 = cdef_cuda.CDEF_LAUNCHES
    for call in _calls():
        with pytest.raises(RuntimeError, match="no kernel library"):
            call()
    assert cdef_cuda.CDEF_LAUNCHES == n0


def test_cpu_route_counts_nothing():
    rng = np.random.default_rng(9)
    n0 = cdef_cuda.CDEF_LAUNCHES
    (_, kw), = fc.cdef_dir_cases(rng)[:1]
    cdef_cuda.cdef_dir(**_torch_kw(kw))
    (_, kw), = fc.cdef_plane_cases(rng)[:1]
    cdef_cuda.cdef_filter_plane(**_torch_kw(kw))
    assert cdef_cuda.CDEF_LAUNCHES == n0


def test_block_sizes_the_kernel_cannot_take_raise(monkeypatch):
    """Blocks other than 4 or 8 pixels a side raise on the CUDA route (the
    kernel's tiles are 8 x 4 blocks of 4 or 8 pixels)."""
    monkeypatch.setattr(cdef_cuda, "cuda_device", lambda t, what: t.device)
    m = _meta
    with pytest.raises(ValueError, match="4 or 8 a side"):
        cdef_cuda.cdef_filter_plane(m(64, 64), m(64, 64), m(8, 8), m(8, 8),
                                    m(8, 8), 5, m(8, 8, dtype=torch.bool), 8,
                                    2, 8)


# ---- the frame kernel's direction search (csrc/cdef.cu class_cost) ----

# the bin of pixel (y, x) of an 8x8 block in each direction class, in
# dav1d's cost order, as class_cost indexes them
BINS = (lambda y, x: y + x, lambda y, x: y + (x >> 1), lambda y, x: y,
        lambda y, x: 3 + y - (x >> 1), lambda y, x: 7 + y - x,
        lambda y, x: 3 - (y >> 1) + x, lambda y, x: x,
        lambda y, x: (y >> 1) + x)


def _cooperative_dir(plane, h8, w8, bd):
    """The frame kernel's search in numpy: a class a thread (eight a
    block), each summing its bins a row at a time, here the rows' partial
    bins reduced last row first (the plain version sums each bin's pixels
    at once); the 128s of (v >> (bd - 8)) - 128 taken off once a bin;
    squares weighed in uint32; the first maximum. Also returns whether a
    bin's sum went below zero, so that it and its square wrapped in
    uint32."""
    u = np.uint32
    blocks = np.asarray(plane[:8 * h8, :8 * w8], np.int64).reshape(
        h8, 8, w8, 8).transpose(0, 2, 1, 3)
    shifted = (blocks >> (bd - 8)).astype(u)
    weights = cdef._cost_weights()
    cost = np.zeros((8, h8, w8), u)
    wrapped = False
    for c, fn in enumerate(BINS):
        nb = len(weights[c])
        rows = np.zeros((8, nb, h8, w8), u)
        count = np.zeros(nb, np.int64)
        for y in range(8):
            for x in range(8):
                rows[y, fn(y, x)] += shifted[:, :, y, x]
                count[fn(y, x)] += 1
        with np.errstate(over="ignore"):
            bins = np.zeros((nb, h8, w8), u)
            for y in reversed(range(8)):
                bins += rows[y]
            bins -= (128 * count).astype(u)[:, None, None]
            sq = bins * bins * weights[c].astype(u)[:, None, None]
        cost[c] = sq.sum(axis=0, dtype=u)
        wrapped |= bool((bins >= 1 << 31).any())
    best = np.argmax(cost, axis=0)
    pick = lambda d: np.take_along_axis(cost, d[None], 0)[0]
    var = ((pick(best) - pick(best ^ 4)) >> u(10)).astype(np.int32)
    return best.astype(np.int32), var, wrapped


def test_class_bins_match_the_source_and_the_plain_version():
    """class_cost's bin of each pixel, class by class, is the plain
    version's one-hot bin assignment, and the frame kernel gives class w
    to warp w."""
    flat = " ".join(SRC.split())
    assert ("C == 0 ? y + x : C == 1 ? y + (x >> 1) : C == 2 ? y : C == 3 "
            "? 3 + y - (x >> 1) : C == 4 ? 7 + y - x : C == 5 ? 3 - (y >> "
            "1) + x : C == 6 ? x : (y >> 1) + x") in flat
    for c in range(8):
        assert f"case {c}: c = class_cost<{c}>(blk, sw, sh); break;" in flat \
            or f"default: c = class_cost<{c}>(blk, sw, sh); break;" in flat
    for c, (fn, mat) in enumerate(zip(BINS, cdef._build_partial_mats())):
        for y in range(8):
            for x in range(8):
                assert mat[y * 8 + x, fn(y, x)] == 1, (c, y, x)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_cooperative_direction_search_matches_cdef_dir(bd):
    """The model of the frame kernel's search equals ops/cdef.cdef_dir on
    pixels at the extremes (0 and the bit depth's maximum: bins of
    negative sums, whose uint32 values and squares wrap), on a plane of
    random pixels and on flat blocks (ties: the first maximum)."""
    rng = np.random.default_rng(bd)
    h8, w8 = 6, 7
    top = (1 << bd) - 1
    planes = [(rng.random((8 * h8, 8 * w8)) < 0.5) * top,
              np.where(np.add.outer(np.arange(8 * h8), np.arange(8 * w8))
                       % 16 < 8, 0, top),
              rng.integers(0, top + 1, (8 * h8, 8 * w8)),
              np.full((8 * h8, 8 * w8), top // 3)]
    wrapped = False
    for plane in planes:
        plane = plane.astype(np.int32)
        d, v, w = _cooperative_dir(plane, h8, w8, bd)
        wd, wv = cdef.cdef_dir(_t(plane), h8, w8, bd)
        assert np.array_equal(d, wd.numpy()) and np.array_equal(v, wv.numpy())
        wrapped |= w
    assert wrapped, "no bin wrapped"
