"""The inverse-transform kernel's CPU-side checks (its CUDA source runs
only on the card, where chip_smoke.py holds it to its plain version).

- ``tools/gen_itx_cuh.py`` regenerates ``csrc/itx_1d.cuh`` byte for byte;
- the straight-line functions of that header, read back from its text and
  evaluated in numpy int32, equal the JAX package's ``ops/itx_1d.py``
  functions (the reference the port's copy was taken from) for every
  (family, length) pair and ``iwht4``, on random inputs and on inputs at
  the int32 extremes, where the products wrap; so do its zero-tail
  variants (only the first m inputs live) with the other inputs zero;
- a zero line stays zero through every family's row pass and the
  intermediate rounding at every bit depth (the kernel's row skip);
- ``csrc/itx.cu`` dispatches each tx size with ``TX_INFO``'s (w, h,
  shift) and the CTA geometry of ``ops/itx.cta_geometry``, and its entry
  fields and flags are ``ops/itx.py``'s;
- the plain bucket function ``ops/itx.itx_bucket`` (and the wrapper's CPU
  route) equals the JAX package's numpy path (the dense block of
  ``_expand_cf``, ``_residual_multi_core``/``_residual_core`` with xp=np
  and the clip-add of ``ops/mc_tpu.scatter_add_units``) for every tx
  size at bd 8/10/12, in the three modes and for WHT, with pad rows,
  units cut by the plane's right and bottom edges, narrow and int32
  planes, and coefficients at the int16/int32 extremes.
Tolerance: exact."""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dav1d_mirror_tpu.ops import itx as jitx
from dav1d_mirror_tpu.ops.itx_1d import get_1d_fn, iwht4
from dav1d_mirror_tpu_torch.models import frame_exec as tfe
from dav1d_mirror_tpu_torch.ops import itx as titx
from dav1d_mirror_tpu_torch.ops import itx_cuda
from dav1d_mirror_tpu_torch.ops.itx_meta import (TX_INFO, WHT_WHT,
                                                 allowed_txtypes)
from dav1d_mirror_tpu_torch.ops.mc import PAD_OOB
from dav1d_mirror_tpu_torch.ops.spec_consts import clip_ranges
from dav1d_mirror_tpu_torch.tools import gen_itx_cuh

CSRC = Path(gen_itx_cuh.HEADER).resolve().parent
I32 = np.iinfo(np.int32)


def test_header_matches_its_generator():
    assert (CSRC / "itx_1d.cuh").read_text() == gen_itx_cuh.render()


@functools.lru_cache(maxsize=None)
def _header_functions():
    """{name: (n_in, [(dst, op, args)], {out index: "v<id>" or a
    constant})} read from the text of csrc/itx_1d.cuh."""
    fns = {}
    text = (CSRC / "itx_1d.cuh").read_text()
    for m in re.finditer(r"void (itx_\w+)\(const int32_t\* in, int32_t\* "
                         r"out, int32_t mn, int32_t mx\) \{\n(.*?)\n\}",
                         text, re.S):
        n_in, ops, outs = 0, [], {}
        for line in m.group(2).splitlines():
            line = line.strip()
            if mi := re.fullmatch(r"const int32_t v(\d+) = in\[(\d+)\];",
                                  line):
                assert int(mi.group(1)) == int(mi.group(2)) == n_in
                n_in += 1
            elif mo := re.fullmatch(
                    r"const int32_t v(\d+) = itx_(\w+)\((.*)\);", line):
                ops.append((int(mo.group(1)), mo.group(2),
                            [a.strip() for a in mo.group(3).split(",")]))
            elif mw := re.fullmatch(r"out\[(\d+)\] = (v\d+|-?\d+);",
                                    line):
                outs[int(mw.group(1))] = mw.group(2)
            else:
                raise AssertionError(f"{m.group(1)}: unparsed {line!r}")
        fns[m.group(1)] = (n_in, ops, outs)
    return fns


def _evaluate(fn, inputs, mn, mx):
    """Run one header function on numpy int32 vectors as C would: +, -,
    * and unary - wrap, >> is arithmetic."""
    n_in, ops, outs = fn
    v = dict(enumerate(inputs[:n_in]))
    env = {"mn": mn, "mx": mx}

    def arg(a):
        if a in env:
            return env[a]
        return v[int(a[1:])] if a.startswith("v") else int(a)
    for dst, op, args in ops:
        a = [arg(x) for x in args]
        if op == "add":
            r = a[0] + a[1]
        elif op == "sub":
            r = a[0] - a[1]
        elif op == "mul":
            r = a[0] * a[1]
        elif op == "neg":
            r = -a[0]
        elif op == "shr":
            r = a[0] >> a[1]
        elif op == "clip":
            r = np.minimum(np.maximum(a[0], a[1]), a[2])
        else:
            raise AssertionError(op)
        v[dst] = np.asarray(r, np.int32)
    shape = np.shape(inputs[0])
    return [np.broadcast_to(np.asarray(arg(outs[k]), np.int32), shape)
            for k in range(len(outs))]


@pytest.mark.parametrize("family,n", gen_itx_cuh.PAIRS)
def test_header_function_equals_itx_1d(family, n):
    fn = _header_functions()[gen_itx_cuh.fn_name(family, n)]
    n_in = min(n, 32)
    assert fn[0] == n_in and len(fn[2]) == n
    rng = np.random.default_rng(n * 7 + len(family))
    M = 64
    for bd in (8, 10, 12):
        row_min, row_max, col_min, col_max = clip_ranges(bd)
        for mn, mx in ((row_min, row_max), (col_min, col_max)):
            lanes = [rng.integers(mn, mx + 1, (n_in, M)),
                     # the int32 extremes: every product wraps
                     rng.choice([I32.min, I32.max, I32.min + 1, -1, 0, 1,
                                 1 << 30, -(1 << 30)], (n_in, M)),
                     rng.integers(I32.min, I32.max, (n_in, M),
                                  endpoint=True)]
            for x in lanes:
                x = x.astype(np.int32)
                ins = [x[k] for k in range(n_in)]
                if family == "wht":
                    want = iwht4(ins)
                else:
                    want = get_1d_fn(family, n)(ins, mn, mx)
                got = _evaluate(fn, ins, mn, mx)
                for k in range(n):
                    np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("family,n,m", gen_itx_cuh.TAIL_VARIANTS)
def test_zero_tail_variant_equals_itx_1d(family, n, m):
    """itx_<family>_<n>_in<m> reads m inputs and equals the full function
    with the other inputs zero; itx_line_<n>_tail selects it for every
    need <= m above the next smaller variant."""
    fn = _header_functions()[gen_itx_cuh.fn_name(family, n, m)]
    n_in = min(n, 32)
    assert fn[0] == m and len(fn[2]) == n
    assert gen_itx_cuh.op_count(family, n, m) < \
        gen_itx_cuh.op_count(family, n)
    lower = max([t for t in gen_itx_cuh.TAILS if t < m], default=0)
    assert [gen_itx_cuh.tail_inputs(k, n) for k in range(lower + 1, m + 1)] \
        == [m] * (m - lower)
    rng = np.random.default_rng(n * 11 + m + len(family))
    M = 64
    for bd in (8, 10, 12):
        row_min, row_max, col_min, col_max = clip_ranges(bd)
        for mn, mx in ((row_min, row_max), (col_min, col_max)):
            for x in (rng.integers(mn, mx + 1, (m, M)),
                      rng.choice(EXTREMES + (0, 1, -1), (m, M)),
                      rng.integers(I32.min, I32.max, (m, M), endpoint=True)):
                x = x.astype(np.int32)
                ins = [x[k] for k in range(m)]
                zero = np.zeros(M, np.int32)
                want = get_1d_fn(family, n)(ins + [zero] * (n_in - m), mn, mx)
                got = _evaluate(fn, ins, mn, mx)
                for k in range(n):
                    np.testing.assert_array_equal(got[k], want[k])


def test_tail_inputs_match_the_header():
    """The header's itx_tail_inputs is tools/gen_itx_cuh.tail_inputs."""
    text = (CSRC / "itx_1d.cuh").read_text()
    body = re.search(r"itx_tail_inputs\(int need, int n\) \{\s*return "
                     r"(.*?);\s*\}", text, re.S).group(1)
    expr = " ".join(body.split()).replace("&&", "and")
    # C's a ? b : c, right-nested, as Python conditionals
    for m in gen_itx_cuh.TAILS:
        expr = expr.replace(f"(need <= {m} and {m} < n) ? {m} :",
                            f"{m} if (need <= {m} and {m} < n) else")
    expr = expr.replace("(n < 32 ? n : 32)", "min(n, 32)")
    for n in (4, 8, 16, 32, 64):
        for need in range(0, min(n, 32) + 1):
            assert eval(expr, {"need": need, "n": n}) == \
                gen_itx_cuh.tail_inputs(need, n), (need, n)


@pytest.mark.parametrize("family,n", [p for p in gen_itx_cuh.PAIRS
                                      if p[0] != "wht"])
def test_zero_line_stays_zero_through_the_row_pass(family, n):
    """The precondition of the kernel's row skip: a zero row gives a zero
    row through the row family and the intermediate round and clip, for
    every shift of a tx size whose rows have length n and every bit
    depth's clip ranges."""
    zero = [np.zeros(4, np.int32)] * min(n, 32)
    shifts = {s for w, _, s in TX_INFO.values() if w == n}
    for bd in (8, 10, 12):
        row_min, row_max, col_min, col_max = clip_ranges(bd)
        out = get_1d_fn(family, n)(zero, row_min, row_max)
        for shift in shifts:
            rnd = (1 << shift) >> 1
            for o in out:
                t = np.clip((np.asarray(o, np.int32) + rnd) >> shift,
                            col_min, col_max)
                assert not t.any(), (family, n, bd, shift)


def _cu_table(src, name):
    body = re.search(rf"constexpr int {name}\[19\] = \{{(.*?)\}};", src,
                     re.S).group(1)
    return [int(v) for v in body.replace("\n", " ").split(",")]


def test_kernel_launches_each_tx_size_with_its_geometry():
    """itx.cu's tables give each tx size TX_INFO's (w, h, shift) and
    ops/itx.cta_geometry's blocks a CTA; the dispatch sends each size to
    its own instantiation."""
    src = (CSRC / "itx.cu").read_text()
    w, h, sh = (_cu_table(src, n) for n in ("TX_W", "TX_H", "TX_SHIFT"))
    assert {tx: (w[tx], h[tx], sh[tx]) for tx in range(19)} == TX_INFO
    nt = int(re.search(r"constexpr int CTA_THREADS = (\d+);", src).group(1))
    assert nt == titx.CTA_THREADS
    g = _cu_table(src, "TX_BLOCKS_PER_CTA")
    for tx in range(19):
        t, blocks = titx.cta_geometry(tx)
        assert (nt // g[tx], g[tx]) == (t, blocks), tx
        assert t * blocks == nt
    body = re.search(r"void dispatch\(.*?\n\}\n", src, re.S).group(0)
    cases = re.findall(r"case (\d+): itx_block<(\d+)>", body)
    assert sorted(int(a) for a, _ in cases) == list(range(19))
    assert all(a == b for a, b in cases), cases
    e_fields = re.search(r"enum \{\s*(E_TX.*?ENTRY)\s*\};", src,
                         re.S).group(1)
    names = [n.strip() for n in e_fields.split(",")]
    assert names[-1] == "ENTRY" and len(names) - 1 == titx.ENTRY
    for i, n in enumerate(names[:-1]):
        assert getattr(titx, n) == i, n
    for n in ("F_WHT", "F_VALS16", "F_POS16", "F_DENSE", "F_FIXED"):
        assert int(re.search(rf"{n} = (\d+)", src).group(1)) == \
            getattr(titx, n), n


# ---------------------------------------------------------------------
# the plain bucket function against the JAX package's numpy path
# ---------------------------------------------------------------------
EXTREMES = (I32.min, I32.max, -32768, 32767, -(1 << 19), (1 << 19) - 1)


def _bucket(tx, bd, seed, wht=False):
    """A bucket of 6 units and 2 pad rows on a plane that cuts the units
    of its last grid column and row: dense coefficients (the last real
    block at the int16/int32 extremes), the compact (vals, pos) the
    planner emits, selectors, origins and a plane of each dtype."""
    rng = np.random.default_rng(seed)
    w, h, _ = TX_INFO[tx]
    sw, sh = min(w, 32), min(h, 32)
    B, n_real = 8, 6
    cf = np.zeros((B, sh, sw), np.int32)
    for i in range(n_real):
        ky, kx = rng.integers(1, sh + 1), rng.integers(1, sw + 1)
        cf[i, :ky, :kx] = rng.integers(-900 << (bd - 8), 900 << (bd - 8),
                                       (ky, kx))
    cf[n_real - 1, :2, :2] = rng.choice(EXTREMES, (2, 2))
    cf[n_real - 2, 0, 0] = EXTREMES[bd % 4]
    vals, pos, K = tfe.compact_cf(cf)
    Kp = 1 << (K - 1).bit_length()            # pad lanes, as the planner
    S = sh * sw
    vals = np.pad(vals, ((0, 0), (0, Kp - K)))
    pos = np.pad(pos, ((0, 0), (0, Kp - K)), constant_values=S)
    if wht:
        sel = WHT_WHT
        sel_np = None
    else:
        types = [t for t in allowed_txtypes(tx) if t != WHT_WHT]
        sel_np = np.array([titx.itx_multi_sel(tx, types[i % len(types)])
                           for i in range(B)], np.int32)
        sel = (torch.from_numpy(sel_np[:, 0].copy()),
               torch.from_numpy(sel_np[:, 1].copy()))
    # a 3 x 3 grid of unit cells; the plane cuts the last column and row
    Hp, Wp = 2 * h + (h + 1) // 2, 2 * w + (w + 1) // 2
    cells = rng.permutation(9)[:B]
    ys = (cells // 3 * h).astype(np.int32)
    xs = (cells % 3 * w).astype(np.int32)
    ys[n_real:] = PAD_OOB
    planes = {dt: rng.integers(0, 1 << bd, (Hp, Wp)).astype(dt)
              for dt in (np.int32, np.uint8 if bd == 8 else np.int16)}
    return cf, vals, pos, sel, sel_np, ys, xs, planes


def _jax_residuals(cf, sel_np, tx, bd):
    if sel_np is None:
        return np.asarray(jitx._residual_core(cf, tx, WHT_WHT, bd, np))
    return np.asarray(jitx._residual_multi_core(cf, sel_np[:, 0],
                                                sel_np[:, 1], tx, bd, np))


def _jax_scatter(plane, res, ys, xs, bd, add):
    """The reference's scatter: units' elements inside the plane, read
    (clamped gather) and written (dropped outside)."""
    out = plane.astype(np.int64)
    B, uh, uw = res.shape
    H, W = plane.shape
    yy = ys.astype(np.int64)[:, None, None] + np.arange(uh)[None, :, None]
    xx = xs.astype(np.int64)[:, None, None] + np.arange(uw)[None, None, :]
    yy, xx = np.broadcast_arrays(yy, xx)
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    v = res[ok].astype(np.int64)
    if add:
        v = np.clip(out[yy[ok], xx[ok]] + v, 0, (1 << bd) - 1)
    out[yy[ok], xx[ok]] = v
    return out.astype(np.int32).astype(plane.dtype)


def _check_modes(tx, bd, wht):
    cf, vals, pos, sel, sel_np, ys, xs, planes = _bucket(
        tx, bd, 100 * tx + bd + wht, wht)
    want = _jax_residuals(cf, sel_np, tx, bd)
    t = torch.from_numpy
    # the JAX executor's hres cast: int16 at bd 8, int32 above
    hres_dt = np.int16 if bd == 8 else np.int32
    out_dtype = torch.int16 if bd == 8 else torch.int32
    for fn in (titx.itx_bucket, itx_cuda.itx_bucket):
        got = fn("hres", t(vals), t(pos), sel, tx, bd, out_dtype=out_dtype)
        assert torch.equal(got, t(want.astype(hres_dt)))
    for dt, plane in planes.items():
        for mode in ("add", "raw"):
            ref = _jax_scatter(plane, want, ys, xs, bd, mode == "add")
            got = itx_cuda.itx_bucket(mode, t(vals), t(pos), sel, tx, bd,
                                      t(plane.copy()), t(ys), t(xs))
            assert got.dtype == t(plane).dtype
            assert torch.equal(got, t(ref)), (mode, dt)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("tx", range(19))
def test_itx_bucket_matches_jax(tx, bd):
    _check_modes(tx, bd, wht=False)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_itx_bucket_wht_matches_jax(bd):
    _check_modes(0, bd, wht=True)


@pytest.mark.parametrize("tx", [0, 4, 17])
def test_dense_routes_match_jax(tx):
    """Dense blocks (pos None) of one transform type, as the parallel
    paths call them: the wrapper's CPU route and the plain version."""
    cf, _, _, _, _, _, _, _ = _bucket(tx, 10, 7 + tx)
    txtp = allowed_txtypes(tx)[-1 if tx == 0 else 0]
    want = np.asarray(jitx._residual_core(cf, tx, txtp, 10, np))
    t = torch.from_numpy(cf).reshape(len(cf), -1)
    for fn in (itx_cuda.itx_bucket, titx.itx_bucket):
        got = fn("hres", t, None, txtp, tx, 10)
        assert torch.equal(got, torch.from_numpy(want))


def test_wrapper_routes_cpu_to_plain_and_refuses_other_devices():
    _, vals, pos, sel, _, ys, xs, planes = _bucket(1, 8, 3)
    t = torch.from_numpy
    n = itx_cuda.ITX_LAUNCHES
    plane = t(planes[np.int32].copy())
    itx_cuda.itx_bucket("add", t(vals), t(pos), sel, 1, 8, plane, t(ys),
                        t(xs))
    itx_cuda.itx_bucket("hres", torch.zeros((2, 64), dtype=torch.int32),
                        None, 0, 1, 8)
    assert itx_cuda.ITX_LAUNCHES == n      # kernel launches only
    with pytest.raises(ValueError):
        itx_cuda.itx_bucket("hres", t(vals).to("meta"), t(pos).to("meta"),
                            sel, 1, 8)
    with pytest.raises(ValueError):
        titx.itx_bucket("sub", t(vals), t(pos), sel, 1, 8)
