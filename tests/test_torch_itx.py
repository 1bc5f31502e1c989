"""Inverse transforms of the PyTorch port (dav1d_mirror_tpu_torch/ops/itx.py)
and the residual expand/scatter of its executor against the JAX package,
on the same numpy inputs. Tolerance: exact.

Every (tx size, tx type) pair is checked against the JAX package's
composer run on numpy (``_residual_core`` / ``_residual_multi_core`` with
xp=np, the same code the jitted path traces); jit-compiling every tx size
costs over a minute, so three sizes are also checked against the jitted
``itx_residual_multi``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dav1d_mirror_tpu.models import frame_exec as jfe
from dav1d_mirror_tpu.ops import itx as jitx
from dav1d_mirror_tpu_torch.models import frame_exec as tfe
from dav1d_mirror_tpu_torch.ops import itx as titx
from dav1d_mirror_tpu_torch.ops import itx_cuda
from dav1d_mirror_tpu_torch.ops.itx_meta import (TX_INFO, WHT_WHT,
                                                 allowed_txtypes)
from dav1d_mirror_tpu_torch.ops.mc import PAD_OOB


def _coefs(rng, n, tx):
    """(n, sh, sw) int32 batch: a random low-frequency corner, zeros
    past it, as eob-truncated scans leave them."""
    w, h, _ = TX_INFO[tx]
    sw, sh = min(w, 32), min(h, 32)
    cf = np.zeros((n, sh, sw), np.int32)
    for i in range(n):
        ky, kx = rng.integers(1, sh + 1), rng.integers(1, sw + 1)
        cf[i, :ky, :kx] = rng.integers(-900, 900, (ky, kx))
    return cf


def _batch(tx, bd, seed):
    """Batch 3 of every allowed non-WHT type of `tx`, with its selectors."""
    rng = np.random.default_rng(seed)
    types = [t for t in allowed_txtypes(tx) if t != WHT_WHT]
    cf = _coefs(rng, 3 * len(types), tx)
    sel = np.array([titx.itx_multi_sel(tx, t) for t in types
                    for _ in range(3)], np.int32)
    return types, cf, sel


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("tx", range(19))
def test_itx_residual_every_type_matches_jax(tx, bd):
    types, cf, _ = _batch(tx, bd, tx * 10 + bd)
    if tx == 0:
        types = types + [WHT_WHT]
    for i, txtp in enumerate(types):
        c = cf[3 * (i % (len(cf) // 3)):][:3]
        want = jitx._residual_core(c, tx, txtp, bd, np)
        got = titx.itx_residual(torch.from_numpy(c), tx, txtp, bd)
        assert got.dtype == torch.int32
        assert torch.equal(got, torch.from_numpy(np.asarray(want))), txtp


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("tx", range(19))
def test_itx_residual_multi_matches_jax(tx, bd):
    _, cf, sel = _batch(tx, bd, 1000 + tx * 10 + bd)
    want = jitx._residual_multi_core(cf, sel[:, 0], sel[:, 1], tx, bd, np)
    got = titx.itx_residual_multi(torch.from_numpy(cf),
                                  torch.from_numpy(sel[:, 0].copy()),
                                  torch.from_numpy(sel[:, 1].copy()), tx, bd)
    assert torch.equal(got, torch.from_numpy(np.asarray(want)))


@pytest.mark.parametrize("tx", [0, 7, 14])
def test_itx_residual_multi_matches_jitted_jax(tx):
    _, cf, sel = _batch(tx, 8, 77 + tx)
    want = np.asarray(jitx.itx_residual_multi(
        jnp.asarray(cf), jnp.asarray(sel[:, 0]), jnp.asarray(sel[:, 1]),
        tx, 8))
    got = titx.itx_residual_multi(torch.from_numpy(cf),
                                  torch.from_numpy(sel[:, 0].copy()),
                                  torch.from_numpy(sel[:, 1].copy()), tx, 8)
    assert torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("tx", [0, 1, 8])
def test_expand_cf_drops_out_of_range_lanes(tx):
    rng = np.random.default_rng(tx)
    cf = _coefs(rng, 6, tx)
    cf[2] = 0                      # an all-zero row: every lane is a pad
    vals, pos, K = tfe.compact_cf(cf)
    S = cf.shape[1] * cf.shape[2]
    # widen K as the planner does: pad lanes carry position S
    vals = np.pad(vals, ((0, 0), (0, 3)))
    pos = np.pad(pos, ((0, 0), (0, 3)), constant_values=S)
    want = np.asarray(jfe._expand_cf(jnp.asarray(vals), jnp.asarray(pos),
                                     cf.shape[1], cf.shape[2]))
    np.testing.assert_array_equal(want, cf)
    got = titx._expand_cf(torch.from_numpy(vals), torch.from_numpy(pos),
                          cf.shape[1], cf.shape[2])
    assert torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("tx", [0, 1, 7])
def test_resid_scatter_multi_masks_pad_rows(tx, bd):
    """Clip-add of a residual bucket onto a plane, with PAD_OOB pad rows
    (the reference gathers them clamped and drops their writes)."""
    rng = np.random.default_rng(50 + tx + bd)
    w, h, _ = TX_INFO[tx]
    Hp, Wp = 64, 64
    plane = rng.integers(0, 1 << bd, (Hp, Wp)).astype(np.int32)
    _, cf, sel = _batch(tx, bd, tx + 3)
    n = min(len(cf), (Hp // h) * (Wp // w))
    cf, sel = cf[:n], sel[:n]
    cells = rng.permutation((Hp // h) * (Wp // w))[:n]
    ys = (cells // (Wp // w) * h).astype(np.int32)
    xs = (cells % (Wp // w) * w).astype(np.int32)
    ys[-2:] = PAD_OOB              # pad rows
    want = np.asarray(jfe._resid_scatter_multi(
        jnp.asarray(plane), jnp.asarray(cf), jnp.asarray(sel[:, 0]),
        jnp.asarray(sel[:, 1]), jnp.asarray(ys), jnp.asarray(xs), tx, bd))
    # the port's dense route (pos None), as parallel/tile_decode.py calls it
    got = itx_cuda.itx_bucket(
        "add", torch.from_numpy(cf.reshape(len(cf), -1)), None,
        (torch.from_numpy(sel[:, 0].copy()),
         torch.from_numpy(sel[:, 1].copy())), tx, bd,
        torch.from_numpy(plane.copy()), torch.from_numpy(ys),
        torch.from_numpy(xs))
    assert torch.equal(got, torch.from_numpy(np.array(want)))
