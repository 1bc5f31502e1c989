"""The PyTorch port's frame executor (dav1d_mirror_tpu_torch/models/
frame_exec.py) against the JAX package's eager interpreter
(dav1d_mirror_tpu/models/frame_exec._interpreter) on the same packed
program: frame 1 (inter) of a miniature config 2 stream, as the port's
planner packs it. Planes and host residuals must be equal.

The filter chain's loop restoration (snap/lrw/lrs) runs on a program the
port's LR planner packs for a synthetic frame, held to the same
interpreter.

Also: every op kind outside the port so far (the device intra engine's,
and the reference's Pallas-only and dense forms) raises
NotImplementedError, and the int16 side buffer refuses values it would
wrap."""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import bench  # noqa: E402
from dav1d_mirror_tpu.models import frame_exec as jfe  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
from dav1d_mirror_tpu_torch.models import filters as tfilters  # noqa: E402
from dav1d_mirror_tpu_torch.ops.mc import PAD_OOB  # noqa: E402
from test_e2e_inter import build_stream  # noqa: E402

MINI_CONFIG2 = dict(bench.E2E_CONFIGS["e2e_1080p_inter_cdef"], w=128, h=64,
                    n_inter=3)


@pytest.fixture(scope="module")
def mini_programs():
    """(sig, desc, desc16, desc8, refsrc as numpy) of the programs the
    port executes for the first two frames of the mini stream."""
    _, data, _ = build_stream(MINI_CONFIG2, 9)
    _, _, _, frames = parse_ivf(data)
    seen = []
    orig = tfe.execute_program

    def spy(sig, desc, desc16, desc8, refsrc):
        seen.append((sig, desc.numpy().copy(), desc16.numpy().copy(),
                     desc8.numpy().copy(),
                     tuple(r.numpy().copy() for r in refsrc)))
        return orig(sig, desc, desc16, desc8, refsrc)

    tfe.execute_program = spy
    try:
        dec = tapi.Decoder(tapi.Settings(device="cpu"))
        for fr in frames[:2]:
            dec.send_data(fr.data)
    finally:
        tfe.execute_program = orig
    # frame 0: recon + filters; frame 1: recon + filters
    assert len(seen) == 4
    return {"key_recon": seen[0], "recon": seen[2], "filters": seen[3]}


@pytest.mark.parametrize("which", ["recon", "filters", "key_recon"])
def test_executor_matches_jax_interpreter(mini_programs, which):
    """Frame 1's recon and filter programs; and frame 0's recon program,
    whose host residuals (hresmc) frame 1 of this stream lacks."""
    sig, desc, desc16, desc8, refsrc = mini_programs[which]
    kinds = {op[0] for op in sig[0]}
    want_kinds = {"recon": {"hpx", "puthv_x", "put", "residmc", "out"},
                  "filters": {"dbk", "cdef", "out"},
                  "key_recon": {"hresmc"}}[which]
    assert want_kinds <= kinds
    j_planes, j_hres = jfe._interpreter(sig)(desc, desc16, desc8, refsrc)
    t_planes, t_hres = tfe.execute_program(
        sig, *tfe.frame_program_to_torch(desc, desc16, desc8, refsrc,
                                         "cpu"))
    assert len(t_planes) == len(j_planes) and len(t_hres) == len(j_hres)
    for t, j in zip(t_planes + t_hres, j_planes + j_hres):
        j = np.asarray(j)
        t = t.numpy()
        assert t.shape == j.shape
        np.testing.assert_array_equal(t.astype(np.int32), j.astype(np.int32))


@pytest.mark.parametrize("kind", sorted(tfe.LATER))
def test_ops_outside_the_slice_raise(kind):
    sig = (((kind,),), 1, 8, ((8, 8),), (), (), False, "uint8")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=kind):
        tfe.execute_program(sig, z, z.to(torch.int16), z.to(torch.int8), ())


def test_put_destinations_are_disjoint(mini_programs):
    """The executor scatters MC units in place, in op order: that is
    exact only if no two units of a plane overlap. Check it on the
    planner's real frame-1 program (pad rows excluded)."""
    sig, desc, desc16, _, _ = mini_programs["recon"]
    covered = {}
    for op in sig[0]:
        if op[0] not in ("put", "puthv_x"):
            continue
        pl, uw, uh = op[1], op[2], op[3]
        h_ys, h_xs = op[-2], op[-1]
        ys = desc16[h_ys[0]:h_ys[0] + h_ys[1][0]].astype(np.int64)
        xs = desc16[h_xs[0]:h_xs[0] + h_xs[1][0]].astype(np.int64)
        real = ys != tfe.OOB16
        yy = (ys[real, None, None] + np.arange(uh)[None, :, None])
        xx = (xs[real, None, None] + np.arange(uw)[None, None, :])
        lin = np.broadcast_arrays(yy * 4096, xx)
        covered.setdefault(pl, []).append((lin[0] + lin[1]).reshape(-1))
    assert covered
    for pl, chunks in covered.items():
        lin = np.concatenate(chunks)
        assert len(np.unique(lin)) == len(lin), f"plane {pl} overlaps"


def test_emit16_refuses_values_outside_int16():
    prog = tfe.FrameProgram(1, 8, ((8, 8),))
    h = prog.emit16(np.array([-32768, 0, 32767], np.int64))
    assert h == (0, (3,), 16)
    assert prog.emit16([]) == (3, (0,), 16)
    for bad in ([32768], [-32769], np.array([[0, 1 << 20]], np.int32)):
        with pytest.raises(AssertionError, match="int16 range"):
            prog.emit16(bad)


def _lr_program(bd):
    """A 4:2:0 frame of 240x70 visible pixels (planes 256x128 and
    128x64) whose filter program is: snapshot, CDEF, then loop
    restoration of all three planes as the port's planner packs it.
    Luma units are 64 wide with a 48-wide right-edge unit; two stripes
    (56 and 14 rows), so each plane has buckets of several shapes and a
    bucket of 3 units padded to 8. Plane 0 is all Wiener, plane 1 has
    every SGR kind and a Wiener unit, plane 2 skips its first unit.
    Returns (sig, desc, desc16, desc8, planes as int32 numpy)."""
    rng = np.random.default_rng(bd)
    bufs = SimpleNamespace(width=240, height=70, ss_hor=1, ss_ver=1)
    types = {0: [2, 2, 2, 2], 1: [3 + 0, 3 + 10, 3 + 14, 2],
             2: [0, 2, 3 + 5, 2]}

    def unit(t):
        return dict(type=t, filter_h=rng.integers([-5, -23, -17],
                                                  [11, 9, 47]).tolist(),
                    filter_v=rng.integers([-5, -23, -17],
                                          [11, 9, 47]).tolist(),
                    sgr_weights=[int(rng.integers(-96, 32)),
                                 int(rng.integers(-32, 96))])
    coder = SimpleNamespace(lr_units={
        (p, 0, c): unit(t) for p, ts in types.items()
        for c, t in enumerate(ts)})
    fhdr = SimpleNamespace(restoration_unit_size=[6, 5])
    shapes = [(128, 256), (64, 128), (64, 128)]
    prog = tfe.FrameProgram(3, bd, shapes, plane_inputs=True,
                            out_dtype=np.uint8 if bd == 8 else np.uint16)
    prog.op("snap", "precdef")
    bh4, bw4 = 18, 60
    prog.op("cdef", prog.emit8(rng.integers(0, 2, (2, 4))),
            prog.emit8(rng.integers(0, 2, (bh4, bw4))),
            prog.emit8([9, 30] + [0] * 6), prog.emit8([5, 12] + [0] * 6),
            4 + bd - 8, 1, 1, False)
    for p in range(3):
        tfilters._emit_lr_plane(prog, fhdr, [coder], bufs, p)
    prog.op("out")
    planes = [rng.integers(0, 1 << bd, s).astype(np.int32) for s in shapes]
    return (*prog.finalize(), planes)


def _run_both(sig, desc, desc16, desc8, planes):
    j_planes, _ = jfe._interpreter(sig)(desc, desc16, desc8, tuple(planes))
    t_planes, _ = tfe.execute_program(
        sig, *tfe.frame_program_to_torch(desc, desc16, desc8, planes,
                                         "cpu"))
    return ([np.asarray(j).astype(np.int32) for j in j_planes],
            [t.numpy().astype(np.int32) for t in t_planes])


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_lr_program_matches_jax_interpreter(bd):
    """Later buckets read windows next to units that earlier buckets of
    the same plane wrote: right only if the snapshots are copies."""
    sig, desc, desc16, desc8, planes = _lr_program(bd)
    kinds = [op[0] for op in sig[0]]
    assert kinds.count("snap") == 4 and "cdef" in kinds
    lrs = [op for op in sig[0] if op[0] in ("lrw", "lrs")]
    assert {op[3] for op in lrs if op[:2] == ("lrw", 0)} == {64, 48}
    assert {op[3] for op in lrs if op[0] == "lrs"} == {0, 1, 2}
    want, got = _run_both(sig, desc, desc16, desc8, planes)
    for p, (t, j) in enumerate(zip(got, want)):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t, j, err_msg=f"plane {p}")


def test_lr_bucket_pad_rows_write_nothing():
    """The luma bucket of 3 units (64x56) is padded to 8 rows: the gather
    origins repeat the last unit, the scatter origins are PAD_OOB. Run
    alone, it changes the plane inside its 3 units only."""
    sig, desc, desc16, desc8, planes = _lr_program(10)
    op = next(o for o in sig[0] if o[:5] == ("lrw", 0, "precdef", 64, 56))
    h_xs, h_ysin, h_ysout = op[5:8]
    xs, ysin, ysout = (desc[h[0]:h[0] + h[1][0]] for h in (h_xs, h_ysin,
                                                           h_ysout))
    assert len(xs) == 8 and list(xs[:3]) == [0, 64, 128]
    assert list(ysin) == [0] * 8 and list(xs[3:]) == [128] * 5
    assert list(ysout) == [0] * 3 + [PAD_OOB] * 5
    alone = ((("snap", "precdef"), ("snap", ("prelr", 0)), op, ("out",)),
             ) + sig[1:]
    want, got = _run_both(alone, desc, desc16, desc8, planes)
    np.testing.assert_array_equal(got[0], want[0])
    changed = got[0] != planes[0]
    inside = np.zeros_like(changed)
    inside[0:56, 0:192] = True
    assert changed[inside].any() and not changed[~inside].any()
    for p in (1, 2):
        np.testing.assert_array_equal(got[p], planes[p])
