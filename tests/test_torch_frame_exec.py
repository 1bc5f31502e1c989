"""The PyTorch port's frame executor (dav1d_mirror_tpu_torch/models/
frame_exec.py) against the JAX package's eager interpreter
(dav1d_mirror_tpu/models/frame_exec._interpreter) on the same packed
program: frame 1 (inter) of a miniature config 2 stream, as the port's
planner packs it. Planes and host residuals must be equal.

Also: every op kind outside this slice raises NotImplementedError, and
the int16 side buffer refuses values it would wrap."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import bench  # noqa: E402
from dav1d_mirror_tpu.models import frame_exec as jfe  # noqa: E402
from dav1d_mirror_tpu_torch import api as tapi  # noqa: E402
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf  # noqa: E402
from dav1d_mirror_tpu_torch.models import frame_exec as tfe  # noqa: E402
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
