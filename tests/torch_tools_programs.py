"""The recon programs of miniature tools streams, decoded once a process
on the CPU route: lossless 128x64 streams with every inter tool (seed 5:
its frames hold all four compound joins, warps and OBMC laps of both
phases; seed 1 also warped compound sides, "w" sub-ops), for the tests of
the planner's tool records and the executor's tool runs
(tests/test_torch_tools_kernels.py, tests/test_torch_tools_runs.py,
tests/test_torch_comp_run.py); and the JAX interpreter's joins of a
synthetic comp case (jax_comp)."""
from __future__ import annotations

import functools

import numpy as np
import torch_streams as ts
from dav1d_mirror_tpu_torch import api as tapi
from dav1d_mirror_tpu_torch.host.ivf import parse_ivf
from dav1d_mirror_tpu_torch.models import frame_exec as tfe


@functools.lru_cache(maxsize=None)
def tools_programs(seed=5):
    """[(sig, desc, desc16, desc8, refsrc)] (numpy) of the programs with
    comp records of the stream of `seed`, in decode order."""
    _, data, _ = ts.build_tools_stream(dict(ts.TOOLS, w=128, h=64,
                                            n_inter=3, q=0), seed)
    _, _, _, frames = parse_ivf(data)
    seen = []
    orig = tfe.execute_program

    def spy(sig, desc, desc16, desc8, refsrc):
        if any(r[0] == "comp" for r in sig[0]):
            seen.append((sig, desc.numpy().copy(), desc16.numpy().copy(),
                         desc8.numpy().copy(),
                         tuple(r.numpy().copy() for r in refsrc)))
        return orig(sig, desc, desc16, desc8, refsrc)
    tfe.execute_program = spy
    try:
        dec = tapi.Decoder(tapi.Settings(device="cpu"))
        for fr in frames:
            dec.send_data(fr.data)
    finally:
        tfe.execute_program = orig
    assert seen
    return tuple(seen)


def jax_comp(case):
    """The JAX interpreter's comp branch (dav1d_mirror_tpu/models/
    frame_exec._interpreter: comp_join_wavg, comp_join_wmask and
    comp_join_mask with its seg-mask registry, then scatter_units) on each
    record of a comp case (tools/tools_cases.comp_case), in order:
    (luma plane, chroma plane)."""
    import jax.numpy as jnp
    from dav1d_mirror_tpu.ops import mc_tpu as jmc
    from dav1d_mirror_tpu_torch.tools.tools_cases import comp_slice
    desc = case["desc"]

    def get(h):
        return jnp.asarray(comp_slice(desc, h))
    planes = [jnp.asarray(p) for p in case["planes"]]
    cms = {}
    bd, ssh, ssv = case["bd"], case["ssh"], case["ssv"]
    for r in case["records"]:
        t0, t1 = jnp.asarray(r["tmp0"]), jnp.asarray(r["tmp1"])
        out = jnp.zeros((r["N"], r["bhp"], r["bwp"]), jnp.int32)
        for j in r["joins"]:
            if j[0] == "wavg":
                out = jmc.comp_join_wavg(out, t0, t1, get(j[1]),
                                         get(j[2])[:, None, None], bd)
            elif j[0] == "segl":
                out, cms[j[3]] = jmc.comp_join_wmask(
                    out, t0, t1, get(j[1]), get(j[2]), ssh, ssv, bd)
            elif j[0] == "segc":
                spec = j[3]
                m = cms[spec[1]][get(spec[2])] if spec[0] == "one" else \
                    jnp.stack([cms[c][jj] for c, jj in spec[1]])
                out = jmc.comp_join_mask(out, t0, t1, get(j[1]), get(j[2]),
                                         m, bd)
            else:
                out = jmc.comp_join_mask(out, t0, t1, get(j[1]), get(j[2]),
                                         get(j[3]), bd)
        planes[r["pl"]] = jmc.scatter_units(
            planes[r["pl"]], out, get(r["h_dy"]), get(r["h_dx"]), r["bhp"],
            r["bwp"])
    return [np.asarray(p) for p in planes]
