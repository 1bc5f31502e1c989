"""The recon programs of miniature tools streams, decoded once a process
on the CPU route: lossless 128x64 streams with every inter tool (seed 5:
its frames hold all four compound joins, warps and OBMC laps of both
phases; seed 1 also warped compound sides, "w" sub-ops), for the tests of
the planner's tool records and the executor's tool runs
(tests/test_torch_tools_kernels.py, tests/test_torch_tools_runs.py)."""
from __future__ import annotations

import functools

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
