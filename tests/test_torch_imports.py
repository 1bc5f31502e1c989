"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, carries a byte-identical copy of the spec tables, and never
falls back to the CPU when CUDA was asked for."""
import filecmp
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dav1d_mirror_tpu_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from dav1d_mirror_tpu_torch import api\n"
        "from dav1d_mirror_tpu_torch.ops import (cuda_build, itx_cuda, mc,"
        " mc_cuda, mcu_cuda)\n"
        "from dav1d_mirror_tpu_torch.tools import gen_itx_cuh, mcu_cases\n"
        "from dav1d_mirror_tpu_torch import cli, output\n"
        "from dav1d_mirror_tpu_torch.utils import trace\n"
        "from dav1d_mirror_tpu_torch.models import intra\n"
        "from dav1d_mirror_tpu_torch.ops import ipred\n"
        "from dav1d_mirror_tpu_torch import player\n"
        "from dav1d_mirror_tpu_torch.parallel import (dryrun, filter_shard,"
        " frame_pipe, mesh, multihost, row_overlap, tile_decode,"
        " tile_shard)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'dav1d_mirror_tpu' or\n"
        "             m.startswith('dav1d_mirror_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_no_source_line_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|dav1d_mirror_tpu)(\.|\s|$)")
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad


def test_spec_tables_are_byte_identical():
    a = REPO / "dav1d_mirror_tpu" / "data" / "spec_tables.npz"
    b = PORT / "data" / "spec_tables.npz"
    assert filecmp.cmp(a, b, shallow=False)


def test_decoder_refuses_cuda_without_a_gpu(monkeypatch):
    import torch
    from dav1d_mirror_tpu_torch import api
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        api.Decoder(api.Settings())
    assert api.Settings().device == "cuda"
    api.Decoder(api.Settings(device="cpu"))   # the CPU only when asked


def test_parallel_paths_and_player_refuse_cuda_without_a_gpu(monkeypatch):
    """The parallel entry points and the player run on CUDA unless the
    CPU is asked for; without a card a CUDA mesh is refused, before any
    process group forms (no quiet fall back to gloo)."""
    import inspect
    import torch
    import torch.distributed as dist
    from dav1d_mirror_tpu_torch import player
    from dav1d_mirror_tpu_torch.parallel import dryrun, mesh, multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_mesh(1, 0, "tcp://127.0.0.1:1", "cuda")
    assert not dist.is_initialized()
    for fn in (mesh.init_mesh, multihost.init_multihost,
               dryrun.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert player.parse_args(["x.ivf"]).device == "cuda"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu_or_the_package(tmp_path, alone):
    """No CUDA device (hidden here on any machine), or a directory that
    holds chip_smoke.py and nothing else: non-zero exit, no result."""
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    env = dict(os.environ) if alone else dict(os.environ,
                                               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
