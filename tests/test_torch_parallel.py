"""The PyTorch port's parallel paths (dav1d_mirror_tpu_torch/parallel/)
against the JAX package's (dav1d_mirror_tpu/parallel/), on the CPU under
gloo, with the tolerance zero.

Each rank is a process of its own. A module fixture runs one worker job
per world size, 2 and 4 ranks, each process with its own timeout (as
tests/test_multihost.py runs its hosts), and saves every check's output,
so each check below is its own test and the processes start once:

- the band functions at the tiny shapes of __graft_entry__
  .dryrun_multichip, on the numpy inputs the JAX functions get on the
  8-virtual-device mesh of tests/conftest.py (``sharded_recon_step``
  depends on the shard count, so its JAX side runs on a mesh of the
  world's size): deblock, CDEF, LR, sharded_recon_step, fanout_gop_mc,
  run_banded_chain;
- whole streams: the streamgen multi-tile chains of
  __graft_entry__._sharded_stream_decode (1x2 tiles at 2 ranks, 2x2 tiles
  with compound at 4 ranks) decoded tile-sharded, against the JAX host
  reference path's md5. The chain's inter frames are coded from the
  default CDFs, as their headers (primary_ref_frame none) tell the
  decoder; the graft function codes them from the keyframe's, which only
  its own encoder-side blocks see;
- the dry run's own checks (parallel/dryrun.run_rank) on every rank, and
  the band functions on a decoded frame's own planes and parameters
  against the port's single-device filters (parallel/dryrun
  .filter_checks);
- the reference-plane exchange over ("host", "dev") meshes: 2 hosts of
  one process each (the two-process exchange of test_multihost) and,
  at 4 ranks, 2 hosts x 2 devices.

The host logic (GOP levels, frame assignment, row-wave planners) is
compared with the JAX package's on the cases of tests/test_frame_pipe.py,
tests/test_multihost.py and tests/test_row_overlap.py, in this process.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from dav1d_mirror_tpu.parallel import frame_pipe as jfp  # noqa: E402
from dav1d_mirror_tpu.parallel import multihost as jmh  # noqa: E402
from dav1d_mirror_tpu.parallel import row_overlap as jro  # noqa: E402
from dav1d_mirror_tpu.testing.streamgen import RandomPolicy  # noqa: E402
from dav1d_mirror_tpu_torch.parallel import frame_pipe as tfp  # noqa: E402
from dav1d_mirror_tpu_torch.parallel import multihost as tmh  # noqa: E402
from dav1d_mirror_tpu_torch.parallel import row_overlap as tro  # noqa: E402
from dav1d_mirror_tpu_torch.parallel.dryrun import free_port  # noqa: E402
from test_e2e_inter import build_stream  # noqa: E402
from test_frame_pipe import _F  # noqa: E402
from test_row_overlap import _chain_units  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
RANK_TIMEOUT = 240           # seconds, each rank process
BAND_CHECKS = ("deblock", "cdef", "lr", "fanout", "chain")
# a stream whose first frame runs deblock, CDEF and Wiener restoration
FILTER_STREAM = dict(w=160, h=96, n_inter=1, q=80, txsw=True,
                     lf=(20, 20, 16, 12, 1),
                     cdef=dict(damping=4, n_bits=1, y_strength=[6, 11],
                               uv_strength=[3, 0]), lr=(2, 2, 2))


# ---------------------------------------------------------------------
# inputs and the JAX side
# ---------------------------------------------------------------------
def _inputs():
    """The tiny dry-run shapes (H = 128 rows, 8 frames, 32 tx blocks: a
    multiple of every mesh size here), from a seed."""
    rng = np.random.default_rng(11)
    H, W = 128, 64
    h4, w4 = H // 4, W // 4
    inp = dict(
        coefs=rng.integers(-512, 512, (32, 16, 16)).astype(np.int32),
        pred=rng.integers(0, 256, (32, 16, 16)).astype(np.int32),
        plane=rng.integers(0, 255, (H, W)).astype(np.int32),
        edge_v=rng.integers(-1, 2, (h4, w4)).astype(np.int32),
        edge_h=rng.integers(-1, 2, (h4, w4)).astype(np.int32),
        lvl=rng.integers(0, 64, (h4, w4)).astype(np.int32),
        e_lut=np.asarray([2 + 2 * (i >> 4) + (i & 15) for i in range(64)],
                         np.int32),
        i_lut=np.asarray([max(1, i >> 4) for i in range(64)], np.int32),
        dirs=rng.integers(0, 8, (H // 8, W // 8)).astype(np.int32),
        pri=rng.integers(0, 16, (H // 8, W // 8)).astype(np.int32),
        sec=rng.integers(0, 4, (H // 8, W // 8)).astype(np.int32),
        act=rng.random((H // 8, W // 8)) < 0.8,
        lr_padded=rng.integers(0, 255, (37, 70, 70)).astype(np.int32),
        refs=rng.integers(0, 255, (7, 64, 64)).astype(np.int32),
        units=np.stack([np.stack([
            rng.integers(0, 7, 8), rng.integers(-3, 48, 8),
            rng.integers(-3, 48, 8), rng.integers(1, 16, 8),
            rng.integers(1, 16, 8), rng.integers(0, 9, 8)], axis=1)
            for _ in range(8)]).astype(np.int32),
        ref0=rng.integers(0, 256, (64, 64)).astype(np.int32))
    f3 = rng.integers(-5, 6, (37, 3))
    fh = np.zeros((37, 7), np.int32)
    fh[:, :3] = f3
    fh[:, 4:] = f3[:, ::-1]
    fh[:, 3] = 128 - 2 * f3.sum(1)
    inp["lr_fh"] = fh
    for f, us in enumerate(_chain_units(3, 64, 64, 16, 1, 8, 8, seed=5)):
        inp[f"chain{f}"] = us
    return inp


def _jax_outputs(inp):
    """Every band function's JAX output on the same numpy inputs."""
    from dav1d_mirror_tpu.parallel.filter_shard import (
        band_cdef_plane, band_deblock_plane, shard_lr_batch)
    from dav1d_mirror_tpu.parallel.tile_shard import sharded_recon_step
    devs = jax.devices()
    assert len(devs) >= 8, "tests/conftest.py provides 8 virtual devices"
    mesh8 = Mesh(np.array(devs[:8]), ("tile",))
    lvl = inp["lvl"]
    out = {"deblock": band_deblock_plane(
        mesh8, inp["plane"], inp["edge_v"], inp["edge_h"], lvl, lvl, lvl,
        lvl, inp["e_lut"], inp["i_lut"], True, 8)}
    out["cdef"] = band_cdef_plane(mesh8, out["deblock"], inp["dirs"],
                                  inp["pri"], inp["sec"], 5, inp["act"], 8,
                                  8, 8)
    out["lr"] = shard_lr_batch(mesh8, inp["lr_padded"], inp["lr_fh"],
                               inp["lr_fh"], 64, 64, 8)
    out["fanout"] = np.asarray(jfp.fanout_gop_mc(
        mesh8, inp["refs"], inp["units"], 8, 8, True, True, 8))
    out["chain"] = np.asarray(jro.run_banded_chain(
        inp["ref0"], [inp[f"chain{f}"] for f in range(3)], 4, 16, 1, 8, 8,
        mesh=mesh8))
    for n in WORLDS:
        out[f"recon{n}"] = np.asarray(sharded_recon_step(
            Mesh(np.array(devs[:n]), ("tile",)), inp["pred"], inp["coefs"],
            bitdepth=8))
    return out


class _InterOnly(RandomPolicy):
    """__graft_entry__._sharded_stream_decode's _InterOnly policy."""

    def __call__(self, key, maxv):
        return 1 if key == "is_inter" else super().__call__(key, maxv)


def _chain_ivf(tiles_log2, comp):
    """A keyframe and 2 inter frames over a (log2 cols, log2 rows) tile
    grid of 64x64 tiles, every block of the inter frames inter."""
    from dav1d_mirror_tpu.data.tables import new_cdf_context, qcat_from_qidx
    from dav1d_mirror_tpu.host import headers as h
    from dav1d_mirror_tpu.testing.streamgen import (
        gen_frame_tiles, gen_ivf, make_inter_frame_hdr, make_key_frame_hdr,
        make_seq_hdr)
    log2_cols, log2_rows = tiles_log2
    lf = (28, 28, 20, 20, 1)
    seq = make_seq_hdr(64 << log2_cols, 64 << log2_rows)
    kf = make_key_frame_hdr(seq, qidx=100, txfm_mode=h.TX_SWITCHABLE,
                            loopfilter=lf, tiles=tiles_log2)
    cdf0 = new_cdf_context(qcat_from_qidx(100))
    payloads, _ = gen_frame_tiles(seq, kf, _InterOnly(9), cdf=cdf0.copy())
    frames = [(kf, payloads, None)]
    for i in range(2):
        fi = make_inter_frame_hdr(seq, qidx=100, txfm_mode=h.TX_SWITCHABLE,
                                  loopfilter=lf, tiles=tiles_log2,
                                  switchable_comp=comp)
        payloads, _ = gen_frame_tiles(seq, fi, _InterOnly(50 + 7 * i),
                                      cdf=new_cdf_context(qcat_from_qidx(
                                          100)), ref_poc=[0] * 7)
        frames.append((fi, payloads, [kf] * 8))
    return gen_ivf(seq, frames)


def _jax_host_md5(data):
    """(md5, frames) of the JAX package's host reference path."""
    import dav1d_mirror_tpu.api as japi
    from dav1d_mirror_tpu.host.ivf import parse_ivf
    from dav1d_mirror_tpu.output import MD5Muxer
    dec = japi.Decoder(japi.Settings(use_tpu_inter=False,
                                     use_tpu_filters=False, logger=None))
    mux = MD5Muxer()
    for fr in parse_ivf(data)[3]:
        dec.send_data(fr.data)
        while (pic := dec.get_picture()) is not None:
            mux.write(pic)
    return mux.digest(), mux.n


# ---------------------------------------------------------------------
# the worker job: one process per rank
# ---------------------------------------------------------------------
WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from dav1d_mirror_tpu_torch.parallel import dryrun, multihost
    from dav1d_mirror_tpu_torch.parallel.filter_shard import (
        band_cdef_plane, band_deblock_plane, shard_lr_batch)
    from dav1d_mirror_tpu_torch.parallel.frame_pipe import fanout_gop_mc
    from dav1d_mirror_tpu_torch.parallel.mesh import close_mesh
    from dav1d_mirror_tpu_torch.parallel.row_overlap import run_banded_chain
    from dav1d_mirror_tpu_torch.parallel.tile_shard import (
        sharded_recon_step)
    from torch.distributed.device_mesh import init_device_mesh

    rank, world, port, job = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    inp = dict(np.load(os.path.join(job, "inputs.npz")))
    # one group; a ("host", "dev") mesh of `world` hosts (the multi-host
    # exchange) and a "tile" mesh over the same ranks
    hmesh = multihost.init_multihost(f"127.0.0.1:{port}", world, rank,
                                     device="cpu")
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("tile",))
    out = {}
    lvl = inp["lvl"]
    out["deblock"] = band_deblock_plane(
        mesh, inp["plane"], inp["edge_v"], inp["edge_h"], lvl, lvl, lvl,
        lvl, inp["e_lut"], inp["i_lut"], True, 8)
    out["cdef"] = band_cdef_plane(mesh, out["deblock"], inp["dirs"],
                                  inp["pri"], inp["sec"], 5, inp["act"],
                                  8, 8, 8)
    out["lr"] = shard_lr_batch(mesh, inp["lr_padded"], inp["lr_fh"],
                               inp["lr_fh"], 64, 64, 8)
    out["fanout"] = fanout_gop_mc(mesh, inp["refs"], inp["units"], 8, 8,
                                  True, True, 8)
    out["chain"] = run_banded_chain(
        inp["ref0"], [inp[f"chain{f}"] for f in range(3)], 4, 16, 1, 8, 8,
        mesh=mesh)
    out["recon"] = sharded_recon_step(mesh, inp["pred"], inp["coefs"], 8)
    out = {k: v.cpu().numpy() for k, v in out.items()}

    # the two-host exchange: host 0 owns slot 3, the last host slot 5
    me = hmesh.get_local_rank("host")
    nh = hmesh.size(0)
    produced = {3: (0, inp["ref0"] if me == 0 else None),
                5: (nh - 1, inp["refs"][1] if me == nh - 1 else None)}
    got = multihost.exchange_level_refs(hmesh, me, produced, (64, 64))
    out["exchange3"], out["exchange5"] = got[3], got[5]
    if world == 4:
        # 2 hosts x 2 devices over the same 4 ranks
        hm2 = multihost.global_mesh(2, 2, "cpu")
        h2 = hm2.get_local_rank("host")
        got = multihost.exchange_level_refs(
            hm2, h2, {7: (1, inp["ref0"] * 3 if h2 == 1 else None)},
            (64, 64))
        out["exchange2x2"] = got[7]

    info = {"dryrun": dryrun.run_rank(mesh, world)}
    with open(os.path.join(job, "filters.ivf"), "rb") as f:
        info["filters"] = dryrun.filter_checks(
            mesh, *dryrun.first_frame(f.read(), "cpu"))
    with open(os.path.join(job, f"stream{world}.ivf"), "rb") as f:
        info["stream"] = dryrun.sharded_stream_decode(f.read(), mesh)
    np.savez(os.path.join(job, f"out{rank}.npz"), **out)
    with open(os.path.join(job, f"info{rank}.json"), "w") as f:
        json.dump(info, f)
    close_mesh()
    print(f"rank{rank} OK", flush=True)
""")


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """_run_jobs's results, made once per test session: under
    pytest-xdist the first worker to need them runs the jobs and the
    others wait for its saved results (a file lock in the session's
    shared temporary directory)."""
    if not hasattr(request.config, "workerinput"):
        return _run_jobs(tmp_path_factory)
    import fcntl
    import pickle
    shared = tmp_path_factory.getbasetemp().parent
    with open(shared / "torch_parallel.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = shared / "torch_parallel.pkl"
        if not done.exists():
            out = _run_jobs(tmp_path_factory)
            with open(done, "wb") as f:
                pickle.dump(out, f)
        with open(done, "rb") as f:
            return pickle.load(f)


def _run_jobs(tmp_path_factory):
    """Both world sizes' jobs, run at once: {world: (per-rank outputs,
    per-rank info)}, plus the JAX outputs, the streams' JAX md5s and the
    inputs."""
    import json
    inp = _inputs()
    streams = {2: _chain_ivf((0, 1), False), 4: _chain_ivf((1, 1), True)}
    filters_ivf = build_stream(FILTER_STREAM, 5)[1]
    jobs = {}
    for world in WORLDS:
        job = tmp_path_factory.mktemp(f"world{world}")
        np.savez(job / "inputs.npz", **inp)
        (job / f"stream{world}.ivf").write_bytes(streams[world])
        (job / "filters.ivf").write_bytes(filters_ivf)
        script = job / "worker.py"
        script.write_text(WORKER % dict(repo=str(REPO)))
        port = free_port()
        jobs[world] = (job, [subprocess.Popen(
            [sys.executable, str(script), str(r), str(world), str(port),
             str(job)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)])
    # the JAX side while the ranks run
    jax_out = _jax_outputs(inp)
    jax_md5 = {w: _jax_host_md5(s) for w, s in streams.items()}
    res = {}
    for world, (job, procs) in jobs.items():
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=RANK_TIMEOUT)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                log, _ = p.communicate()
            assert p.returncode == 0, f"world {world} rank {r}:\n{log[-3000:]}"
        res[world] = ([dict(np.load(job / f"out{r}.npz"))
                       for r in range(world)],
                      [json.loads((job / f"info{r}.json").read_text())
                       for r in range(world)])
    return res, jax_out, jax_md5, inp


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("check", BAND_CHECKS)
def test_band_function_equals_the_jax_one(runs, world, check):
    res, jax_out, _, _ = runs
    for r, out in enumerate(res[world][0]):
        np.testing.assert_array_equal(out[check], jax_out[check],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_recon_step_equals_the_jax_one(runs, world):
    res, jax_out, _, _ = runs
    for out in res[world][0]:
        np.testing.assert_array_equal(out["recon"], jax_out[f"recon{world}"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stream_decode_equals_the_jax_host_path(runs, world):
    res, _, jax_md5, _ = runs
    for info in res[world][1]:
        assert tuple(info["stream"]) == jax_md5[world]
    assert jax_md5[world][1] == 3


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_checks_hold_on_every_rank(runs, world):
    res, _, _, _ = runs
    for info in res[world][1]:
        assert set(info["dryrun"]) >= {
            "sharded_recon_step", "band_deblock_plane", "band_cdef_plane",
            "shard_lr_batch", "fanout_gop_mc", "run_banded_chain",
            "exchange_level_refs"}
        assert all(v["equal"] for v in info["dryrun"].values())


@pytest.mark.parametrize("world", WORLDS)
def test_band_functions_on_a_decoded_frame_equal_single_device(runs, world):
    """Deblock, CDEF and Wiener LR on a decoded frame's own planes and
    parameters (parallel/dryrun.filter_checks), against the port's
    single-device ops."""
    res, _, _, _ = runs
    for info in res[world][1]:
        kinds = {k.split()[0] for k in info["filters"]}
        assert kinds == {"band_deblock_plane", "band_cdef_plane",
                         "shard_lr_batch"}, kinds
        assert all(v["equal"] for v in info["filters"].values())


@pytest.mark.parametrize("world", WORLDS)
def test_ref_exchange_gives_every_host_the_owners_plane(runs, world):
    res, _, _, inp = runs
    for out in res[world][0]:
        np.testing.assert_array_equal(out["exchange3"], inp["ref0"])
        np.testing.assert_array_equal(out["exchange5"], inp["refs"][1])
    if world == 4:
        for out in res[world][0]:
            np.testing.assert_array_equal(out["exchange2x2"],
                                          inp["ref0"] * 3)


def test_dryrun_command_runs_two_gloo_ranks():
    """`python -m dav1d_mirror_tpu_torch.parallel.dryrun --world 2
    --device cpu` spawns its ranks, gathers their checks and prints them,
    every one equal."""
    import json
    r = subprocess.run(
        [sys.executable, "-m", "dav1d_mirror_tpu_torch.parallel.dryrun",
         "--world", "2", "--device", "cpu", "--timeout", "200"],
        cwd=REPO, capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["world"] == 2 and len(out["checks"]) == 7
    assert all(v["equal"] for v in out["checks"].values())


# ---------------------------------------------------------------------
# host logic, in this process
# ---------------------------------------------------------------------
GOP_CASES = [
    [_F(0, refresh=0xFF), _F(1, [0] * 7, 1 << 1), _F(1, [0] * 7, 1 << 2),
     _F(1, [0] * 7, 0), _F(1, [1] * 7, 0)],
    [_F(0, refresh=0xFF), _F(1, [0] * 7, 1), _F(1, [0] * 7, 1)],
    [_F(0, [0] * 7, 0xFF), _F(1, [0] * 7, 0x02), _F(1, [0] * 7, 0x04),
     _F(1, [1] * 7, 0x08)],
]


@pytest.mark.parametrize("ci", range(len(GOP_CASES)))
def test_plan_gop_levels_and_assignment_equal_jax(ci):
    hdrs = GOP_CASES[ci]
    levels = tfp.plan_gop_levels(hdrs)
    assert levels == jfp.plan_gop_levels(hdrs)
    for n_hosts in (1, 2, 3):
        assert tmh.assign_level_frames(levels, n_hosts) == \
            jmh.assign_level_frames(levels, n_hosts)


WAVE_CASES = [([[]] + [[f - 1] for f in range(1, 4)], 16, 1),
              ([[], [0], [0], [1, 2]], 8, 2),
              ([[], [0], [], [2]], 4, 1)]


@pytest.mark.parametrize("ci", range(len(WAVE_CASES)))
def test_row_wave_planners_equal_jax(ci):
    deps, n_bands, pad = WAVE_CASES[ci]
    waves = tro.plan_row_waves(deps, n_bands, pad)
    assert waves == jro.plan_row_waves(deps, n_bands, pad)
    tro.check_waves(waves, deps, n_bands, pad)
    assert tro.pipeline_depth(waves) == jro.pipeline_depth(waves)


@pytest.mark.parametrize("mv, rows", [(1 << 13, 64), (64, 64), (0, 64),
                                      (100, 16)])
def test_mv_row_pad_equals_jax(mv, rows):
    assert tro.mv_row_pad(mv, rows) == jro.mv_row_pad(mv, rows)


@pytest.mark.parametrize("sequential", [True, False])
def test_banded_chain_on_one_device_equals_jax(sequential):
    """run_banded_chain without a mesh (test_row_overlap's chain)."""
    F, H, W, band_rows, pad, uw, uh = 3, 64, 64, 16, 1, 8, 8
    ref0 = np.random.default_rng(3).integers(0, 256, (H, W)).astype(
        np.int32)
    frames = _chain_units(F, H, W, band_rows, pad, uw, uh)
    want = np.asarray(jro.run_banded_chain(
        ref0, frames, H // band_rows, band_rows, pad, uw, uh,
        sequential=sequential))
    got = tro.run_banded_chain(ref0, frames, H // band_rows, band_rows,
                               pad, uw, uh, sequential=sequential,
                               device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
