# Ported from __graft_entry__.py (_sharded_stream_decode :67,
# dryrun_multichip :150).
"""The parallel paths' entry point.

    python -m dav1d_mirror_tpu_torch.parallel.dryrun --world N
        [--device cpu] [--stream clip.ivf]

``dryrun_multichip(world, device)`` starts `world` ranks (one process
each; at world size 1 the calling process is the rank), forms the mesh
over them (NCCL on the card, gloo on the CPU) and runs every parallel
path once at small shapes, each held to its single-device counterpart
in the port on the same inputs, with the tolerance zero:

  * ``sharded_recon_step`` (tile_shard) against itx + clip + the cyclic
    one-row min on one device;
  * ``band_deblock_plane``, ``band_cdef_plane``, ``shard_lr_batch``
    (filter_shard) against ops/loopfilter.deblock_plane,
    ops/cdef.cdef_filter_plane and ops/looprestoration.wiener_batch;
  * ``fanout_gop_mc`` (frame_pipe) against ops/mc.mc_unit_batch per
    frame;
  * ``run_banded_chain`` (row_overlap), the overlapped wave order on the
    mesh against the sequential order;
  * ``exchange_level_refs`` (multihost) over a ``("host", "dev")`` mesh
    of `world` hosts, each plane against its owner's;
  * with a stream whose tile count is `world`: ``sharded_stream_decode``
    (tile_decode) against the port's ``Decoder`` on the same device,
    by md5.

Each rank returns {check: {"equal": bool, "ms": time}}; the launcher
fails if a rank fails, does not finish within its timeout, or reports a
check unequal.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np
import torch

from ..api import Decoder, Settings
from ..errors import DecodeError
from ..host.demux import open_demuxer
from ..output import MD5Muxer
from .mesh import close_mesh, init_mesh, mesh_device


class ShardedDecoder(Decoder):
    """The port's Decoder with its pixel stage on the mesh: keyframes
    through tile_decode.sharded_intra_decode, inter frames through
    sharded_inter_decode. Entropy and every reference-state update are
    the Decoder's own, on every rank. In order (no pipelining)."""

    def __init__(self, mesh):
        self.mesh = mesh
        super().__init__(Settings(device=str(mesh_device(mesh)),
                                  logger=None))

    def _build(self, seq, fhdr, coders, bufs, refs, jnt_weights):
        return None

    def _pixels(self, built, seq, fhdr, coders, bufs, refs, jnt_weights,
                download=True):
        from .tile_decode import sharded_inter_decode, sharded_intra_decode
        if fhdr.width[0] != fhdr.width[1] or any(fhdr.restoration_type):
            raise ValueError("the sharded decode has no super-resolution "
                             "or loop restoration")
        if fhdr.frame_type in (0, 2):
            return sharded_intra_decode(seq, fhdr, coders, self.mesh, bufs)
        return sharded_inter_decode(seq, fhdr, coders, self.mesh, bufs,
                                    refs, jnt_weights)


def _md5_decode(dec, ivf_bytes):
    """(md5, frames) of a stream through `dec`."""
    _, units = open_demuxer(ivf_bytes)
    mux = MD5Muxer()
    try:
        for obus in units:
            dec.send_obus(obus)
            while (pic := dec.get_picture()) is not None:
                mux.write(pic)
        dec.drain()
        while (pic := dec.get_picture()) is not None:
            mux.write(pic)
    finally:
        dec.close()
    return mux.digest(), mux.n


def sharded_stream_decode(ivf_bytes, mesh):
    """Decode a stream with each frame's tile grid sharded over the mesh
    (one tile per rank; every frame's tile count must equal the mesh's
    first axis). Returns (md5 of the output, frames), equal on every
    rank. A frame outside the sharded decode's scope raises
    DecodeError."""
    return _md5_decode(ShardedDecoder(mesh), ivf_bytes)


class _FirstFrame(Decoder):
    """A Decoder that keeps its first frame's filter-chain inputs."""
    captured = None

    def _filter(self, seq, fhdr, coders, bufs, download=True):
        if self.captured is None:
            planes = ([p.clone() for p in bufs.dev_planes]
                      if bufs.dev_planes is not None else
                      [torch.as_tensor(p.astype(np.int32), device=self.device)
                       for p in bufs.planes])
            self.captured = (seq, fhdr, coders, bufs, planes)
        return super()._filter(seq, fhdr, coders, bufs, download)


def first_frame(ivf_bytes, device):
    """(seq, fhdr, coders, bufs, planes) of a stream's first frame as its
    in-loop filters get it: the reconstructed planes (on `device`), the
    headers, the entropy products and the frame's buffers."""
    dec = _FirstFrame(Settings(device=str(device), logger=None))
    for obus in open_demuxer(ivf_bytes)[1]:
        dec.send_obus(obus)
        if dec.captured is not None:
            break
    dec.close()
    return dec.captured


def filter_checks(mesh, seq, fhdr, coders, bufs, planes):
    """The band functions on one frame's own planes and parameters, each
    against the single-device op on the same inputs: band_deblock_plane
    against ops/loopfilter.deblock_plane per plane, cdef_banded (the
    band_cdef_plane of each plane) against ops/cdef.cdef_frame, and
    shard_lr_batch against ops/looprestoration.wiener_batch on the
    largest batch of Wiener stripe units of one geometry of each
    restored plane, each step on the previous one's output (as the
    filter chain runs them). Returns {check: {"equal", "ms", "plain_ms",
    "shape"}}; a filter the frame does not use is not run."""
    from ..host.lf import build_lf_arrays
    from ..models.filters import _lr_stripe_plan, build_cdef_plan
    from ..ops.cdef import cdef_frame
    from ..ops.loopfilter import deblock_plane
    from ..ops.looprestoration import pad_stripes, wiener_batch
    from ..ops.spec_consts import RESTORATION_WIENER, calc_eih
    from .filter_shard import (_prep_lvls, band_deblock_plane, cdef_banded,
                               shard_lr_batch)

    dev = mesh_device(mesh)
    bd = seq.bitdepth
    planes = [p.to(device=dev, dtype=torch.int32) for p in planes]
    out = {}

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def check(name, band, single):
        got, ms = _timed(band, dev)
        want, plain_ms = _timed(single, dev)
        out[name] = {"equal": bool(torch.equal(got, want)), "ms": ms,
                     "plain_ms": plain_ms, "shape": list(want.shape)}
        return want

    if fhdr.loopfilter_level_y[0] or fhdr.loopfilter_level_y[1]:
        lf = build_lf_arrays(seq, fhdr, coders, bufs.width, bufs.height)
        e_lut, i_lut = calc_eih(fhdr.loopfilter_sharpness)
        specs = [(0, lf.edge_v_y, lf.edge_h_y, lf.lvl_y, 0, 1, True)]
        if len(planes) > 1 and (fhdr.loopfilter_level_u or
                                fhdr.loopfilter_level_v):
            specs += [(1 + pl, lf.edge_v_uv, lf.edge_h_uv, lf.lvl_uv, pl,
                       pl, False) for pl in (0, 1)]
        for pli, ev, eh, lvl, cv, ch, luma in specs:
            args = [t(a) for a in (ev, eh, *_prep_lvls(lvl, cv, ch), e_lut,
                                   i_lut)]
            planes[pli] = check(
                f"band_deblock_plane {pli}",
                lambda: band_deblock_plane(mesh, planes[pli], *args, luma,
                                           bd),
                lambda: deblock_plane(planes[pli], *args, luma=luma,
                                      bitdepth=bd))
    pre_cdef = list(planes)
    if seq.cdef and (any(fhdr.cdef_y_strength[:1 << fhdr.cdef_n_bits]) or
                     any(fhdr.cdef_uv_strength[:1 << fhdr.cdef_n_bits])):
        idx_map, noskip = build_cdef_plan(fhdr, coders)
        got, ms = _timed(lambda: cdef_banded(mesh, seq, fhdr, bufs, planes,
                                             idx_map, noskip), dev)
        want, plain_ms = _timed(lambda: cdef_frame(
            tuple(planes), t(idx_map), torch.as_tensor(noskip, device=dev),
            t(fhdr.cdef_y_strength), t(fhdr.cdef_uv_strength),
            fhdr.cdef_damping + bd - 8, bd, bufs.ss_hor, bufs.ss_ver,
            seq.layout == 0), dev)
        for i, (g, w) in enumerate(zip(got, want)):
            out[f"band_cdef_plane {i}"] = {
                "equal": bool(torch.equal(g, w)), "ms": ms,
                "plain_ms": plain_ms, "shape": list(w.shape)}
        planes = list(want)
    for p in range(len(planes)):
        if not fhdr.restoration_type[p]:
            continue
        groups = {}
        for u in _lr_stripe_plan(fhdr, coders, bufs, p):
            if u["lr"]["type"] == RESTORATION_WIENER:
                groups.setdefault((u["w"], u["h"]), []).append(u)
        if not groups:
            continue
        (w, h), units = max(groups.items(), key=lambda kv: len(kv[1]))

        def taps(name):
            f = np.zeros((len(units), 7), np.int32)
            for i, u in enumerate(units):
                f3 = u["lr"][name]
                f[i, :3] = f3
                f[i, 4:] = f3[::-1]
                f[i, 3] = 128 - 2 * (f3[0] + f3[1] + f3[2])
            return t(f)

        padded = pad_stripes(planes[p], pre_cdef[p],
                             t([u["x"] for u in units]),
                             t([u["y"] for u in units]),
                             t([u["edges"] for u in units]), w, h)
        fh, fv = taps("filter_h"), taps("filter_v")
        check(f"shard_lr_batch {p}",
              lambda: shard_lr_batch(mesh, padded, fh, fv, w, h, bd),
              lambda: wiener_batch(padded, fh, fv, w, h, bd))
    return out


# ---------------------------------------------------------------------
# the dry run: every parallel path once, against one device
# ---------------------------------------------------------------------
def _timed(fn, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def dryrun_inputs(world: int):
    """The dry run's numpy inputs (the shapes and seed of __graft_entry__
    .dryrun_multichip at `world` devices)."""
    rng = np.random.default_rng(1)
    B = world * 8
    inp = dict(
        coefs=rng.integers(-512, 512, (B, 16, 16)).astype(np.int32),
        pred=rng.integers(0, 256, (B, 16, 16)).astype(np.int32))
    H, W = world * 32, 64
    h4, w4 = H // 4, W // 4
    inp.update(
        plane=rng.integers(0, 255, (H, W)).astype(np.int32),
        edge_v=rng.integers(-1, 2, (h4, w4)).astype(np.int32),
        edge_h=rng.integers(-1, 2, (h4, w4)).astype(np.int32),
        lvl=rng.integers(0, 64, (h4, w4)).astype(np.int32),
        e_lut=np.asarray([2 + 2 * (i >> 4) + (i & 15) for i in range(64)],
                         np.int32),
        i_lut=np.asarray([max(1, i >> 4) for i in range(64)], np.int32))
    hb, wb = H // 8, W // 8
    inp.update(dirs=rng.integers(0, 8, (hb, wb)).astype(np.int32),
               pri=rng.integers(0, 16, (hb, wb)).astype(np.int32),
               sec=rng.integers(0, 4, (hb, wb)).astype(np.int32),
               act=np.ones((hb, wb), bool))
    nb = 37                                 # not a multiple of the world
    f3 = rng.integers(-5, 6, (nb, 3))
    fh = np.zeros((nb, 7), np.int32)
    fh[:, :3] = f3
    fh[:, 4:] = f3[:, ::-1]
    fh[:, 3] = 128 - 2 * f3.sum(1)
    inp.update(lr_padded=rng.integers(0, 255, (nb, 70, 70)).astype(np.int32),
               lr_fh=fh)
    inp.update(
        refs=rng.integers(0, 255, (7, 64, 64)).astype(np.int32),
        units=np.stack([np.stack([
            rng.integers(0, 7, 8), rng.integers(-3, 48, 8),
            rng.integers(-3, 48, 8), rng.integers(1, 16, 8),
            rng.integers(1, 16, 8), rng.integers(0, 9, 8)], axis=1)
            for _ in range(world)]).astype(np.int32))
    inp["ref0"] = rng.integers(0, 255, (32, 32)).astype(np.int32)
    for f in range(3):
        inp[f"chain{f}"] = np.asarray(
            [(dy, dx, min(dy + int(rng.integers(-8, 8)), 32 - 16),
              int(rng.integers(-4, 24)), int(rng.integers(1, 16)),
              int(rng.integers(1, 16)), int(rng.integers(0, 9)))
             for dy in range(0, 25, 8) for dx in range(0, 25, 8)],
            np.int32)
    inp["ref_a"] = rng.integers(0, 256, (32, 48)).astype(np.int32)
    inp["ref_b"] = rng.integers(0, 1024, (32, 48)).astype(np.int32)
    return inp


def run_rank(mesh, world: int, stream: bytes | None = None):
    """This rank's part of the dry run (every rank calls it with the same
    arguments). Returns {check: {"equal": bool, "ms": float}}; the stream
    check also carries both md5s and the Decoder's time."""
    from ..ops.cdef import cdef_filter_plane
    from ..ops.itx import itx_residual
    from ..ops.itx_meta import DCT_DCT, TX_16X16
    from ..ops.loopfilter import deblock_plane
    from ..ops.looprestoration import wiener_batch
    from ..ops.mc import mc_unit_batch
    from .filter_shard import band_cdef_plane, band_deblock_plane, \
        shard_lr_batch
    from .frame_pipe import fanout_gop_mc
    from .multihost import exchange_level_refs, global_mesh
    from .row_overlap import run_banded_chain
    from .tile_shard import sharded_recon_step

    dev = mesh_device(mesh)
    inp = dryrun_inputs(world)

    def t(name):
        return torch.as_tensor(inp[name], device=dev)

    out = {}

    def check(name, fn, want):
        got, ms = _timed(fn, dev)
        out[name] = {"equal": bool(torch.equal(got.cpu(), want.cpu())),
                     "ms": ms}
        return got

    # 1) tx-block reconstruction sharded over the ranks, cyclic halo min
    rec = (t("pred") + itx_residual(t("coefs"), TX_16X16, DCT_DCT, 8)
           ).clamp(0, 255).reshape(world, -1, 16, 16)
    want = rec.clone()
    want[:, 0] = torch.minimum(rec[:, 0], rec.roll(1, dims=0)[:, -1])
    check("sharded_recon_step",
          lambda: sharded_recon_step(mesh, inp["pred"], inp["coefs"], 8),
          want.reshape(-1, 16, 16))

    # 2) row-band deblock (8-row halo + write-back delta), then CDEF
    # (2-row halo)
    lvl = t("lvl")
    db_args = (t("edge_v"), t("edge_h"), lvl, lvl, lvl, lvl, t("e_lut"),
               t("i_lut"))
    want = deblock_plane(t("plane"), *db_args, luma=True, bitdepth=8)
    db = check("band_deblock_plane",
               lambda: band_deblock_plane(mesh, t("plane"), *db_args,
                                          True, 8), want)
    cd_args = (t("dirs"), t("pri"), t("sec"), 5, t("act"), 8, 8, 8)
    check("band_cdef_plane", lambda: band_cdef_plane(mesh, db, *cd_args),
          cdef_filter_plane(db, db, *cd_args))

    # 3) loop-restoration stripe batch sharded, no halo
    lr = (t("lr_padded"), t("lr_fh"), t("lr_fh"), 64, 64, 8)
    check("shard_lr_batch", lambda: shard_lr_batch(mesh, *lr),
          wiener_batch(*lr))

    # 4) one GOP level's MC fanned out over the ranks
    refs, units = t("refs"), t("units")
    want = torch.stack([mc_unit_batch(
        (refs, u[:, 0], u[:, 1], u[:, 2], u[:, 3], u[:, 4], u[:, 5]),
        8, 8, True, True, 8, False) for u in units])
    check("fanout_gop_mc",
          lambda: fanout_gop_mc(mesh, inp["refs"], inp["units"], 8, 8,
                                True, True, 8), want)

    # 5) cross-frame row overlap: 3 dependent frames, each wave's units
    # sharded over the ranks, against the sequential order
    chain = [inp[f"chain{f}"] for f in range(3)]
    want = run_banded_chain(inp["ref0"], chain, 2, 16, 1, 8, 8,
                            sequential=True, device=dev)
    check("run_banded_chain",
          lambda: run_banded_chain(inp["ref0"], chain, 2, 16, 1, 8, 8,
                                   mesh=mesh), want)

    # 6) the reference-plane exchange over a ("host", "dev") mesh: host 0
    # owns slot 3, the last host slot 5
    hmesh = global_mesh(world, 1, mesh.device_type)
    me = hmesh.get_local_rank("host")
    produced = {3: (0, inp["ref_a"] if me == 0 else None),
                5: (world - 1, inp["ref_b"] if me == world - 1 else None)}
    got, ms = _timed(lambda: exchange_level_refs(hmesh, me, produced,
                                                 (32, 48)), dev)
    out["exchange_level_refs"] = {
        "equal": bool(np.array_equal(got[3], inp["ref_a"]) and
                      np.array_equal(got[5], inp["ref_b"])), "ms": ms}

    # 7) a whole stream, tile-sharded, against the Decoder on this device
    if stream is not None:
        (md5, n), ms = _timed(lambda: sharded_stream_decode(stream, mesh),
                              dev)
        (want_md5, want_n), decoder_ms = _timed(lambda: _md5_decode(
            Decoder(Settings(device=str(dev), logger=None)), stream), dev)
        out["sharded_stream_decode"] = {
            "equal": md5 == want_md5 and n == want_n, "ms": ms,
            "md5": md5, "decoder_md5": want_md5, "frames": n,
            "decoder_ms": decoder_ms}
    return out


def free_port() -> int:
    """A free TCP port on localhost for the process group's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, init_method, device, stream, queue):
    """One spawned rank: form the mesh, run, report (rank, result or the
    error's text)."""
    try:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        mesh = init_mesh(world, rank, init_method, device)
        try:
            queue.put((rank, run_rank(mesh, world, stream), None))
        finally:
            close_mesh()
    except Exception as e:     # reported to the launcher, which raises
        import traceback
        queue.put((rank, None, f"{e!r}\n{traceback.format_exc()}"))


def dryrun_multichip(world: int, device: str = "cuda",
                     stream: bytes | None = None, timeout: float = 600.0):
    """Run the dry run on `world` ranks of `device` ("cuda": NCCL, one
    card per rank; "cpu": gloo). Returns rank 0's results; raises if a
    rank fails, a check is unequal, or the ranks do not finish within
    `timeout` seconds (they are then killed)."""
    init_method = f"tcp://127.0.0.1:{free_port()}"
    if world == 1:
        mesh = init_mesh(1, 0, init_method, device)
        try:
            results = {0: run_rank(mesh, 1, stream)}
        finally:
            close_mesh()
    else:
        import multiprocessing as mp
        import queue as queue_mod
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init_method, device, stream,
                                   q))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(errors) < world:
                try:
                    rank, res, err = q.get(
                        timeout=max(deadline - time.monotonic(), 0.1))
                except queue_mod.Empty:
                    raise TimeoutError(
                        f"dry run: {world - len(results) - len(errors)} "
                        f"rank(s) did not finish in {timeout} s") from None
                if err is None:
                    results[rank] = res
                else:
                    errors[rank] = err
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise RuntimeError("dry run failed on rank(s) " + ", ".join(
                f"{r}:\n{e}" for r, e in sorted(errors.items())))
    bad = sorted(f"rank {r}: {k}" for r, res in results.items()
                 for k, v in res.items() if not v["equal"])
    if bad:
        raise AssertionError(f"dry run mismatches: {bad}")
    return results[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dav1d_mirror_tpu_torch.parallel."
                                      "dryrun")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card per rank) or cpu (gloo)")
    ap.add_argument("--stream", default=None,
                    help="an IVF stream with --world tiles per frame to "
                         "decode tile-sharded")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    stream = None
    if args.stream:
        with open(args.stream, "rb") as f:
            stream = f.read()
    try:
        res = dryrun_multichip(args.world, args.device, stream,
                               timeout=args.timeout)
    except (AssertionError, RuntimeError, TimeoutError, DecodeError) as e:
        print(f"dry run FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"world": args.world, "device": args.device,
                      "checks": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
