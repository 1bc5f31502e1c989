# Ported from dav1d_mirror_tpu/parallel/row_overlap.py (planners :25-92,
# _wave_step :94, run_banded_chain :113).
"""Cross-frame ROW-GRANULAR overlap: the static schedule that replaces
dav1d's per-row progress atomics.

dav1d lets frame N+1 start reconstructing superblock row r as soon as
frame N has finished filtering rows <= r + max_mv_rows
(src/thread_task.c:403-431 check_tile / lowest-pixel gating, updated
row-by-row at runtime). Without runtime atomics the same overlap is
derived STATICALLY: motion vectors are bounded (by the spec's MV range or
by a per-frame scan of the decoded MVs), so the dependency "band (f, r)
needs band (f', r + pad)" is known before any pixel work runs.
``plan_row_waves`` turns a GOP's frame dependency graph and per-frame
row-band counts into wavefronts of (frame, band) pairs; every wave's
members are mutually independent, so they run as one batched dispatch,
or shard over the ranks of a mesh.

The payoff over whole-frame leveling (``plan_gop_levels``): a chain of
F dependent frames with B bands each pipelines in F + (B-1)*step waves
instead of F*B, the classic software-pipelining diagonal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.mc import PAD_OOB, mc_unit_batch
from .mesh import all_gather_slabs, axis_info, mesh_device, shard_bounds


def mv_row_pad(max_mv_y_8px: int, band_rows: int) -> int:
    """How many of the REFERENCE frame's bands a band can reach.

    max_mv_y_8px: largest |MV.y| in 1/8-pel units (spec bound 1<<13, or
    a per-frame measured bound); band_rows: pixel rows per band.
    +8 covers the 8-tap filter reach below the MV target row."""
    reach = (max_mv_y_8px >> 3) + 8
    return -(-reach // band_rows)


def plan_row_waves(deps: list[list[int]], n_bands: int, pad: int):
    """Static row-granular overlap schedule.

    deps: deps[f] = list of frame indices f' that frame f references
    (from ``plan_gop_levels``-style header analysis); intra/keyframes
    have deps[f] == [].  n_bands: row bands per frame.  pad: how many
    extra bands of every reference must be complete before a band can
    run (``mv_row_pad``).

    Returns a list of waves; each wave is a list of (frame, band)
    pairs, all mutually independent given previous waves are done.
    Property: band (f, r) is scheduled strictly after band (f', r')
    for every dependency f' and every r' <= min(r + pad, n_bands-1).
    """
    wave_of = {}
    for f in range(len(deps)):
        for r in range(n_bands):
            w = 0
            if deps[f]:
                for fp in deps[f]:
                    gate = min(r + pad, n_bands - 1)
                    w = max(w, wave_of[(fp, gate)] + 1)
            if r > 0:
                # in-frame raster order (intra/filters are sequential
                # down the frame; fully inter-parallel callers may drop
                # this by passing the bands of one frame as one unit)
                w = max(w, wave_of[(f, r - 1)] + 1)
            wave_of[(f, r)] = w
    waves = []
    for (f, r), w in wave_of.items():
        while len(waves) <= w:
            waves.append([])
        waves[w].append((f, r))
    return waves


def check_waves(waves, deps, n_bands: int, pad: int) -> None:
    """Assert the schedule's dependency property (used by tests and as
    a guard when deriving pads from measured MV bounds)."""
    done_at = {}
    for w, members in enumerate(waves):
        for f, r in members:
            done_at[(f, r)] = w
    for f, fdeps in enumerate(deps):
        for r in range(n_bands):
            for fp in fdeps:
                gate = min(r + pad, n_bands - 1)
                assert done_at[(fp, gate)] < done_at[(f, r)], \
                    (f, r, fp, gate)


def pipeline_depth(waves) -> int:
    return len(waves)


# ------------------------------------------------------------------
# wave executor: the schedule running on the MC unit batches
# ------------------------------------------------------------------
def _wave_step(stack, src, dst, dy, dx, oy, ox, mx, my, f2d, uw: int,
               uh: int, bitdepth: int, mesh=None):
    """One wave: every unit reads its source frame's plane out of the
    stack and writes its destination frame's plane back into it, in
    place. Pad rows carry dy == PAD_OOB: their writes are dropped. With a
    mesh, each rank predicts its shard of the units and the shards are
    all-gathered, so every rank's stack gets every unit."""
    cols = (src, oy, ox, mx, my, f2d)
    if mesh is not None:
        _, n, me, _ = axis_info(mesh)
        a, b = shard_bounds(src.shape[0], n, me)
        own = mc_unit_batch((stack,) + tuple(c[a:b] for c in cols), uw, uh,
                            True, True, bitdepth, False)
        pred = all_gather_slabs(own, mesh).reshape(-1, uh, uw)
    else:
        pred = mc_unit_batch((stack,) + cols, uw, uh, True, True, bitdepth,
                             False)
    ok = dy != PAD_OOB
    dev = stack.device
    yy, xx = torch.broadcast_tensors(
        dy[ok][:, None, None] + torch.arange(uh, device=dev)[None, :, None],
        dx[ok][:, None, None] + torch.arange(uw, device=dev)[None, None, :])
    dd = dst[ok][:, None, None].expand_as(yy)
    stack[dd.long(), yy.long(), xx.long()] = pred[ok].to(stack.dtype)
    return stack


def run_banded_chain(ref0, frame_units, n_bands: int, band_rows: int,
                     pad: int, uw: int, uh: int, bitdepth: int = 8,
                     sequential: bool = False, mesh=None, device="cuda"):
    """Reconstruct a chain of F inter frames, each motion-compensated
    from its predecessor, on the ``plan_row_waves`` schedule: the live
    form of dav1d's frame-threading row gates (src/thread_task.c:403).

    ref0: (H, W) int32 plane frame 0 predicts from. frame_units[f]:
    (N, 7) int32 rows [dst_y, dst_x, oy, ox, mx, my, f2d], the MC units
    of frame f reading frame f-1 (frame 0 reads ref0). Every unit's read
    window must satisfy oy + uh + 7 <= (dst_y // band_rows + pad + 1) *
    band_rows, i.e. ``pad`` from ``mv_row_pad`` of the stream's MV
    bound. Each wave is ONE batched dispatch covering every (frame, band)
    member: cross-frame overlap with no runtime synchronization.
    ``sequential=True`` ignores the overlap and runs frame-major
    band-major (the correctness anchor). ``mesh``: the wave's unit batch
    is sharded over its first axis and runs on the mesh's device;
    without one it runs on `device`.

    Returns (F, H, W) int32 reconstructed frames."""
    dev = mesh_device(mesh) if mesh is not None else torch.device(device)
    F = len(frame_units)
    H, W = ref0.shape
    deps = [[]] + [[f - 1] for f in range(1, F)]
    if sequential:
        waves = [[(f, r)] for f in range(F) for r in range(n_bands)]
    else:
        waves = plan_row_waves(deps, n_bands, pad)
        check_waves(waves, deps, n_bands, pad)

    by_band = {}
    for f, us in enumerate(frame_units):
        us = np.asarray(us, np.int32)
        band = us[:, 0] // band_rows
        for r in range(n_bands):
            by_band[(f, r)] = us[band == r]

    wave_rows = []
    for members in waves:
        rows = np.concatenate([by_band[m] for m in members])
        srcs = np.concatenate([np.full(len(by_band[m]), m[0], np.int32)
                               for m in members])
        wave_rows.append((rows, srcs))
    bmax = max(len(r) for r, _ in wave_rows)
    bmax = max(1 << (bmax - 1).bit_length(), 8)
    if mesh is not None:
        n = axis_info(mesh)[1]
        bmax = -(-bmax // n) * n

    stack = torch.zeros((F + 1, H, W), dtype=torch.int32, device=dev)
    stack[0] = torch.as_tensor(np.asarray(ref0, np.int32), device=dev)
    for rows, srcs in wave_rows:
        padn = bmax - len(rows)
        rows = np.concatenate([rows, np.zeros((padn, 7), np.int32)])
        rows[len(rows) - padn:, 0] = PAD_OOB
        srcs = np.concatenate([srcs, np.zeros(padn, np.int32)])
        args = [torch.as_tensor(a, device=dev) for a in
                (srcs, srcs + 1, rows[:, 0], rows[:, 1], rows[:, 2],
                 rows[:, 3], rows[:, 4], rows[:, 5], rows[:, 6])]
        stack = _wave_step(stack, *args, uw=uw, uh=uh, bitdepth=bitdepth,
                           mesh=mesh)
    return stack[1:]
