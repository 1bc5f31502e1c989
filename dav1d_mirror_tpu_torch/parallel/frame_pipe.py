# Ported from dav1d_mirror_tpu/parallel/frame_pipe.py (plan_gop_levels :33,
# fanout_gop_mc :60).
"""Frame/GOP pipeline parallelism: the rank axis for multi-frame decode.

The reference overlaps frames with frame contexts (n_fc = min(8,
ceil(sqrt(n_tc))), dav1d src/lib.c:111-123) and blocks each frame's
sbrows on reference-row progress atomics (src/thread_task.c:403-431).
Across ranks the same dependency structure becomes a STATIC schedule:

  1. ``plan_gop_levels``: group frames into dependency levels from the
     reference-slot graph (a frame depends on the in-batch frames that
     last wrote the slots it references). Frames in one level are
     mutually independent.
  2. ``fanout_gop_mc``: run one level's motion compensation sharded over
     the ranks. Every rank holds the reference planes (the reference's
     shared-memory progress waits become replicated inputs).
"""
from __future__ import annotations

import torch

from ..ops.mc import mc_unit_batch
from .mesh import all_gather_slabs, axis_info, mesh_device, shard_bounds


def plan_gop_levels(frame_hdrs):
    """frame_hdrs: decode-order list of FrameHeaders in one batch.
    Returns a list of levels, each a list of indices into frame_hdrs;
    frames in one level reference only slots written by earlier levels
    (or refs outside the batch), so their pixel reconstruction can run
    concurrently. This is the static form of dav1d's per-row progress
    gating (thread_task.c check_tile:403-431)."""
    slot_writer = [-1] * 8          # frame index that last wrote slot i
    level_of = [0] * len(frame_hdrs)
    levels = []
    for i, f in enumerate(frame_hdrs):
        lvl = 0
        if f.frame_type in (1, 3):  # INTER / SWITCH
            for r in set(f.refidx):
                w = slot_writer[r]
                if w >= 0:
                    lvl = max(lvl, level_of[w] + 1)
        level_of[i] = lvl
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append(i)
        for s in range(8):
            if (f.refresh_frame_flags >> s) & 1:
                slot_writer[s] = i
    return levels


def fanout_gop_mc(mesh, ref_stack, units, uw: int, uh: int, has_h: bool,
                  has_v: bool, bitdepth: int):
    """One dependency level's MC across the mesh's first axis.

    ref_stack: (R, H, W) int32 reference planes, shared by every frame
    in the level (whole on every rank). units: (F, N, 6) int32 per-frame
    unit descriptors (ref, oy, ox, mx, my, f2d), F divisible by the axis
    size. Returns the whole (F, N, uh, uw) predicted units on every
    rank."""
    _, n, me, _ = axis_info(mesh)
    dev = mesh_device(mesh)
    refs = torch.as_tensor(ref_stack, device=dev).to(torch.int32)
    units = torch.as_tensor(units, device=dev).to(torch.int32)
    a, b = shard_bounds(units.shape[0], n, me)
    own = torch.stack([
        mc_unit_batch((refs, u[:, 0], u[:, 1], u[:, 2], u[:, 3], u[:, 4],
                       u[:, 5]), uw, uh, has_h, has_v, bitdepth, False)
        for u in units[a:b]])
    out = all_gather_slabs(own, mesh)
    return out.reshape(-1, *own.shape[1:])
