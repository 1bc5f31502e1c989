# Ported from dav1d_mirror_tpu/parallel/tile_shard.py (sharded_recon_step :25).
"""Tile sharding across ranks: the decoder's data-parallel axis.

AV1 tiles are entropy-independent; reconstruction is independent too
except for the in-loop filters that cross tile boundaries, which need a
row halo exchange (parallel/filter_shard). Reference behaviour replaced:
dav1d's shared-memory tile threading (src/thread_task.c:268-310), here a
rank per tile shard instead of a worker pool.
"""
from __future__ import annotations

import torch

from ..ops import itx_cuda
from ..ops.itx_meta import DCT_DCT, TX_16X16
from .mesh import all_gather_slabs, axis_info, mesh_device, ppermute, \
    shard_bounds


def sharded_recon_step(mesh, pred, coefs, bitdepth: int = 8):
    """Reconstruct a batch of 16x16 tx blocks sharded over the mesh's
    first axis: each rank inverse-transforms and clips its shard, then
    takes the element-wise min of its first row and the previous rank's
    last row (a cyclic one-row halo, as the reference's step composes
    recon with a collective). pred/coefs: (B, 16, 16) integers, B a
    multiple of the axis size, whole on every rank. Returns the whole
    (B, 16, 16) int32 result on every rank."""
    _, n, me, _ = axis_info(mesh)
    dev = mesh_device(mesh)
    pred = torch.as_tensor(pred, device=dev)
    coefs = torch.as_tensor(coefs, device=dev)
    a, b = shard_bounds(pred.shape[0], n, me)
    res = itx_cuda.itx_bucket("hres", coefs[a:b].to(torch.int32).reshape(
        b - a, -1), None, DCT_DCT, TX_16X16, bitdepth)
    rec = (pred[a:b].to(torch.int32) + res).clamp(0, (1 << bitdepth) - 1)
    halo = ppermute(rec[-1:], mesh, [(i, (i + 1) % n) for i in range(n)])
    rec[:1] = torch.minimum(rec[:1], halo)
    return all_gather_slabs(rec, mesh).reshape(-1, *rec.shape[1:])
