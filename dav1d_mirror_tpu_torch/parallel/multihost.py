# Ported from dav1d_mirror_tpu/parallel/multihost.py (init_multihost :36,
# global_mesh :54, assign_level_frames :61, host_local_array :73,
# broadcast_ref_plane :84, exchange_level_refs :102).
"""Multi-host decode scale-out: one process group across hosts and the
reference-plane exchange.

The reference scales within one process through its worker pool
(src/thread_task.c:550 task loop; frame contexts src/lib.c:111-123) and
has no cross-machine story. Here:

* the processes form ONE group, with a ``("host", "dev")`` mesh over it
  (``init_multihost`` + ``global_mesh``): one process per rank, rank
  ``host * devs_per_host + dev``;
* GOP-level frame parallelism (``frame_pipe.plan_gop_levels``) assigns
  the independent frames of each level round-robin to hosts
  (``assign_level_frames``);
* after a host finishes a frame, its reference planes reach every other
  host as ONE collective over the ``"host"`` axis: broadcast-from-owner
  as a masked all-reduce sum (``broadcast_ref_plane``), the owner's
  contribution the plane and every other host's zeros;
* within a host, pixel work shards over ``"dev"`` as on a single host
  (parallel/filter_shard, parallel/tile_decode).

The group's address, size and this process's rank are given by the
caller: nothing here discovers a cluster.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axis_info, init_mesh, mesh_device


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   n_hosts: int | None = None, device: str = "cuda"):
    """Join the global decode group at `coordinator` (``host:port``) as
    process `process_id` of `num_processes`, NCCL on the card and gloo on
    the CPU, and return the ``("host", "dev")`` mesh of ``global_mesh``
    (`n_hosts` hosts, default one process per host)."""
    n_hosts = n_hosts or num_processes
    if num_processes % n_hosts:
        raise ValueError(f"{num_processes} processes do not split over "
                         f"{n_hosts} hosts")
    return init_mesh(num_processes, process_id, f"tcp://{coordinator}",
                     device, shape=(n_hosts, num_processes // n_hosts),
                     names=("host", "dev"))


def global_mesh(n_hosts: int, devs_per_host: int, device: str = "cuda"):
    """The ``("host", "dev")`` mesh over the initialized group (process
    ``h * devs_per_host + d`` is host h, device d)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type,
                            (n_hosts, devs_per_host),
                            mesh_dim_names=("host", "dev"))


def assign_level_frames(levels, n_hosts: int):
    """Round-robin the independent frames of each GOP level across
    hosts. Returns [{host: [frame_idx, ...]} per level]."""
    out = []
    for lvl in levels:
        a = {h: [] for h in range(n_hosts)}
        for j, fi in enumerate(lvl):
            a[j % n_hosts].append(fi)
        out.append(a)
    return out


def host_local_array(mesh, plane, shape, dtype=np.int32):
    """This process's (1, H, W) contribution to a host-stacked plane on
    its device: the plane where this host owns it, else zeros."""
    local = (np.zeros((1,) + tuple(shape), dtype) if plane is None
             else np.ascontiguousarray(np.asarray(plane)[None]).astype(dtype))
    return torch.as_tensor(local, device=mesh_device(mesh))


def broadcast_ref_plane(mesh, stacked, owner_host: int):
    """One collective over ``"host"``: every host receives owner_host's
    plane. stacked: this process's (1, H, W) contribution
    (host_local_array). The owner's slice is kept by a mask and summed
    over the host axis; the other hosts contribute zeros."""
    _, _, me, group = axis_info(mesh, "host")
    x = stacked * int(me == owner_host)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x[0]


def exchange_level_refs(mesh, my_host: int, produced: dict, shape,
                        dtype=np.int32):
    """After a GOP level completes: exchange every produced reference
    plane (slot -> plane on its owner host, None elsewhere) so all hosts
    enter the next level with identical reference state. Returns
    {slot: numpy plane} on every host.

    produced: {slot: (owner_host, plane_or_None)}, the plane not None
    exactly on the owner. Slots exchange in sorted order so every process
    issues the same collective sequence."""
    out = {}
    for slot in sorted(produced):
        owner, plane = produced[slot]
        stacked = host_local_array(
            mesh, plane if my_host == owner else None, shape, dtype)
        out[slot] = broadcast_ref_plane(mesh, stacked, owner).cpu().numpy()
    return out
