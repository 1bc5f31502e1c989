# The Mesh / shard_map / ppermute use of dav1d_mirror_tpu/parallel/*.py,
# as torch.distributed process groups.
"""Process-group meshes and the collectives the parallel paths use.

JAX drives every shard of a ``shard_map`` from one controller; PyTorch
runs one process per rank. A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ``"tile"`` axis
(or ``("host", "dev")``), with NCCL on the card and gloo on the CPU. The
parallel functions keep the JAX call shape: every rank passes the whole
input, computes its own shard, and gets the whole output back through an
all-gather, so each rank's result equals the JAX function's.

* ``ppermute`` is ``jax.lax.ppermute``: each rank sends its tensor to its
  destination in the permutation and receives from its source; a rank
  that no pair sends to receives zeros, as in JAX. A send to itself (a
  cyclic permutation at world size 1) is a local copy.
* ``all_gather_slabs`` stacks equal-shaped per-rank slabs in rank order
  (the ``out_specs=P(axis)`` of a shard_map).

Nothing falls back: a CUDA mesh needs a CUDA device per rank and NCCL, a
CPU mesh uses gloo, and a group that cannot be formed raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_mesh(world: int, rank: int, init_method: str, device: str = "cuda",
              shape=None, names=("tile",)) -> DeviceMesh:
    """Join a `world`-process group at `init_method` (``tcp://host:port``)
    as `rank` and return the mesh of `shape` (default ``(world,)``) named
    `names`. On CUDA each rank takes the card of its local index (rank
    modulo the visible cards) and the backend is NCCL; on the CPU it is
    gloo."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was asked for but torch.cuda "
                               "is not available")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no mesh backend for device {device!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return init_device_mesh(dev.type, tuple(shape or (world,)),
                            mesh_dim_names=tuple(names))


def close_mesh():
    """Leave the process group (every rank calls this at the end)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The torch device of this rank's shard."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_info(mesh: DeviceMesh, axis: str | None = None):
    """(name, size, this rank's index, process group) of a mesh axis
    (default: the first)."""
    name = axis or mesh.mesh_dim_names[0]
    return (name, mesh.size(mesh.mesh_dim_names.index(name)),
            mesh.get_local_rank(name), mesh.get_group(name))


def ppermute(x: torch.Tensor, mesh: DeviceMesh, perm, axis=None):
    """jax.lax.ppermute over `axis`: perm is a list of (source, dest) axis
    indices. Returns what this rank receives (zeros if nothing)."""
    _, _, me, group = axis_info(mesh, axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def all_gather_slabs(x: torch.Tensor, mesh: DeviceMesh, axis=None):
    """Stack this axis' equal-shaped slabs in rank order: (n, *x.shape)."""
    _, n, _, group = axis_info(mesh, axis)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def shard_bounds(total: int, n: int, i: int):
    """[start, stop) of shard i when `total` rows split evenly in n (the
    caller pads `total` to a multiple of n, as P(axis) requires)."""
    if total % n:
        raise ValueError(f"{total} rows do not split over {n} shards")
    per = total // n
    return i * per, (i + 1) * per
