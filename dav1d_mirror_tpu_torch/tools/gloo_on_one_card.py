"""Can two gloo ranks on one CUDA card carry the parallel paths' exchange?

    python3 -m dav1d_mirror_tpu_torch.tools.gloo_on_one_card

Run from the repo root on a machine with a CUDA card. NCCL puts no two
ranks on one GPU, so a single card runs the parallel paths (parallel/)
only at world size 1 on NCCL. gloo takes CUDA tensors for some
collectives; this starts two gloo ranks on card 0 (spawned processes),
tries each collective the parallel paths use on CUDA tensors (all_gather,
send/recv through mesh.ppermute, all_reduce) and then the dry run's
steps (parallel/dryrun.run_rank), and prints one JSON object per rank:
"ok" or the error of each. It never falls back: what gloo cannot carry
shows as an error.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import queue
import sys
import traceback

import torch
import torch.distributed as dist


def _rank(rank, world, addr, q):
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from ..parallel import dryrun
        from ..parallel.mesh import all_gather_slabs, ppermute
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=addr, world_size=world,
                                rank=rank)
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("tile",))
        x = torch.full((4, 8), rank + 1, dtype=torch.int32, device="cuda")
        res = {}
        for name, fn in (("all_gather", lambda: all_gather_slabs(x, mesh)),
                         ("ppermute", lambda: ppermute(x, mesh, [(0, 1)])),
                         ("all_reduce", lambda: dist.all_reduce(x.clone()))):
            try:
                fn()
                torch.cuda.synchronize()
                res[name] = "ok"
            except RuntimeError as e:
                res[name] = repr(e)[:300]
        try:
            steps = dryrun.run_rank(mesh, world)
            res["run_rank"] = {k: v["equal"] for k, v in steps.items()}
        except RuntimeError as e:
            res["run_rank"] = repr(e)[:300]
        q.put((rank, res))
        dist.destroy_process_group()
    except Exception:      # reported to the parent, which prints it
        q.put((rank, traceback.format_exc()[-1500:]))


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_on_one_card: torch.cuda is not available",
              file=sys.stderr)
        return 1
    from ..parallel.dryrun import free_port
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    addr = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, 2, addr, q))
             for r in range(2)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            rank, res = q.get(timeout=240)
            out[rank] = res
    except queue.Empty:
        out["error"] = "a rank did not report within 240 s"
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join()
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
