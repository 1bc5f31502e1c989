"""Per-stage wall time of the decode (host entropy, planning, device
execute, host pass 2, filters).

Off by default: ``scope`` then costs one branch. When ``enabled``, each
scope that names a CUDA device synchronizes it on exit, so device work
queued inside the scope is charged to that scope and not to whichever
later scope happens to wait for it, and marks its span as an NVTX range
for a GPU timeline. utils/trace renders the totals. The pipelined decoder
opens scopes on its worker threads too: the totals are kept under a lock,
and a stage's time is the sum over threads, so stages of a pipelined
decode overlap and do not add up to its wall time.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch

enabled = False
_acc = defaultdict(float)
_cnt = defaultdict(int)
_lock = threading.Lock()


def reset():
    with _lock:
        _acc.clear()
        _cnt.clear()


@contextlib.contextmanager
def scope(name: str, device=None):
    if not enabled:
        yield
        return
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.nvtx.range_push(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.nvtx.range_pop()
        dt = time.perf_counter() - t0
        with _lock:
            _acc[name] += dt
            _cnt[name] += 1


def seconds() -> dict:
    """{stage: total seconds} accumulated since reset()."""
    with _lock:
        return dict(_acc)


def calls() -> dict:
    """{stage: number of scopes} accumulated since reset()."""
    with _lock:
        return dict(_cnt)
