# Ported from dav1d_mirror_tpu/utils/trace.py, over utils/stages.py.
"""Decode-stage tracing: a per-stage summary of the decode's wall time.

`trace_scope` is utils/stages.scope: a named span that, while tracing is
on (`enable`), accumulates its wall time and calls, synchronizes the
device it names on exit and marks itself as an NVTX range when that
device is CUDA. The decoder's own stages (host-entropy, plan, device,
host-pass2, filters, grain) are such spans. `stats()` returns the totals
and `report()` renders them. For a device-side kernel timeline, run the
decode under torch.profiler (the CLI's --profile); the NVTX ranges show
the stages there.
"""
from __future__ import annotations

from . import stages

trace_scope = stages.scope


def enable(on: bool = True):
    """Turn stage tracing on (or off) for the whole process."""
    stages.enabled = bool(on)


def reset():
    stages.reset()


def stats() -> dict:
    """{stage: (total_seconds, calls)} accumulated since reset()."""
    cnt = stages.calls()
    return {k: (t, cnt.get(k, 0)) for k, t in stages.seconds().items()}


def report(out=None) -> str:
    acc = stats()
    lines = [f"{'stage':24s} {'total ms':>10s} {'calls':>7s} {'ms/call':>9s}"]
    for k in sorted(acc, key=lambda k: acc[k][0], reverse=True):
        t, n = acc[k]
        lines.append(f"{k:24s} {t * 1000:10.2f} {n:7d} "
                     f"{t * 1000 / max(n, 1):9.3f}")
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text
