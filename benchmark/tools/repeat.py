#!/usr/bin/env python3
"""Run one cell several times, one process a run, one run after another,
and print each run's result and each metric's spread.

    python3 benchmark/tools/repeat.py --workload <cell> --seeds 1,2,3
        --seconds <s> [--trace 0|1] [--out FILE.jsonl]

Each run is ``python3 benchmark/run.py`` from this checkout's root, as
the check runs it. The spread of a metric is the distance
between the first and third quartile (``statistics.quantiles(values,
n=4)``) over its median. `--out` keeps every run's result line, exit code,
wall time and the end of its standard error, one JSON object a line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    runs = []
    for seed in (int(s) for s in opts.seeds.split(",")):
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             opts.workload, "--seed", str(seed), "--seconds",
             str(opts.seconds), "--trace", str(opts.trace)],
            cwd=ROOT, capture_output=True, text=True, timeout=1500)
        wall = time.time() - t0
        lines = r.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        run = {"workload": opts.workload, "seed": seed,
               "trace": opts.trace, "rc": r.returncode, "wall_s": wall,
               "result": result, "stderr_tail": r.stderr[-3000:]}
        runs.append(run)
        if opts.out:
            with open(opts.out, "a") as f:
                f.write(json.dumps(run) + "\n")
        metrics = {k: v["value"] for k, v in
                   ((result or {}).get("metrics") or {}).items()}
        print(f"seed {seed}: rc {r.returncode}, {wall:.1f} s, correct "
              f"{(result or {}).get('correct')}, "
              f"{(result or {}).get('attempted')} attempted, "
              f"{(result or {}).get('failed')} failed, "
              f"{json.dumps(metrics)}", flush=True)
        if r.returncode != 0 or result is None:
            print(r.stderr[-3000:], flush=True)
    names = sorted({k for run in runs
                    for k in ((run["result"] or {}).get("metrics") or {})})
    for name in names:
        vals = [run["result"]["metrics"][name]["value"] for run in runs
                if run["result"] and name in run["result"]["metrics"]]
        s = spread(vals)
        print(f"{name}: median {statistics.median(vals)!r}, values "
              f"{vals!r}, spread "
              f"{'n/a' if s is None else f'{100 * s:.3f} %'}")
    return 0 if all(run["rc"] == 0 and run["result"] and
                    run["result"]["correct"] for run in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
