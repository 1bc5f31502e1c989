#!/usr/bin/env python3
"""Read the numbers ``correct`` compares, for the program as the cell runs
it and for the cell's control, on several seeds in one process.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1,2,3
        --seconds <s> [--sound]

The control is the program with the configuration's ``control.settings``
laid over the traffic's: a decoder path of its own that breaks one
guarantee the configuration states (a coded in-loop filter left out). It
runs at the cell's own size and load, and has to come out not correct.
With ``--sound`` the cell runs as it is, which gives the lower readings.
Each seed is a window of ``--seconds`` as in run.py, set-up once a seed.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import run  # noqa: E402
from harness import spec  # noqa: E402


def control_cell(cell: spec.Cell) -> spec.Cell:
    """The cell with its configuration's control settings laid over the
    traffic's settings."""
    traffic = dict(cell.traffic, settings={
        **cell.traffic["settings"], **cell.config["control"]["settings"]})
    return dataclasses.replace(cell, traffic=traffic)


def readings(cell: spec.Cell, seeds, seconds: float, device: str,
             root: str = run.ROOT) -> list:
    """[(seed, {number compared: value}, correct)] a seed."""
    out = []
    for seed in seeds:
        result, limits = run.run_cell(root, cell, seed, seconds, False,
                                      device)
        out.append((seed, {k: v for k, (v, _) in limits.items()},
                    result["correct"], result["attempted"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", action="store_true",
                    help="run the cell as it is (the lower readings)")
    opts = ap.parse_args()
    cell = spec.load_cell(run.ROOT, opts.workload)
    if not opts.sound:
        cell = control_cell(cell)
    seeds = [int(s) for s in opts.seeds.split(",")]
    rows = readings(cell, seeds, opts.seconds, "cuda")
    for seed, nums, correct, attempted in rows:
        print(json.dumps({"workload": opts.workload, "sound": opts.sound,
                          "seed": seed, "attempted": attempted,
                          "correct": correct, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
