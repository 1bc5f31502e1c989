"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration's file, its traffic file and one reader a metric.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, so a cell or a metric is added with files and
``BENCHMARK.json`` entries alone:

- ``BENCHMARK.json`` (the checkout's root): the cells and metrics;
- the configuration's ``file`` (``benchmark/configs/<config>.json``): the
  stream pool, its coding, the guarantees and the control;
- ``benchmark/traffic/<traffic>.json``: the decoder's settings and the loop;
- ``benchmark/metrics/<metric>.py``: ``read(record)``, the metric's value
  or None where the run recorded nothing it reads.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    # {metric name: its BENCHMARK.json entry}, in the file's order
    end_to_end: dict = field(default_factory=dict)
    per_layer: dict = field(default_factory=dict)


def _load_json(root, rel):
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether `cell` reports `metric`: the cells its ``workloads`` list,
    or, without that key, every cell that reports the end-to-end metric
    it moves (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_of_cell


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of ``root/BENCHMARK.json``, with its configuration,
    traffic and metrics. Raises KeyError for an unknown cell."""
    bench = _load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root, configs[w["config"]]["file"])
    traffic = _load_json(root, os.path.join(
        "benchmark", "traffic", f"{w['traffic']}.json"))
    e2e = {m["name"]: m for m in bench["end_to_end"]
           if _reports(m, name, set())}
    per_layer = {m["name"]: m for m in bench["per_layer"]
                 if _reports(m, name, set(e2e))}
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def load_reader(root: str, metric: str):
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_names(bench: dict) -> list:
    """The names and units of a BENCHMARK.json that break its rules."""
    bad = []
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [w[k] for w in bench["workloads"] for k in ("config", "traffic")] + \
        [k for c in bench["configs"] for k in c["reduced"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    bad += [n for n in names if not NAME.match(n)]
    bad += [m["unit"] for m in metrics if not UNIT.match(m["unit"])]
    for group in (bench["configs"], bench["workloads"], metrics):
        seen = [g["name"] for g in group]
        bad += sorted({n for n in seen if seen.count(n) > 1})
    return bad
