"""On the card: each configuration's control, at the cell's own size and
load on three seeds, comes out not correct, and the program as each cell
runs it comes out correct.

    python -m pytest benchmark/tests/test_benchmark_card.py -q -m card

(from the repo root, on the H100; each skips without a CUDA device).
"""
import json
import os

import pytest

from conftest import ROOT
from harness import spec

SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", _cells())
def test_control_is_not_correct_on_the_card(cuda, cell):
    from tools import control
    c = control.control_cell(spec.load_cell(ROOT, cell))
    for seed, nums, correct, _ in control.readings(c, SEEDS, 5.0, cuda):
        assert not correct and nums["failed_pictures"] > 0, (seed, nums)


@pytest.mark.card
@pytest.mark.parametrize("cell", _cells())
def test_cell_is_correct_on_the_card(cuda, cell):
    from tools import control
    c = spec.load_cell(ROOT, cell)
    for seed, nums, correct, attempted in control.readings(
            c, SEEDS[:1], 5.0, cuda):
        assert correct and attempted > 0, (seed, nums)
