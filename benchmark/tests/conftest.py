"""The benchmark harness's tests: CPU tests, and tests marked ``card``
that need a CUDA device and skip without one (decided in the ``cuda``
fixture, never at import).

    python -m pytest benchmark/tests -q              # from the repo root
    python -m pytest benchmark/tests -q -m card      # on the H100
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"
