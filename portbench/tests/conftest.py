"""Shared set-up of the benchmark's own tests: the harness and the
checkout on the path, the ``cuda`` marker, small traffic for CPU runs."""

import sys
from pathlib import Path

import pytest
import torch

PORTBENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PORTBENCH))
sys.path.insert(1, str(PORTBENCH.parent))

# traffic cut to sizes a CPU test holds (widths stay the configuration's)
SMALL = {
    "serve": dict(batch=2, points=64, hypotheses=4, steps=4, check_units=2, span_units=1,
                  profile_units=1, warm_units=1),
    "train": dict(batch=4, points=512, repeat_num=2, pool=2, span_units=1, profile_units=1),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
