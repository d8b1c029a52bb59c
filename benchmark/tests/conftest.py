"""Tests of the benchmark's own code, run with `python -m pytest benchmark/tests`
from the root of the repository.  Tests marked `cuda` run on the card and
skip elsewhere."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
