"""The benchmark's own tests: ``python -m pytest gpubench/tests -q`` from the
repository root (CPU, a few minutes). Tests marked ``card`` need a CUDA
device and skip without one; run them on the card with the same command."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
