"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the repository. Tests marked ``cuda`` need the card and skip
without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH), str(BENCH / "tools")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels, "
        "TF32); skips without one")


@pytest.fixture
def card():
    """The card, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
