"""Settings of the benchmark's own tests: the ``card`` marker (a test
that needs an NVIDIA card; it skips without one, decided in the
``cuda_card`` fixture) and the import path of the harness."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip: python -m "
        "pytest detbench/tests -m card)")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's kernels run only there")
    return torch.device("cuda")
