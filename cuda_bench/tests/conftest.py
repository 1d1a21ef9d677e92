"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that need the card and skip where there is none.

    python -m pytest cuda_bench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc (skips where CUDA is absent)",
    )


@pytest.fixture
def cuda():
    """The card; the test skips where CUDA is not available."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
