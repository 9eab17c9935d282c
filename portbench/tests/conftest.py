"""The benchmark's own tests: on the CPU they run everything but the card.

    python -m pytest -p no:cacheprovider portbench/tests -q

Tests marked ``cuda`` skip without a CUDA device; on a machine with the card
the same command runs them too.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
