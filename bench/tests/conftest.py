"""Fixtures of the benchmark's CPU tests, and the ``chip`` marker for the
tests that need a CUDA card (they skip elsewhere; the skip is decided in
the ``card`` fixture, never while a module is imported).

    python -m pytest -q bench/tests             # on the CPU
    python -m pytest -q bench/tests -m chip     # on the card
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
