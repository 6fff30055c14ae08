"""The benchmark's own tests: `python -m pytest benchmark/tests -q`.

Tests marked `card` need an NVIDIA card and skip without one (run them on
the card: `python -m pytest benchmark/tests -q -m card`)."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips "
                            "without one")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors run faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The card's device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda", 0)
