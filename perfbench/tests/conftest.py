"""Settings of the benchmark's own tests: the harness and the reference
import from perfbench/, the program from the repository's root. Tests
that need the card take the `card` fixture, which decides at run time,
never at import, whether there is one."""

import sys
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parent.parent
for p in (PERFBENCH, PERFBENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda", 0)
