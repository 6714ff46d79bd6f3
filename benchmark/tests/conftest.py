"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository root. Tests marked ``card`` run the cells on a CUDA card
and skip without one; whether there is one is decided in the ``card``
fixture, never while a module is imported."""
from __future__ import annotations

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs a cell on a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run only on the card")
    return torch.device("cuda")
