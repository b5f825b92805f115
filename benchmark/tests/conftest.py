"""Tests of the benchmark: ``python -m pytest benchmark/tests`` from the
repo root.  Tests that need the card take the ``card`` marker and the
``card`` fixture, which skips them with a reason where there is none; on
the chip, ``python -m pytest benchmark/tests -m card -o addopts=""`` runs them
(one process: the card is not shared between workers)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures and checks on the card only")
    return torch.device("cuda")
