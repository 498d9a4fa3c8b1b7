"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of a checkout. Tests that need the card carry the ``cuda`` marker
and decide about the card inside a fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skipped elsewhere)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    return "cuda"


@pytest.fixture
def root():
    return ROOT
