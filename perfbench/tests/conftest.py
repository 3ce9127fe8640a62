"""Shared fixtures of the benchmark's tests (no JAX here)."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    """The card; a test that takes it skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures only there)")
    return torch.device("cuda", 0)
