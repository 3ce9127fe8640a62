"""A module-scoped fixture for the port's test files: one intra-op torch
thread while the file runs.

The port's CPU cases run tiny shapes, which gain nothing from more
threads. Under the suite's parallel workers (``-n 6``), each worker's
torch would start as many OpenMP threads as the host has cores, and the
workers' threads then wait on each other: three port files that take
15–50 s alone took 310–350 s side by side with the default threads, and
25–48 s with one thread each. Import it into a test module (the name is
the fixture); the thread count is restored when the module ends."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
