"""A module-scoped fixture for the port's test files: one intra-op torch
thread while the file runs, and the JAX package's telemetry teardown
working on jax 0.9.0.

The port's CPU cases run tiny shapes, which gain nothing from more
threads. Under the suite's parallel workers (``-n 6``), each worker's
torch would start as many OpenMP threads as the host has cores, and the
workers' threads then wait on each other: three port files that take
15–50 s alone took 310–350 s side by side with the default threads, and
25–48 s with one thread each. Import it into a test module (the name is
the fixture); the thread count is restored when the module ends.

Many port files run the JAX package as their reference, and its telemetry
teardown calls ``jax._src.monitoring._unregister_event_duration_listener_by_callback``,
which jax 0.9.0 renamed ``unregister_event_duration_listener`` (the same
one-callback function). A JAX test that fails in that teardown leaves its
listener installed, and every later teardown in the same worker fails
again, whichever file it is in. While a port file runs, the old name is
aliased to the new one (where JAX is loaded and lacks it), so the JAX
reference's teardown runs; nothing under ``photon_tpu/`` changes, and the
alias is undone when the file ends. Card-side files, which import no JAX,
get the thread count alone.
"""

from __future__ import annotations

import sys

import pytest
import torch

_OLD_NAME = "_unregister_event_duration_listener_by_callback"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monitoring = sys.modules.get("jax._src.monitoring")
    try:
        with pytest.MonkeyPatch.context() as mp:
            if monitoring is not None and not hasattr(monitoring, _OLD_NAME):
                mp.setattr(monitoring, _OLD_NAME,
                           monitoring.unregister_event_duration_listener, raising=False)
            yield
    finally:
        torch.set_num_threads(n)
