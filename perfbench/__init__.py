"""The benchmark of ``photon_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 perfbench/run.py --workload train.mpt-125m --seed 7 --seconds 51 --trace 0

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run, its source,
  the keys changed from the source (``reduced``) and the sizes set here
  (``assumed``); ``reference`` names its plain model under ``reference/``;
- ``traffic/<mix>.json``: the parameters of a traffic mix, read by one
  general generator (``traffic.py``); ``runner`` names the module under
  ``runners/`` that runs it;
- ``metrics/<metric>.py``: a reader with ``read(record) -> float | None``
  over a traced run's :class:`perfbench.trace.Record`;
- ``limits/<cell>.json``: the limit of each number ``correct`` compares.

The harness imports nothing of the JAX package: only the port, its spans
and counters, and the kernel names the profiler sees.
"""
