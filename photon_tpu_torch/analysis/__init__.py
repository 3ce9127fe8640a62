"""photon-lint, the port of ``photon_tpu/analysis/``: the repo's invariants
checked by machine, in two halves, stdlib-only.

- the **static engine** (:mod:`core` + :mod:`rules`): a rule registry
  with families aimed at the port (``kpi-registry``,
  ``metric-discipline``, ``hook-gating``, ``retrace-hazard``,
  ``concurrency``, ``transport-discipline``), per-line suppression by a
  ``# photon-lint: ignore[rule-id]`` comment, a checked-in baseline
  (``baseline.json``) of deliberate findings, and a CLI
  (``python -m photon_tpu_torch.analysis``), which ``chip_smoke.py`` runs
  as its preflight;
- the **runtime detectors** (:mod:`runtime`): the lock-order recorder and
  the retrace sentinel.

Heavy imports stay out of this module: ``runtime`` must be importable from
hook sites without the AST engine, and the engine never imports the
modules it scans.
"""

from __future__ import annotations

__all__ = ["analyze_paths", "main"]


def analyze_paths(*args, **kwargs):
    from photon_tpu_torch.analysis.core import analyze_paths as _impl

    return _impl(*args, **kwargs)


def main(argv=None) -> int:
    from photon_tpu_torch.analysis.cli import main as _impl

    return _impl(argv)
