"""Runtime invariant detectors (the port of ``photon_tpu/analysis/``'s
runtime half): the lock-order recorder and the retrace sentinel, in
:mod:`photon_tpu_torch.analysis.runtime`. photon-lint, the static half,
is not ported yet."""
