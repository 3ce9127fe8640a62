"""Per-cohort server strategies (the port of ``photon_tpu/strategy/grouped.py``).

One :class:`~photon_tpu_torch.strategy.base.Strategy` per cohort, holding
that cohort's adapter and its server-optimizer state, under the global
plane's update rules: per cohort, an adapter round is a federated round
over a small payload::

    avg_c = Σ_{k ∈ cohort c} n_k · a_k / Σ n_k      (grouped_host_fold)
    a_c'  = server_update_c(a_c − avg_c)            (apply_average)

:func:`grouped_host_fold` is ``aggregate_inplace`` per cohort: the JAX
package's oracle for its fused multi-cohort program, and here the fold
itself. The JAX class's rollback (``snapshot``/``restore``) and column
index serve its collective runner's elastic ladder and fused program,
which are not ported.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from photon_tpu_torch.config.schema import FLConfig
from photon_tpu_torch.strategy.aggregation import aggregate_inplace
from photon_tpu_torch.strategy.dispatcher import dispatch_strategy


class CohortStrategies:
    """Per-cohort server optimizers over adapter payloads."""

    def __init__(self, fl_cfg: FLConfig, cohort_names: Iterable[str]) -> None:
        self.names = sorted(cohort_names)
        if not self.names:
            raise ValueError("need at least one cohort")
        self.strategies = {n: dispatch_strategy(fl_cfg) for n in self.names}

    def __getitem__(self, cohort: str):
        return self.strategies[cohort]

    @property
    def state_keys(self) -> tuple[str, ...]:
        return next(iter(self.strategies.values())).state_keys

    def initialize(self, adapters: dict[str, list[np.ndarray]],
                   state: dict[str, dict[str, list[np.ndarray]]] | None = None,
                   t: dict[str, int] | None = None) -> None:
        for name in self.names:
            if name not in adapters:
                raise ValueError(f"no initial adapter for cohort {name!r}")
            self.strategies[name].initialize(adapters[name], (state or {}).get(name))
            if t and name in t:
                self.strategies[name]._t = int(t[name])

    def params(self, cohort: str) -> list[np.ndarray]:
        return self.strategies[cohort].current_parameters

    def apply_average(self, server_round: int, cohort: str, avg: list[np.ndarray],
                      n_samples: int, n_clients: int) -> dict[str, float]:
        """One cohort's pseudo-gradient and server-optimizer step
        (``Strategy.apply_average`` over the cohort's payload)."""
        return self.strategies[cohort].apply_average(server_round, avg, n_samples, n_clients)

    def adapters_for_checkpoint(self) -> dict[str, list[np.ndarray]]:
        return {n: list(s.current_parameters) for n, s in self.strategies.items()}

    def state_for_checkpoint(self) -> dict[str, dict[str, list[np.ndarray]]]:
        return {n: s.state_for_checkpoint() for n, s in self.strategies.items()}

    def t_counters(self) -> dict[str, int]:
        return {n: int(getattr(s, "_t", 0)) for n, s in self.strategies.items()}


def cohort_of_map(cohorts: dict[str, list[int]]) -> dict[int, str]:
    """The config's cohort map → client id lookup (validation refused
    overlaps)."""
    return {int(cid): name for name, cids in cohorts.items() for cid in cids}


def grouped_host_fold(landed: dict[int, tuple[list[np.ndarray], int]],
                      cohort_of: dict[int, str]) -> dict[str, tuple[list[np.ndarray], int, int]]:
    """Per-cohort streaming fold over the adapter deltas that landed:
    ``{cohort: (avg, Σn, n_clients)}`` for each cohort with a member in
    ``landed`` (silent cohorts are absent: their state stays as it was).
    Members fold in client-id order; ``landed`` is not written."""
    members: dict[str, list[int]] = {}
    for cid in sorted(landed):
        name = cohort_of.get(int(cid))
        if name is not None:
            members.setdefault(name, []).append(cid)
    out: dict[str, tuple[list[np.ndarray], int, int]] = {}
    for name, cids in members.items():
        avg, n_total = aggregate_inplace((landed[cid][0], landed[cid][1]) for cid in cids)
        out[name] = (avg, n_total, len(cids))
    return out
