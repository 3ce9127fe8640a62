"""Per-cohort server strategies (the port of ``photon_tpu/strategy/grouped.py``).

One :class:`~photon_tpu_torch.strategy.base.Strategy` per cohort, holding
that cohort's adapter and its server-optimizer state, under the global
plane's update rules: per cohort, an adapter round is a federated round
over a small payload::

    avg_c = Σ_{k ∈ cohort c} n_k · a_k / Σ n_k      (grouped_host_fold)
    a_c'  = server_update_c(a_c − avg_c)            (apply_average)

:func:`grouped_host_fold` is ``aggregate_inplace`` per cohort: the JAX
package's oracle for its fused multi-cohort program, and here the fold
itself, and the collective runner's oracle for its grouped reduction
(``parallel/collective_agg.grouped_weighted_average``). ``snapshot`` and
``restore`` are the rollback point of that runner's elastic ladder.
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

    def index_of(self, cohort: str) -> int:
        """The cohort's column in the grouped reduction's one-hot rows
        (sorted-name order, stable across rounds)."""
        return self.names.index(cohort)

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

    def snapshot(self) -> dict:
        """Deep host copy of every cohort's params, state and ``_t``: the
        point an elastic retry restores (a partly applied grouped attempt
        must never step the cohorts it reached twice)."""
        return {
            name: ([a.copy() for a in (s.current_parameters or [])],
                   {k: [a.copy() for a in v] for k, v in s.state.items()},
                   int(getattr(s, "_t", 0)))
            for name, s in self.strategies.items()
        }

    def restore(self, snap: dict) -> None:
        for name, (params, state, t) in snap.items():
            s = self.strategies[name]
            s.current_parameters = [a.copy() for a in params]
            s.state = {k: [a.copy() for a in v] for k, v in state.items()}
            if hasattr(s, "_t"):
                s._t = t

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


def cohort_onehot(cids: Iterable[int], cohort_of: dict[int, str],
                  cohort_names: list[str]) -> np.ndarray:
    """``[len(cids), K]`` 0/1 assignment rows for the grouped reduction; a
    cid in no cohort is an all-zero row (it contributes nowhere)."""
    cids = list(cids)
    idx = {n: i for i, n in enumerate(cohort_names)}
    out = np.zeros((len(cids), len(cohort_names)), np.float32)
    for row, cid in enumerate(cids):
        name = cohort_of.get(int(cid))
        if name is not None:
            out[row, idx[name]] = 1.0
    return out


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
