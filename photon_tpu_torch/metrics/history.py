"""Round/step metric history (the port of ``photon_tpu/metrics/history.py``).

A plain serializable record. There is no wandb mirror in this package:
:func:`make_wandb_run` returns ``None``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any


class History:
    def __init__(self, wandb_run: Any | None = None) -> None:
        """``wandb_run`` is taken for the JAX signature; nothing mirrors."""
        self.rounds: dict[str, list[tuple[int, float]]] = defaultdict(list)

    def record(self, server_round: int, metrics: dict[str, float]) -> None:
        """Keep the float-coercible values; others are dropped."""
        for k, v in metrics.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            self.rounds[k].append((server_round, fv))

    def latest(self, key: str) -> float | None:
        series = self.rounds.get(key)
        return series[-1][1] if series else None

    def series(self, key: str) -> list[tuple[int, float]]:
        return list(self.rounds.get(key, []))

    def cumulative(self, key: str) -> float:
        return float(sum(v for _, v in self.rounds.get(key, [])))

    def to_dict(self) -> dict:
        return {k: list(v) for k, v in self.rounds.items()}

    @classmethod
    def from_dict(cls, d: dict, wandb_run: Any | None = None) -> "History":
        h = cls(wandb_run)
        for k, series in (d or {}).items():
            h.rounds[k] = [(int(r), float(v)) for r, v in series]
        return h


def make_wandb_run(project: str | None, run_name: str, config: dict | None = None) -> None:
    """No wandb here: metrics stay local."""
    return None
