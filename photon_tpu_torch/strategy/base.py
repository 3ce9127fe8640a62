"""Strategy base: server optimization on the pseudo-gradient over flat
ndarray lists (the port of ``photon_tpu/strategy/base.py``, host-side
numpy as there).

Each round the server averages the client parameters (streaming,
sample-weighted), forms the pseudo-gradient ``g_i = x_i - avg_i`` per
layer and applies a server optimizer. Subclasses implement
:meth:`server_update`; ``state_keys`` name the per-layer state lists
checkpointed beside the parameters. Strategies REBIND
``current_parameters`` and state list slots to fresh arrays each round and
never write into an array in place: the async checkpoint writer holds the
previous round's arrays by reference.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Iterable

import numpy as np

from photon_tpu_torch.strategy.aggregation import (
    aggregate_inplace,
    weighted_average_metrics,
    weighted_loss_avg,
)
from photon_tpu_torch.utils.profiling import (
    AGG_DECODE_TIME,
    AGG_FOLD_TIME,
    EFFECTIVE_LR,
    EVAL_LOSS,
    N_CLIENTS,
    N_SAMPLES,
    PARAM_NORM,
    PSEUDO_GRAD_NORM,
    SERVER_UPDATE_TIME,
)


@dataclasses.dataclass
class ClientResult:
    """One client's round output."""

    cid: int
    arrays: list[np.ndarray]
    n_samples: int
    metrics: dict[str, float] = dataclasses.field(default_factory=dict)


def l2_norm(arrays: Iterable[np.ndarray]) -> float:
    return math.sqrt(sum(float(np.sum(np.square(a, dtype=np.float64))) for a in arrays))


class Strategy:
    name = "base"
    #: names of per-layer state lists checkpointed with the params
    state_keys: tuple[str, ...] = ()

    def __init__(
        self,
        server_learning_rate: float = 1.0,
        server_momentum: float = 0.0,
        client_count_scaling: str = "none",
        **_: Any,
    ) -> None:
        self.eta = server_learning_rate
        self.momentum = server_momentum
        self.client_count_scaling = client_count_scaling
        self.current_parameters: list[np.ndarray] | None = None
        self.state: dict[str, list[np.ndarray]] = {}
        #: shared host thread pool (``photon.host_threads``, set by the
        #: server); None = fully serial aggregation
        self.host_pool = None

    def initialize(self, parameters: list[np.ndarray],
                   state: dict[str, list[np.ndarray]] | None = None) -> None:
        self.current_parameters = [np.asarray(p, np.float32) for p in parameters]
        if state:
            self.state = {k: [np.asarray(a, np.float32) for a in v] for k, v in state.items()}
        for key in self.state_keys:
            if key not in self.state:
                self.state[key] = [np.zeros_like(p) for p in self.current_parameters]

    def effective_lr(self, n_clients: int) -> float:
        """lr scaled with the sampled-client count (none, linear or sqrt)."""
        if self.client_count_scaling == "linear":
            return self.eta * n_clients
        if self.client_count_scaling == "sqrt":
            return self.eta * math.sqrt(n_clients)
        return self.eta

    def aggregate_fit(self, server_round: int, results: Iterable[ClientResult]
                      ) -> tuple[list[np.ndarray], dict[str, float]]:
        """Streaming average → pseudo-gradient → server optimizer.
        ``results`` may be a generator; clients fold in one at a time."""
        if self.current_parameters is None:
            raise RuntimeError("strategy not initialized with parameters")
        seen: list[tuple[int, dict[str, float]]] = []

        def stream():
            for r in results:
                seen.append((r.n_samples, r.metrics))
                yield r.arrays, r.n_samples

        timings: dict[str, float] = {}
        avg, n_total = aggregate_inplace(stream(), pool=self.host_pool, timings=timings)
        t_update = time.monotonic()
        metrics = self.apply_average(server_round, avg, n_total, len(seen))
        metrics[SERVER_UPDATE_TIME] = time.monotonic() - t_update
        metrics[AGG_DECODE_TIME] = timings.get("decode_s", 0.0)
        metrics[AGG_FOLD_TIME] = timings.get("fold_s", 0.0)
        metrics.update(weighted_average_metrics(seen))
        return self.current_parameters, metrics

    def apply_average(self, server_round: int, avg: list[np.ndarray], n_total: int,
                      n_clients: int) -> dict[str, float]:
        """Pseudo-gradient → server optimizer → norm telemetry."""
        if self.current_parameters is None:
            raise RuntimeError("strategy not initialized with parameters")
        if len(avg) != len(self.current_parameters):
            raise ValueError(
                f"averaged payload has {len(avg)} arrays, strategy holds "
                f"{len(self.current_parameters)} (momenta mismatch? the server extends "
                "initial params with zero momenta when aggregate_momenta is on)"
            )
        pseudo_grad = [x - a for x, a in zip(self.current_parameters, avg)]
        lr = self.effective_lr(n_clients)
        new_params = self.server_update(pseudo_grad, lr)
        metrics: dict[str, float] = {N_CLIENTS: float(n_clients), N_SAMPLES: float(n_total),
                                     EFFECTIVE_LR: lr, **self.norm_telemetry(pseudo_grad)}
        self.current_parameters = new_params
        return metrics

    def aggregate_evaluate(self, server_round: int,
                           results: Iterable[tuple[int, float, dict[str, float]]]
                           ) -> tuple[float, dict[str, float]]:
        """Sample-weighted eval loss and metrics."""
        results = list(results)
        loss = weighted_loss_avg([(n, l) for n, l, _ in results])
        metrics = weighted_average_metrics([(n, m) for n, _, m in results])
        metrics[EVAL_LOSS] = loss
        return loss, metrics

    def server_update(self, pseudo_grad: list[np.ndarray], lr: float) -> list[np.ndarray]:
        raise NotImplementedError

    def norm_telemetry(self, pseudo_grad: list[np.ndarray]) -> dict[str, float]:
        """Global L2 norms of the pseudo-gradient, the params and the state."""
        out = {PSEUDO_GRAD_NORM: l2_norm(pseudo_grad),
               PARAM_NORM: l2_norm(self.current_parameters or [])}
        for key, tensors in self.state.items():
            out[f"server/{key}_norm"] = l2_norm(tensors)
        return out

    def state_for_checkpoint(self) -> dict[str, list[np.ndarray]]:
        return {k: self.state[k] for k in self.state_keys if k in self.state}
