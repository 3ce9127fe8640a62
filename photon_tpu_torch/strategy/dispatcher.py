"""Strategy dispatch by config name."""

from __future__ import annotations

from photon_tpu_torch.config.schema import FLConfig
from photon_tpu_torch.strategy.base import Strategy
from photon_tpu_torch.strategy.optimizers import FedAdam, FedAvgEff, FedMom, FedNesterov, FedYogi

_REGISTRY: dict[str, type[Strategy]] = {
    "fedavg": FedAvgEff,
    "nesterov": FedNesterov,
    "fedmom": FedMom,
    "fedadam": FedAdam,
    "fedyogi": FedYogi,
}


def dispatch_strategy(fl: FLConfig) -> Strategy:
    if fl.strategy_name not in _REGISTRY:
        raise ValueError(f"unknown fl.strategy_name {fl.strategy_name!r}")
    return _REGISTRY[fl.strategy_name](
        server_learning_rate=fl.server_learning_rate,
        server_momentum=fl.server_momentum,
        server_beta_1=fl.server_beta_1,
        server_beta_2=fl.server_beta_2,
        server_tau=fl.server_tau,
        client_count_scaling=fl.client_count_scaling,
    )
