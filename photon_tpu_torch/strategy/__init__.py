"""Server strategies: the streaming fold and the FedAvg-family server
optimizers, host-side numpy (cohort strategies are not ported)."""

from photon_tpu_torch.strategy.aggregation import (  # noqa: F401
    aggregate_inplace,
    weighted_average_metrics,
    weighted_loss_avg,
)
from photon_tpu_torch.strategy.base import ClientResult, Strategy  # noqa: F401
from photon_tpu_torch.strategy.dispatcher import dispatch_strategy  # noqa: F401
from photon_tpu_torch.strategy.optimizers import (  # noqa: F401
    FedAdam,
    FedAvgEff,
    FedMom,
    FedNesterov,
    FedYogi,
)
