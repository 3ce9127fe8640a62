"""Server strategies: the streaming fold, the FedAvg-family server
optimizers and their per-cohort grouping, host-side numpy."""

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
from photon_tpu_torch.strategy.grouped import (  # noqa: F401
    CohortStrategies,
    cohort_of_map,
    grouped_host_fold,
)
