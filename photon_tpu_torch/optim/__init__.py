"""Optimizers and schedules (ADOPT, AdamW, cosine with warmup)."""

from photon_tpu_torch.optim.adopt import adopt_update  # noqa: F401
from photon_tpu_torch.optim.build import Optimizer, build_optimizer, build_schedule  # noqa: F401
