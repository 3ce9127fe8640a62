"""The learning-rate schedule and the optimizer chain, with optax's names.

The port of ``photon_tpu/optim/build.py``: cosine with warmup; ADOPT or
AdamW (optax semantics: bias-corrected ``mu / (sqrt(nu) + eps) + wd p``,
scaled by ``-lr(count)``); ``clip_by_global_norm`` first in the chain;
``freeze_patterns`` give zero updates. Under ``freeze_patterns`` the
clip's global norm covers only the trainable gradients (optax's
``multi_transform`` hands the clip the trainable subtree alone).
:meth:`Optimizer.apply` works tensor by tensor and in place: it clips the
gradients where they lie and adds each parameter's update as soon as it
is made, so the step holds no second full-size copy of the gradients or
of the updates (at mpt-3b each is 10.6 GB); the elementwise operations
and their order are optax's.

The state is a flat dict under the names optax's state flattens to, so a
checkpoint resumes across the two packages:

- ADOPT: ``{c}.count``, ``{c}.m/<param>``, ``{c}.v/<param>``;
- AdamW: ``{c}0/.count``, ``{c}0/.mu/<param>``, ``{c}0/.nu/<param>``,
  ``{c}2/.count`` (the schedule's own counter);

where ``{c}`` is ``1/`` after a clip and ``0/`` without one, and under
``freeze_patterns`` everything sits below ``.inner_states/train/
.inner_state/`` and frozen parameters have no entries. Counters are int32
scalars kept on the host (reading them never waits for the device); the
moments live beside their parameters and are updated in place.

Dtypes follow optax's. AdamW's moments start in their parameter's dtype
(optax's ``mu_dtype=None``); a step whose gradient has a wider dtype
(fp32 sums of several microbatches over bf16 parameters) promotes them,
as JAX's type promotion does, and they stay promoted. Its arithmetic runs
in the moment's dtype, each Python constant rounded to it first (JAX
converts a weakly typed scalar to the array's dtype), and the bias
corrections are cast to it after they are computed in fp32. ADOPT's
moments are fp32 and its update is cast to the parameter's dtype. A
parameter then takes ``p + u`` rounded to its own dtype (optax's
``apply_updates``). The clip divides each gradient by the global norm cast
to the gradient's dtype (optax's ``clip_by_global_norm``). Every pass goes
piece by piece along the leading axis (:func:`pieces`), so no transient is
larger than a piece, whatever a tensor's size.
"""

from __future__ import annotations

import math
import re
from typing import Callable

import numpy as np
import torch

from photon_tpu_torch.config.schema import OptimizerConfig, SchedulerConfig
from photon_tpu_torch.optim.adopt import adopt_update

Schedule = Callable[[int], float]
FREEZE_PREFIX = ".inner_states/train/.inner_state/"


def build_schedule(scfg: SchedulerConfig, base_lr: float) -> Schedule:
    """Cosine with warmup: linear to ``base_lr`` over ``t_warmup`` steps,
    then cosine down to ``alpha_f * base_lr`` at ``t_max``."""
    if scfg.name != "cosine_with_warmup":
        raise ValueError(f"unknown scheduler {scfg.name!r}")
    warmup = max(scfg.t_warmup, 0)
    t_max = max(scfg.t_max, warmup + 1)

    def schedule(count: int) -> float:
        count = float(count)
        if count < warmup:
            return base_lr * count / max(warmup, 1)
        frac = min(max((count - warmup) / (t_max - warmup), 0.0), 1.0)
        return base_lr * (scfg.alpha_f + (1.0 - scfg.alpha_f) * 0.5 * (1.0 + math.cos(math.pi * frac)))

    return schedule


#: elements of one piece of a tensor's elementwise passes
PIECE_ELEMS = 1 << 26


def pieces(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Views of ``t`` along its leading axis, each of at most
    ``PIECE_ELEMS`` elements where the leading axis allows (``t`` itself
    when it is that small)."""
    if t.dim() == 0 or t.numel() <= PIECE_ELEMS:
        return (t,)
    rows = max(1, PIECE_ELEMS // (t.numel() // t.shape[0]))
    return t.split(rows)


def _sq_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ t² in fp32; a narrower tensor is widened one piece at a time."""
    if t.dtype == torch.float32:
        return t.square().sum()
    return torch.stack([x.float().square().sum() for x in pieces(t)]).sum()


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all elements, accumulated in fp32
    (optax's ``global_norm``), on the first tensor's device (the shards of
    a mesh may lie on several)."""
    sums = [_sq_sum(t) for t in tensors]
    return torch.stack([s.to(sums[0].device) for s in sums]).sum().sqrt()


def as_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: what a Python constant becomes in JAX
    beside an array of that dtype."""
    return float(torch.tensor(x, dtype=dtype))


def _count(n: int = 0) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


class Optimizer:
    """``init(params) -> state`` and ``apply(grads, state, params) ->
    state`` over flat ``{name: tensor}`` dicts."""

    def __init__(self, ocfg: OptimizerConfig, schedule: Schedule) -> None:
        if ocfg.name not in ("adopt", "adamw"):
            raise ValueError(f"unknown optimizer {ocfg.name!r}")
        self.cfg = ocfg
        self.schedule = schedule
        self.clip = ocfg.grad_clip_norm if ocfg.grad_clip_norm and ocfg.grad_clip_norm > 0 else 0.0
        self._freeze = [re.compile(p) for p in ocfg.freeze_patterns]
        base = (FREEZE_PREFIX if self._freeze else "") + ("1/" if self.clip else "0/")
        if ocfg.name == "adopt":
            self.counts = [base + ".count"]
            self._m, self._v = base + ".m/", base + ".v/"
        else:
            self.counts = [base + "0/.count", base + "2/.count"]
            self._m, self._v = base + "0/.mu/", base + "0/.nu/"

    def trainable(self, name: str) -> bool:
        return not any(r.search(name) for r in self._freeze)

    def moment_names(self, name: str) -> tuple[str, str]:
        """State names of ``name``'s first and second moments."""
        return self._m + name, self._v + name

    def moment_dtype(self, param_dtype: torch.dtype) -> torch.dtype:
        """The dtype a fresh moment of a ``param_dtype`` parameter has:
        AdamW's the parameter's, ADOPT's fp32."""
        return param_dtype if self.cfg.name == "adamw" else torch.float32

    def init(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        state = {c: _count() for c in self.counts}
        for name, p in params.items():
            if self.trainable(name):
                for key in self.moment_names(name):
                    state[key] = torch.zeros(p.shape, dtype=self.moment_dtype(p.dtype),
                                             device=p.device)
        return dict(sorted(state.items()))

    @torch.no_grad()
    def apply(self, grads: dict[str, torch.Tensor], state: dict[str, torch.Tensor],
              params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One optimizer step: the trainable ``grads`` are clipped in place
        (by their global norm), then each trainable parameter gets its
        update added in place; frozen ones do not move. Returns ``state``,
        its moments updated in place (an AdamW moment narrower than its
        gradient is replaced by a promoted one) and its counters
        advanced."""
        train = {n: g for n, g in grads.items() if self.trainable(n)}
        if self.clip and train:
            norm = global_norm(train.values())
            for g in train.values():
                n = norm.to(g.device)
                for x in pieces(g):
                    torch.where(n < self.clip, x, x / n.to(x.dtype) * self.clip, out=x)
        c = self.cfg
        if c.name == "adamw":
            for n, g in train.items():
                for key in self.moment_names(n):
                    wide = torch.promote_types(state[key].dtype, g.dtype)
                    if state[key].dtype != wide:
                        state[key] = state[key].to(wide)
        # every pass piece by piece: the pieces are views, updated in place
        piece_g, piece_m, piece_v, piece_p = {}, {}, {}, {}
        for n, g in train.items():
            for i, parts in enumerate(zip(*(pieces(t) for t in (
                    g, state[self._m + n], state[self._v + n], params[n])))):
                key = f"{n}#{i}"
                piece_g[key], piece_m[key], piece_v[key], piece_p[key] = parts
        train, m, v, params = piece_g, piece_m, piece_v, piece_p
        if c.name == "adopt":
            count = int(state[self.counts[0]])
            updates = adopt_update(train, m, v, params, count=count, lr=self.schedule(count),
                                   b1=c.betas[0], b2=c.betas[1], eps=c.eps,
                                   weight_decay=c.weight_decay)
        else:
            updates = _adamw_update(train, m, v, params, count=int(state[self.counts[0]]),
                                    lr=self.schedule(int(state[self.counts[1]])), cfg=c)
        for name, u in updates:
            params[name].add_(u)
        for key in self.counts:
            state[key] = _count(int(state[key]) + 1)
        return state


def _adamw_update(grads, mu, nu, params, *, count: int, lr: float, cfg: OptimizerConfig):
    """optax ``adamw``: ``scale_by_adam`` (bias-corrected at ``count + 1``),
    ``add_decayed_weights``, then ``-lr``, in each moment's dtype, every
    constant rounded to it. ``mu``/``nu`` change in place. The bias
    corrections are computed in fp32, as optax does (``1 - b2^t`` at
    ``b2 = 0.9999`` differs from its float64 value by ~1.7e-4 relative),
    then cast to the moment's dtype. Yields ``(name, update)`` one tensor
    at a time, in the moment's dtype (the caller adds it to the parameter
    and rounds to the parameter's dtype)."""
    b1, b2 = cfg.betas
    t = np.float32(count + 1)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    for name, g in grads.items():
        dt, p = mu[name].dtype, params[name]
        g = g.to(dt)
        mu[name].mul_(as_dtype(b1, dt)).add_(g, alpha=as_dtype(1.0 - b1, dt))
        nu[name].mul_(as_dtype(b2, dt)).addcmul_(g, g, value=as_dtype(1.0 - b2, dt))
        u = (mu[name] / as_dtype(bc1, dt)) / ((nu[name] / as_dtype(bc2, dt)).sqrt()
                                              + as_dtype(cfg.eps, dt))
        if cfg.weight_decay:
            u = u + p * as_dtype(cfg.weight_decay, p.dtype)
        yield name, u * as_dtype(-lr, u.dtype)


def build_optimizer(ocfg: OptimizerConfig, scfg: SchedulerConfig) -> tuple[Optimizer, Schedule]:
    """Returns (the optimizer, the lr schedule for logging)."""
    schedule = build_schedule(scfg, ocfg.lr)
    return Optimizer(ocfg, schedule), schedule
