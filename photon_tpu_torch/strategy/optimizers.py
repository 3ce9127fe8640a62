"""Server optimizers on the pseudo-gradient ``g = x - avg``, layer by layer
(the port of ``photon_tpu/strategy/optimizers.py``; the same arithmetic in
the same order, so the results are the same bits):

- FedAvgEff:   x ← x − η·g
- FedNesterov: m ← μm + g;  x ← x − η·(g + μm)
- FedMom:      m ← μm + g;  x ← x − η·m
- FedAdam:     bias-corrected Adam on g
- FedYogi:     Yogi's second moment

FedAdam and FedYogi DESCEND, ``x − η·m̂/(√v̂+τ)``, as the JAX package does
(Reddi et al. 2021 under this sign of g), and bias-correct with their own
step counter ``_t``, checkpointed with the state, not with the round.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from photon_tpu_torch.strategy.base import Strategy


class FedAvgEff(Strategy):
    """Plain server SGD on the pseudo-gradient; η=1, μ=0 is exact FedAvg."""

    name = "fedavg"

    def server_update(self, pseudo_grad, lr):
        assert self.current_parameters is not None
        return [x - lr * g for x, g in zip(self.current_parameters, pseudo_grad)]


class FedNesterov(Strategy):
    """Nesterov-momentum server optimizer (the default strategy)."""

    name = "nesterov"
    state_keys = ("momentum",)

    def server_update(self, pseudo_grad, lr):
        assert self.current_parameters is not None
        m = self.state["momentum"]
        out = []
        for i, (x, g) in enumerate(zip(self.current_parameters, pseudo_grad)):
            m[i] = self.momentum * m[i] + g
            step = g + self.momentum * m[i]
            out.append(x - lr * step)
        return out


class FedMom(Strategy):
    """Heavy-ball momentum server optimizer."""

    name = "fedmom"
    state_keys = ("momentum",)

    def server_update(self, pseudo_grad, lr):
        assert self.current_parameters is not None
        m = self.state["momentum"]
        out = []
        for i, (x, g) in enumerate(zip(self.current_parameters, pseudo_grad)):
            m[i] = self.momentum * m[i] + g
            out.append(x - lr * m[i])
        return out


class _AdaptiveBase(Strategy):
    state_keys = ("momentum_1", "momentum_2")

    def __init__(self, server_learning_rate: float = 1.0, server_beta_1: float = 0.9,
                 server_beta_2: float = 0.99, server_tau: float = 1.0e-9, **kw: Any) -> None:
        super().__init__(server_learning_rate=server_learning_rate, **kw)
        self.beta_1 = server_beta_1
        self.beta_2 = server_beta_2
        self.tau = server_tau
        self._t = 0

    def _second_moment(self, v: np.ndarray, g: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def server_update(self, pseudo_grad, lr):
        assert self.current_parameters is not None
        self._t += 1
        b1t = 1.0 - self.beta_1**self._t
        b2t = 1.0 - self.beta_2**self._t
        m1 = self.state["momentum_1"]
        m2 = self.state["momentum_2"]
        out = []
        for i, (x, g) in enumerate(zip(self.current_parameters, pseudo_grad)):
            m1[i] = self.beta_1 * m1[i] + (1.0 - self.beta_1) * g
            m2[i] = self._second_moment(m2[i], g)
            m_hat = m1[i] / b1t
            v_hat = m2[i] / b2t
            out.append(x - lr * m_hat / (np.sqrt(v_hat) + self.tau))
        return out

    # the step counter survives resume (bias correction continues)
    def state_for_checkpoint(self):
        d = super().state_for_checkpoint()
        d["_t"] = [np.asarray([self._t], np.int64)]
        return d

    def initialize(self, parameters, state=None):
        state = dict(state or {})
        t = state.pop("_t", None)
        super().initialize(parameters, state)
        if t is not None:
            self._t = int(np.asarray(t[0]).ravel()[0])

    def restore_optimizer_state(self, state, t=None):
        # the device plane advances its own step counter: adopting its
        # moments without the matching _t would reset bias correction
        state = dict(state)
        state.pop("_t", None)
        super().restore_optimizer_state(state)
        if t is not None:
            self._t = int(t)


class FedAdam(_AdaptiveBase):
    name = "fedadam"

    def _second_moment(self, v, g):
        return self.beta_2 * v + (1.0 - self.beta_2) * np.square(g)


class FedYogi(_AdaptiveBase):
    name = "fedyogi"

    def _second_moment(self, v, g):
        g2 = np.square(g)
        return v - (1.0 - self.beta_2) * g2 * np.sign(v - g2)
