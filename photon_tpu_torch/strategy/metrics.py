"""Gradient-noise-scale estimator (the port of ``photon_tpu/strategy/metrics.py``).

Implements the two-batch-size estimator of "An Empirical Model of Large-Batch
Training" adapted to federation: the per-client pseudo-gradients act as the
small-batch gradient estimate (batch ``b_small`` = one client's samples) and
the aggregate pseudo-gradient as the large-batch one (``b_big`` = round total).

    S   = (|G_small|² − |G_big|²) / (1/b_small − 1/b_big)
    |G|² = (b_big·|G_big|² − b_small·|G_small|²) / (b_big − b_small)
    B_noise = EMA(S) / EMA(|G|²)        (EMAs bias-corrected)
"""

from __future__ import annotations

import numpy as np

from photon_tpu_torch.utils.profiling import (
    GNS_SQNORM_EST,
    GNS_TRACE_EST,
    GRADIENT_NOISE_SCALE,
)


class GradientNoiseScale:
    def __init__(self, ema_alpha: float = 0.95) -> None:
        self.alpha = ema_alpha
        self._ema_s = 0.0
        self._ema_g2 = 0.0
        self._t = 0

    def update(
        self,
        per_client_sq_norms: list[float],
        per_client_samples: list[int],
        aggregate_sq_norm: float,
        total_samples: int,
    ) -> dict[str, float]:
        if len(per_client_sq_norms) < 2:
            return {}
        b_small = float(np.mean(per_client_samples))
        b_big = float(total_samples)
        if b_big <= b_small:
            return {}
        g_small_sq = float(np.mean(per_client_sq_norms))
        g_big_sq = aggregate_sq_norm

        s = (g_small_sq - g_big_sq) / (1.0 / b_small - 1.0 / b_big)
        g2 = (b_big * g_big_sq - b_small * g_small_sq) / (b_big - b_small)

        self._t += 1
        self._ema_s = self.alpha * self._ema_s + (1.0 - self.alpha) * s
        self._ema_g2 = self.alpha * self._ema_g2 + (1.0 - self.alpha) * g2
        bias = 1.0 - self.alpha**self._t
        s_hat = self._ema_s / bias
        g2_hat = self._ema_g2 / bias
        out = {
            GNS_TRACE_EST: s_hat,
            GNS_SQNORM_EST: g2_hat,
        }
        if g2_hat > 0:
            out[GRADIENT_NOISE_SCALE] = s_hat / g2_hat
        return out

    # --- persistence across checkpoints ---
    def state_dict(self) -> dict[str, float]:
        return {"ema_s": self._ema_s, "ema_g2": self._ema_g2, "t": self._t}

    def load_state_dict(self, d: dict[str, float]) -> None:
        self._ema_s = float(d["ema_s"])
        self._ema_g2 = float(d["ema_g2"])
        self._t = int(d["t"])
