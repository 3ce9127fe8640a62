"""Throughput and MFU: the client metric names, the FLOP count per token,
and :class:`SpeedMonitor`.

The port of the parts of ``photon_tpu/utils/profiling.py`` training reads.
:func:`model_flops_per_token` keeps the JAX formula unchanged, so an MFU
means the same in both packages; note that its attention term
``12 L d s`` counts the full (non-causal) score and value products. The
peak comes from the CUDA device's name (H100: 989e12 bf16 dense, NVIDIA's
data sheet); for any other device, the CPU included, no MFU is reported.
"""

from __future__ import annotations

from photon_tpu_torch.config.schema import ModelConfig

CLIENT_FIT_TIME = "client/fit_time"
CLIENT_FIT_INIT_TIME = "client/fit_init_time"
CLIENT_FIT_SET_PARAMETERS_TIME = "client/fit_set_parameters_time"
CLIENT_STEPS = "client/steps"
CLIENT_TOKENS_PER_SEC = "client/tokens_per_sec"
CLIENT_FINAL_LOSS = "client/final_loss"
CLIENT_LR = "client/lr"
CLIENT_PSEUDO_GRAD_NORM = "client/pseudo_grad_norm"
CLIENT_PARAM_NORM = "client/param_norm"
CLIENT_SKIPPED_ROUND = "client/skipped_round"

#: bf16 dense peak by device-name substring (first match wins)
PEAK_FLOPS_BY_DEVICE_NAME: list[tuple[str, float]] = [("h100", 989e12)]


def peak_flops_for_device(name: str) -> float | None:
    name = name.lower()
    return next((p for sub, p in PEAK_FLOPS_BY_DEVICE_NAME if sub in name), None)


def model_flops_per_token(cfg: ModelConfig) -> float:
    """Training FLOPs/token ≈ 6·N_nonemb + 12·L·d·s (attention) + 6·d·V
    (the head), the JAX package's formula."""
    d, L, s, v = cfg.d_model, cfg.n_layers, cfg.max_seq_len, cfg.vocab_size
    hidden = cfg.mlp_hidden_size or cfg.expansion_ratio * d
    mlp_w = (3 if cfg.mlp == "swiglu" else 2) * d * hidden
    n_kv = cfg.n_kv_heads or cfg.n_heads
    attn_w = d * (cfg.n_heads + 2 * n_kv) * cfg.d_head + d * d
    n_block = L * (attn_w + mlp_w)
    return 6.0 * n_block + 12 * L * d * s + 6 * d * v


class SpeedMonitor:
    """EMA tokens/s and, on a device with a known peak, MFU."""

    def __init__(self, cfg: ModelConfig, device_name: str, n_devices: int = 1,
                 alpha: float = 0.9) -> None:
        self.flops_per_token = model_flops_per_token(cfg)
        self.device_name = device_name
        self.peak_flops_per_device = peak_flops_for_device(device_name)
        self.n_devices = n_devices
        self.alpha = alpha
        self._ema = 0.0
        self._t = 0

    def update(self, tokens: int, seconds: float) -> dict[str, float]:
        if seconds <= 0:
            return {}
        tps = tokens / seconds
        self._t += 1
        self._ema = self.alpha * self._ema + (1 - self.alpha) * tps
        out = {"throughput/tokens_per_sec": tps,
               "throughput/tokens_per_sec_ema": self._ema / (1 - self.alpha ** self._t)}
        if self.peak_flops_per_device:
            peak = self.peak_flops_per_device * self.n_devices
            out["throughput/mfu"] = tps * self.flops_per_token / peak
        return out
