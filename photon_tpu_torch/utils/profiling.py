"""Metric names, bytes-on-wire accounting, throughput and MFU.

The port of the parts of ``photon_tpu/utils/profiling.py`` that training
and the federated round read: the ``server/*`` and ``client/*`` metric
names (the same strings, so a History reads the same in both packages),
:class:`WireStats`, :func:`is_oom`, the FLOP count per token and
:class:`SpeedMonitor`.
:func:`model_flops_per_token` keeps the JAX formula unchanged, so an MFU
means the same in both packages; note that its attention term
``12 L d s`` counts the full (non-causal) score and value products. The
peak comes from the CUDA device's name (H100: 989e12 bf16 dense, NVIDIA's
data sheet); for any other device, the CPU included, no MFU is reported.
"""

from __future__ import annotations

import dataclasses

from photon_tpu_torch.config.schema import ModelConfig

# -- server round loop (federation/server.py) ------------------------------
ROUND_TIME = "server/round_time"
FIT_ROUND_TIME = "server/fit_round_time"
BROADCAST_PRE_TIME = "server/broadcast_pre_time"
BROADCAST_POST_TIME = "server/broadcast_post_time"
CHECKPOINT_TIME = "server/checkpoint_time"
CKPT_BARRIER_WAIT_S = "server/ckpt_barrier_wait_s"
#: duration of the most recently completed background checkpoint write
CKPT_ASYNC_WRITE_S = "server/ckpt_async_write_s"
STEPS_CUMULATIVE = "server/steps_cumulative"
#: the federated eval of a round, over every client (this package only)
EVAL_ROUND_TIME = "server/eval_round_time"
ROUND_FAILED = "server/round_failed"
EVAL_ROUND_FAILED = "server/eval_round_failed"

# -- aggregation and strategy (strategy/) ----------------------------------
N_CLIENTS = "server/n_clients"
N_SAMPLES = "server/n_samples"
EFFECTIVE_LR = "server/effective_lr"
EVAL_LOSS = "server/eval_loss"
PSEUDO_GRAD_NORM = "server/pseudo_grad_norm"
PARAM_NORM = "server/param_norm"
GNS_TRACE_EST = "server/gns_trace_est"
GNS_SQNORM_EST = "server/gns_sqnorm_est"
GRADIENT_NOISE_SCALE = "server/gradient_noise_scale"
#: fetch seconds of the streaming aggregation (the wait for a client's
#: reply excluded)
AGG_DECODE_TIME = "server/agg_decode_time"
#: fold seconds of the streaming aggregation
AGG_FOLD_TIME = "server/agg_fold_time"
#: the server optimizer on the averaged params, its norms included (this
#: package only)
SERVER_UPDATE_TIME = "server/server_update_time"

# -- node membership (federation/membership.py) ----------------------------
NODES_LIVE = "server/nodes_live"
NODES_SUSPECT = "server/nodes_suspect"
NODES_DEAD = "server/nodes_dead"
NODES_READMITTED = "server/nodes_readmitted"
RECONNECT_BACKOFF_S = "server/reconnect_backoff_s"

# -- client (federation/client_runtime.py, train/trainer.py) ---------------
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
#: the trained params' copy to the host, and their hand-off to the
#: transport (this package only)
CLIENT_GET_PARAMETERS_TIME = "client/get_parameters_time"
CLIENT_PUT_TIME = "client/put_time"


@dataclasses.dataclass
class WireStats:
    """Bytes-on-wire accounting for the parameter plane: ``raw`` is what a
    payload costs uncompressed, ``wire`` what moved (equal here: the port
    has no wire codec); ``sent`` counts :meth:`ParamTransport.put`,
    ``recv`` counts :meth:`ParamTransport.get`, so on the server's
    transport ``recv`` is the uplink."""

    sent_raw_bytes: int = 0
    sent_wire_bytes: int = 0
    recv_raw_bytes: int = 0
    recv_wire_bytes: int = 0
    n_sent: int = 0
    n_recv: int = 0

    def record_sent(self, raw: int, wire: int) -> None:
        self.sent_raw_bytes += int(raw)
        self.sent_wire_bytes += int(wire)
        self.n_sent += 1

    def record_recv(self, raw: int, wire: int) -> None:
        self.recv_raw_bytes += int(raw)
        self.recv_wire_bytes += int(wire)
        self.n_recv += 1

    def snapshot(self) -> "WireStats":
        return dataclasses.replace(self)

    def metrics_since(self, prev: "WireStats", prefix: str = "server/") -> dict[str, float]:
        """Round-delta metrics: uplink raw/wire bytes and their ratio,
        downlink (broadcast) wire bytes."""
        up_raw = self.recv_raw_bytes - prev.recv_raw_bytes
        up_wire = self.recv_wire_bytes - prev.recv_wire_bytes
        down_wire = self.sent_wire_bytes - prev.sent_wire_bytes
        out = {
            f"{prefix}wire_uplink_raw_bytes": float(up_raw),
            f"{prefix}wire_uplink_bytes": float(up_wire),
            f"{prefix}wire_broadcast_bytes": float(down_wire),
        }
        if up_wire > 0:
            out[f"{prefix}wire_compression_ratio"] = up_raw / up_wire
        return out


def is_oom(e: BaseException) -> bool:
    """Device-memory exhaustion: ``torch.cuda.OutOfMemoryError``, or an
    error whose message says so."""
    import torch

    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e)
    return "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()

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
