"""The layout autotuner: pick ``(data, fsdp, tensor, pipe)`` for a client's
devices from an analytic cost model (the port of
``photon_tpu/parallel/autotune.py``).

A client calls one entry point (:func:`autotune_mesh`) in place of
hand-set ``MeshConfig`` knobs: the legal layouts of its device count are
enumerated and ranked by an estimated step time. The model is coarse: its
job is the ranking, not the seconds. Cost terms a step (see
:func:`estimate_layout`):

- **compute**: ``flops_per_token × tokens / (devices × peak × mfu)``,
  inflated by the GPipe bubble ``(pipe − 1) / n_micro``;
- **tensor parallel**: 4 activation all-reduces a layer (attention out and
  MLP down, forward and backward), ring cost ``2(t − 1)/t``;
- **data parallel**: one all-reduce of the device's parameter shard, ring
  cost ``2(d − 1)/d``;
- **fsdp**: the parameters' all-gather (forward and backward) and the
  gradients' reduce-scatter, 3 legs of ``(f − 1)/f``;
- **pipeline**: the stage-boundary activations a microbatch, forward and
  backward;
- **federated exchange** (optional): the client's share of a round's bytes
  (``parallel/collective_agg.py::modeled_cross_slice_bytes``) over the
  cross-host network, spread over ``local_steps``.

Every collective also pays a fixed latency ``coll_latency_s`` (the α of
the α-β model), which keeps small models from splitting their layers.
The arithmetic is JAX's line for line; the port's default
:class:`HardwareModel` is the H100's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from photon_tpu_torch.config.schema import MeshConfig, ModelConfig
from photon_tpu_torch.parallel.collective_agg import modeled_cross_slice_bytes
from photon_tpu_torch.utils.profiling import model_flops_per_token, peak_flops_for_device

#: NVIDIA's published bf16 dense peak of the H100 SXM5 (700 W)
H100_PEAK_FLOPS = 989e12


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """The per-card numbers a layout is priced with. The defaults are
    published specifications of the NVIDIA H100 SXM5 80GB HBM3 at 700 W,
    not measurements, except ``mfu``:

    - ``peak_flops``: 989e12, the bf16 dense peak;
    - ``hbm_bytes``: 80e9;
    - ``ici_bytes_per_s``: 9.0e11, NVLink 4's 900 GB/s with both
      directions summed (JAX's ``ici`` field counts both directions; only
      its ratio to ``dcn`` matters to the ranking);
    - ``dcn_bytes_per_s``: 5.0e10, one 400 Gb/s NIC;
    - ``mfu``: 0.2286, the port's measured MFU of the mpt-125m training
      step on an H100 80GB HBM3 at 700 W (``chip_smoke.py``, PERF.md §5);
    - ``coll_latency_s``: JAX's 1e-5 s a collective.

    Clients on other hardware pass their own."""

    peak_flops: float = H100_PEAK_FLOPS
    hbm_bytes: float = 80.0e9
    ici_bytes_per_s: float = 9.0e11
    dcn_bytes_per_s: float = 5.0e10
    mfu: float = 0.2286
    coll_latency_s: float = 1.0e-5

    @classmethod
    def for_device_kind(cls, kind: str) -> "HardwareModel":
        """The model for a ``torch.cuda.get_device_name()``-style name: its
        bf16 peak where the port knows the card, the H100's otherwise."""
        return cls(peak_flops=peak_flops_for_device(kind) or H100_PEAK_FLOPS)


def model_param_count(cfg: ModelConfig) -> int:
    """The analytic parameter count, in the vocabulary of
    ``model_flops_per_token`` (same MLP, GQA and MoE handling)."""
    d, L, v = cfg.d_model, cfg.n_layers, cfg.vocab_size
    hidden = cfg.mlp_hidden_size or cfg.expansion_ratio * d
    mlp_w = (3 if cfg.mlp == "swiglu" else 2) * d * hidden
    if cfg.mlp == "moe" and cfg.moe_num_experts:
        mlp_w = ((3 if cfg.moe_mlp_act == "swiglu" else 2) * d * hidden
                 * cfg.moe_num_experts + d * cfg.moe_num_experts)
    n_kv = cfg.n_kv_heads or cfg.n_heads
    attn_w = d * (cfg.n_heads + 2 * n_kv) * cfg.d_head + d * d
    n = L * (attn_w + mlp_w) + v * d
    if cfg.learned_pos_emb and not (cfg.rope or cfg.alibi):
        n += cfg.max_seq_len * d
    if not cfg.tie_embeddings:
        n += v * d
    return int(n)


@dataclasses.dataclass
class LayoutEstimate:
    """One ranked layout: the mesh and the cost model's verdict;
    ``breakdown`` holds each collective's seconds (tensor, data, fsdp,
    pipe, federated_dcn)."""

    mesh: MeshConfig
    est_step_s: float
    compute_s: float
    comm_s: float
    bubble_frac: float
    hbm_bytes_per_device: float
    fits: bool
    breakdown: dict = dataclasses.field(default_factory=dict)

    @property
    def axes(self) -> tuple[int, int, int, int]:
        m = self.mesh
        return (m.data, m.fsdp, m.tensor, m.pipe)


def _divisors(n: int) -> list[int]:
    return [k for k in range(1, n + 1) if n % k == 0]


def enumerate_layouts(model_cfg: ModelConfig, n_devices: int, global_batch_size: int,
                      max_pipe: int | None = None) -> list[MeshConfig]:
    """Every legal ``(data, fsdp, tensor, pipe)`` factorization of
    ``n_devices`` (``sequence`` and ``expert`` stay 1: they follow the
    workload, not the layout):

    - ``pipe`` divides ``n_layers``, and a pipelined layout keeps at most
      one batch axis > 1 (``Config.validate``'s rule);
    - ``tensor`` divides ``d_model``, ``n_heads`` and the kv heads;
    - the global batch divides over ``data × fsdp``.

    ``max_pipe`` caps the pipeline axis (a Trainer whose microbatch is
    ``auto`` passes 1)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    n_kv = model_cfg.n_kv_heads or model_cfg.n_heads
    out: list[MeshConfig] = []
    for pipe in _divisors(n_devices):
        if max_pipe is not None and pipe > max_pipe:
            continue
        if model_cfg.n_layers % pipe:
            continue
        rest = n_devices // pipe
        for tensor in _divisors(rest):
            if model_cfg.d_model % tensor or model_cfg.n_heads % tensor or n_kv % tensor:
                continue
            dp_total = rest // tensor
            for data in _divisors(dp_total):
                fsdp = dp_total // data
                if pipe > 1 and data > 1 and fsdp > 1:
                    continue
                if global_batch_size % (data * fsdp):
                    continue
                out.append(MeshConfig(data=data, fsdp=fsdp, tensor=tensor, pipe=pipe))
    return out


def estimate_layout(model_cfg: ModelConfig, mesh_cfg: MeshConfig, global_batch_size: int,
                    microbatch: int = 0, hw: HardwareModel | None = None,
                    optimizer_state_tensors: int = 2, n_clients: int = 0,
                    local_steps: int = 1, quantization: str = "off") -> LayoutEstimate:
    """Price one layout. ``microbatch=0`` takes the per-device batch in one
    microbatch; ``n_clients > 0`` adds the federated exchange over
    ``local_steps``. Per-device memory: fp32 parameters, gradients and
    ``optimizer_state_tensors`` moments over ``fsdp × tensor × pipe``, and
    one microbatch's activations (12 bf16 ``[micro × seq, d]`` tensors a
    local layer, without remat); ``fits`` keeps 10 % headroom."""
    hw = hw or HardwareModel()
    d, f, t, p = mesh_cfg.data, mesh_cfg.fsdp, mesh_cfg.tensor, mesh_cfg.pipe
    n_devices = d * f * t * p
    dp = d * f
    seq = model_cfg.max_seq_len
    tokens = global_batch_size * seq
    n_params = model_param_count(model_cfg)
    param_bytes = 4.0 * n_params

    per_dev_batch = max(global_batch_size // dp, 1)
    micro = min(microbatch, per_dev_batch) if microbatch else per_dev_batch
    n_micro = max(per_dev_batch // micro, 1)

    compute_s = (model_flops_per_token(model_cfg) * tokens
                 / (n_devices * hw.peak_flops * hw.mfu))
    bubble_frac = (p - 1) / n_micro if p > 1 else 0.0
    compute_s *= 1.0 + bubble_frac

    act_bytes = 2.0  # bf16 activations on the wire
    L_local = model_cfg.n_layers / p
    tok_local = tokens / dp
    alpha = hw.coll_latency_s
    comm = {
        "tensor_s": (4.0 * L_local * (alpha + tok_local * model_cfg.d_model
                     * act_bytes * 2.0 * (t - 1) / t / hw.ici_bytes_per_s))
                    if t > 1 else 0.0,
        "data_s": (alpha + 2.0 * (d - 1) / d * param_bytes / (f * t * p)
                   / hw.ici_bytes_per_s) if d > 1 else 0.0,
        "fsdp_s": (3.0 * alpha + 3.0 * (f - 1) / f * param_bytes / (t * p)
                   / hw.ici_bytes_per_s) if f > 1 else 0.0,
        "pipe_s": (2.0 * (p - 1) * n_micro * (alpha + micro * seq
                   * model_cfg.d_model * act_bytes / hw.ici_bytes_per_s))
                  if p > 1 else 0.0,
    }
    if n_clients > 0:
        exchange = modeled_cross_slice_bytes(
            [n_params], n_clients, quantization=quantization,
        ) / max(n_clients, 1)  # this client's share of the exchange
        comm["federated_dcn_s"] = ((alpha + exchange / hw.dcn_bytes_per_s)
                                   / max(local_steps, 1))
    comm_s = float(sum(comm.values()))

    state_bytes = param_bytes * (2 + optimizer_state_tensors) / (f * t * p)
    act_hbm = 12.0 * L_local * micro * seq * model_cfg.d_model * act_bytes / t
    hbm = state_bytes + act_hbm
    return LayoutEstimate(mesh=mesh_cfg, est_step_s=compute_s + comm_s, compute_s=compute_s,
                          comm_s=comm_s, bubble_frac=bubble_frac, hbm_bytes_per_device=hbm,
                          fits=hbm <= 0.9 * hw.hbm_bytes, breakdown=comm)


def rank_layouts(model_cfg: ModelConfig, n_devices: int, global_batch_size: int = 256,
                 max_pipe: int | None = None, **kw) -> list[LayoutEstimate]:
    """Every legal layout, best first: those that fit before those that do
    not, then by estimated step seconds. Raises when nothing is legal."""
    layouts = enumerate_layouts(model_cfg, n_devices, global_batch_size, max_pipe=max_pipe)
    if not layouts:
        raise ValueError(
            f"no legal (data, fsdp, tensor, pipe) layout for {n_devices} "
            f"devices / batch {global_batch_size} / model {model_cfg.name!r}"
        )
    ests = [estimate_layout(model_cfg, m, global_batch_size, **kw) for m in layouts]
    ests.sort(key=lambda e: (not e.fits, e.est_step_s))
    return ests


def autotune_layout(model_cfg: ModelConfig, n_devices: int | None = None,
                    devices: Sequence | None = None, global_batch_size: int = 256,
                    hw: HardwareModel | None = None, **kw) -> LayoutEstimate:
    """The best layout for a client's devices: ``devices`` (``torch.device``
    entries; a CUDA card's name seeds the hardware model) or an explicit
    ``n_devices``."""
    if devices is not None:
        n_devices = len(devices)
        if hw is None:
            dev = torch.device(devices[0])
            hw = HardwareModel.for_device_kind(
                torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type)
    if n_devices is None:
        raise ValueError("pass devices=... or n_devices=...")
    return rank_layouts(model_cfg, n_devices, global_batch_size, hw=hw, **kw)[0]


def autotune_mesh(model_cfg: ModelConfig, n_devices: int | None = None,
                  devices: Sequence | None = None, global_batch_size: int = 256,
                  **kw) -> MeshConfig:
    """:func:`autotune_layout`'s ``MeshConfig`` alone."""
    return autotune_layout(model_cfg, n_devices=n_devices, devices=devices,
                           global_batch_size=global_batch_size, **kw).mesh
