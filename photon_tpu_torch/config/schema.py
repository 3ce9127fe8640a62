"""The port's own copy of the config schema (``photon_tpu/config/schema.py``).

``ModelConfig``, ``ServeConfig``, ``OptimizerConfig``, ``SchedulerConfig``,
``MeshConfig``, ``TrainConfig``, ``DatasetConfig``, ``FLConfig``,
``CommStackConfig``, ``CompressionConfig``, ``MembershipConfig``,
``AdaptersConfig`` and ``PhotonConfig`` carry the same fields, names and
defaults as the JAX package's, so a resolved YAML written by either
package loads in the other with equal fields. The sections of features
the port does not run (``photon.chaos``, ``telemetry`` and
``async_rounds``) are kept as the raw dicts they were read as and
written back unchanged; only their ``enabled`` flag is read, to refuse
them. ``photon.adapters`` (per-cohort LoRA) and ``model.lora_*`` are
validated with the JAX package's ``ValueError`` texts.
``serve.speculative`` is a :class:`SpeculativeConfig` and ``serve.fleet``
a :class:`FleetConfig`, validated with the JAX package's ``ValueError``
texts, as are the prefix-cache and hot-swap fields of
:class:`ServeConfig`.

:meth:`Config.validate` raises ``NotImplementedError`` for the features
this package does not port yet, so such a config fails at start-up
instead of running without them: a ``model.param_dtype`` other than
``float32`` everywhere (the port keeps fp32 parameters); and for
training (``validate(serving=False)``, the default) a mesh of more than
one device (``mesh.expert > 1`` included), ring attention, the mesh
autotuner, the collective aggregation plane, chaos, telemetry and
asynchronous rounds (and with them the adapters' collective
round loop). ``mlp: moe`` is checked as the JAX
package checks it (its ``ValueError`` texts); ``device_microbatch_size:
auto`` runs the trainer's probe.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import typing
import warnings
from dataclasses import dataclass, field
from typing import Any

import yaml


@dataclass
class ModelConfig:
    """Decoder-only MPT-style model shape (same fields as the JAX package)."""

    name: str = "mpt-125m"
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_seq_len: int = 2048
    vocab_size: int = 50368
    expansion_ratio: int = 4
    no_bias: bool = True
    learned_pos_emb: bool = True
    alibi: bool = False
    tie_embeddings: bool = True
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ()
    rope: bool = False
    rope_theta: float = 10000.0
    n_kv_heads: int = 0  # 0 -> n_heads (MHA)
    norm: str = "layernorm"  # layernorm | rmsnorm (both fp32)
    norm_eps: float = 1.0e-5
    mlp: str = "gelu"  # gelu | swiglu | moe
    mlp_hidden_size: int = 0  # 0 -> expansion_ratio * d_model
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_mlp_act: str = "gelu"
    attn_impl: str = "pallas"  # training attention; serving ignores it
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    logits_dtype: str = "float32"
    emb_init_std: float = 0.02
    resid_pdrop: float = 0.0
    remat: bool = False
    flash_block_q: int = 256
    flash_block_k: int = 256
    attn_interpret: bool = False

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hidden(self) -> int:
        return self.mlp_hidden_size or self.expansion_ratio * self.d_model


@dataclass
class SpeculativeConfig:
    """Self-drafted speculative decoding (same fields as the JAX package;
    ``serve/draft.py``). Off by default. On, the scheduler drafts up to
    ``k`` tokens per decoding slot per step from an n-gram / prompt-lookup
    drafter over the slot's own prompt and output, verifies every row's
    drafts in one mixed step and emits the longest accepted prefix plus
    one model token. Greedy output equals the plain engine's; temperature
    rows use rejection sampling. An accept-rate EWMA throttles ``k`` and
    falls back to plain decode below ``accept_floor``; while throttled off,
    one drafted probe runs every ``probe_ticks`` steps (0 = never)."""

    enabled: bool = False
    k: int = 4  # max draft tokens per decoding row per step
    draft_budget: int = 64  # per-step draft tokens over all rows
    max_ngram: int = 3  # the drafter's n-gram orders, longest first
    min_ngram: int = 1
    accept_floor: float = 0.30
    ewma_alpha: float = 0.2
    probe_ticks: int = 64


@dataclass
class FleetConfig:
    """N serving replicas behind one router (same fields and defaults as
    the JAX package; ``serve/router.py`` and ``serve/fleet.py``). Off by
    default. Each replica is a ``python -m photon_tpu_torch.serve
    --fleet-connect HOST:PORT`` daemon that dials the router's control
    port; the router places each ``/generate`` by cohort pin, then by the
    prompt's first ``prefix_affinity_blocks`` chain-hashed blocks (0 =
    prefix affinity off), then by power-of-two choices on the replicas'
    queue depths. One poll every ``report_poll_s`` asks each replica for
    its load report, which doubles as the liveness ping
    (``report_timeout_s`` bounds the replies); a proxy that fails before
    any response byte is tried on up to ``route_retries`` other
    replicas."""

    enabled: bool = False
    replicas: int = 2
    host: str = "127.0.0.1"
    port: int = 0  # the router's HTTP port; 0 = ephemeral
    control_port: int = 0  # the router's TCP control port; 0 = ephemeral
    prefix_affinity_blocks: int = 4
    cohort_affinity: bool = True
    report_poll_s: float = 0.5
    report_timeout_s: float = 2.0
    route_retries: int = 2


@dataclass
class ServeConfig:
    """Continuous-batching serving plane (same fields as the JAX package).

    ``attention_impl``: ``"auto"`` and ``"ragged"`` walk each slot's live
    blocks through the hand-written CUDA kernel on the card (its plain
    PyTorch version on the CPU); ``"gather"`` is the full-width dense
    gather, the oracle. ``prefix_cache`` shares full prompt-prefix blocks
    across requests (``serve/prefix.py``; ``prefix_cache_blocks`` caps the
    index, 0 = the pool's pressure alone); ``hotswap`` starts a watcher
    that swaps new rounds in (``serve/hotswap.py``); ``fleet`` sets up a
    fleet of replicas behind a router (``serve/router.py``).
    """

    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 0
    n_slots: int = 4
    block_size: int = 16
    n_blocks: int = 0  # 0 = auto: n_slots * ceil(max_seq_len / block_size)
    max_queue: int = 64
    max_new_tokens: int = 64
    prefill_token_budget: int = 2048
    attention_impl: str = "auto"
    attention_interpret: bool = False  # a Pallas option; unused here
    eos_id: int = -1
    drain_timeout_s: float = 30.0
    prefix_cache: bool = False
    prefix_cache_blocks: int = 0
    hotswap: bool = False
    hotswap_poll_s: float = 5.0
    hotswap_statusz_url: str = ""
    speculative: SpeculativeConfig = field(default_factory=SpeculativeConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)


@dataclass
class OptimizerConfig:
    """Client-side optimizer (same fields as the JAX package)."""

    name: str = "adopt"  # adopt | adamw
    lr: float = 6.0e-4
    betas: tuple[float, float] = (0.9, 0.9999)
    eps: float = 1.0e-6
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0
    freeze_patterns: list = field(default_factory=list)  # param-name regexes


@dataclass
class SchedulerConfig:
    """Cosine-with-warmup learning-rate schedule."""

    name: str = "cosine_with_warmup"
    t_warmup: int = 100  # batches
    t_max: int = 4800  # batches; total schedule horizon
    alpha_f: float = 0.1  # final LR multiplier


@dataclass
class MeshConfig:
    """The JAX package's device mesh; the port trains on one device, so
    every axis must be 1."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    pipe: int = 1
    expert: int = 1
    surplus_devices: str = "warn"

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.tensor * self.sequence * self.pipe * self.expert


@dataclass
class TrainConfig:
    """Per-client training loop (same fields as the JAX package)."""

    global_batch_size: int = 256
    device_microbatch_size: int | str = 8  # or "auto": the trainer probes for it
    auto_microbatch_cap: int = 0
    loss_chunk_tokens: int = 2048  # 0 = materialize the full logits
    seed: int = 17
    eval_interval: int = 0  # mid-training eval every N steps (0 = off)
    eval_batches: int = 8
    log_interval: int = 10


@dataclass
class DatasetConfig:
    """Sharded (PTS) dataset (same fields as the JAX package)."""

    local_path: str = ""
    split_train: str = "train"
    split_eval: str = "val"
    shuffle: bool = True
    shuffle_seed: int = 17
    n_streams: int = 0
    synthetic: bool = False


#: server strategies (``photon_tpu.config.schema.StrategyName``)
STRATEGY_NAMES = ("fedavg", "nesterov", "fedmom", "fedadam", "fedyogi")
#: wire-codec policies (``photon_tpu_torch/compression``)
COMPRESSION_POLICIES = ("off", "delta", "delta_q8", "delta_topk_q8")


@dataclass
class CommStackConfig:
    """Bulk-tensor transport (same fields as the JAX package): ``shm``
    (named segments on one host) or ``objstore`` (the object store);
    ``collective`` and its ``collective_*`` knobs belong to the device
    aggregation plane, which is not ported."""

    shm: bool = True
    objstore: bool = False
    collective: bool = False
    collective_replica: int = 1
    collective_quantization: str = "off"
    collective_q8_block: int = 0
    collective_device_optimizer: bool = False
    collective_zero1: bool = True
    collective_stage_timeout_s: float = 0.0
    collective_quorum: float = 0.5
    collective_retry_budget: int = 1


@dataclass
class CompressionConfig:
    """The uplink wire codec (same fields as the JAX package;
    ``photon_tpu_torch/compression``)."""

    policy: str = "off"
    topk_ratio: float = 0.125
    q8_block_size: int = 256
    error_feedback: bool = True
    ef_max_clients: int = 16


@dataclass
class MembershipConfig:
    """Node liveness between rounds and the TCP node's redial backoff
    (same fields as the JAX package); ``enabled`` gates the ping sweep
    only."""

    enabled: bool = True
    ping_interval_rounds: int = 1
    ping_timeout_s: float = 5.0
    suspect_after_misses: int = 1
    dead_after_misses: int = 2
    reconnect_backoff_base_s: float = 0.5
    reconnect_backoff_max_s: float = 30.0
    reconnect_backoff_jitter: float = 0.25
    reconnect_max_attempts: int = 60


@dataclass
class FLConfig:
    """Federation hyperparameters (same fields as the JAX package)."""

    n_total_clients: int = 8
    n_clients_per_round: int = 8
    n_rounds: int = 320
    local_steps: int = 128
    strategy_name: str = "nesterov"
    server_learning_rate: float = 1.0
    server_momentum: float = 0.0
    server_beta_1: float = 0.9
    server_beta_2: float = 0.99
    server_tau: float = 1.0e-9
    client_count_scaling: str = "none"  # none | linear | sqrt
    aggregate_momenta: bool = False
    accept_failures_cnt: int = 0
    ignore_failed_rounds: bool = False
    eval_interval_rounds: int = 0
    sample_seed: int = 1234
    fit_timeout_s: float = 3600.0
    eval_timeout_s: float = 3600.0
    fit_config: dict = field(default_factory=dict)  # FitRoundConfig knobs
    eval_config: dict = field(default_factory=dict)  # EvaluateRoundConfig knobs


#: dense-projection module names LoRA can target (MoE expert weights are
#: absent: batch-global capacity routing breaks per-slot adapter purity)
LORA_TARGETABLE = (
    "wqkv", "q_proj", "k_proj", "v_proj", "out_proj",
    "up_proj", "down_proj", "gate_proj",
)


@dataclass
class AdaptersConfig:
    """Per-cohort LoRA adapters over a frozen federated base (same fields
    as the JAX package; ``photon_tpu_torch/adapters``). Off by default.
    On a training config the fit freezes the base and trains rank-``rank``
    A/B factors, folded per cohort; on a serving config the engine keeps
    ``pool_size`` cohorts' factors resident on the device beside the KV
    pool, and ``cohort`` rides ``/generate``. ``cohorts`` maps cohort name
    → client ids (the serving side reads the names only); a client in no
    cohort trains and serves the bare base."""

    enabled: bool = False
    rank: int = 8  # LoRA rank r (> 0 when enabled)
    alpha: float = 16.0  # delta scale = alpha / rank
    targets: list = field(default_factory=lambda: [
        "wqkv", "q_proj", "k_proj", "v_proj", "out_proj",
    ])
    cohorts: dict = field(default_factory=dict)  # name -> [cid, ...]
    pool_size: int = 4  # resident adapter pages on the serving device


@dataclass
class PhotonConfig:
    """Node/process topology (same fields as the JAX package)."""

    n_nodes: int = 1
    refresh_period: int = 0  # rebuild node runtimes every N rounds; 0 = never
    host_threads: int = 0  # host-plane pool: 0 = auto, 1 = serial
    mesh_autotune: bool = False
    checkpoint: bool = True
    checkpoint_interval: int = 1
    async_checkpoint: bool = True
    keep_checkpoints: int = 3
    resume_round: int | None = None  # negative = index from the latest valid round
    restore_run_uuid: str | None = None
    init_from_run: str | None = None
    comm_stack: CommStackConfig = field(default_factory=CommStackConfig)
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    membership: MembershipConfig = field(default_factory=MembershipConfig)
    chaos: dict = field(default_factory=dict)  # raw: refused when enabled
    async_rounds: dict = field(default_factory=dict)  # raw: refused when enabled
    telemetry: dict = field(default_factory=dict)  # raw: refused when enabled
    serve: ServeConfig = field(default_factory=ServeConfig)
    adapters: AdaptersConfig = field(default_factory=AdaptersConfig)
    save_path: str = "/tmp/photon_tpu"


@dataclass
class Config:
    run_uuid: str = "dev"
    seed: int = 17
    wandb_project: str | None = None
    photon: PhotonConfig = field(default_factory=PhotonConfig)
    fl: FLConfig = field(default_factory=FLConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)

    # -- (de)serialization ----------------------------------------------
    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        """Build from a resolved config dict (either package writes one);
        an unknown key raises."""
        return _build(cls, d or {})

    @classmethod
    def from_yaml(cls, path: str | pathlib.Path) -> "Config":
        return cls.from_dict(yaml.safe_load(pathlib.Path(path).read_text()) or {})

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def to_dict(self) -> dict[str, Any]:
        """The same nesting as the JAX package's resolved config, so either
        package can read the file back."""
        return _plain(dataclasses.asdict(self))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def to_yaml(self, path: str | pathlib.Path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(yaml.safe_dump(self.to_dict(), sort_keys=False))

    # -- validation -------------------------------------------------------
    def validate(self, device: Any = None, *, serving: bool = False) -> "Config":
        """Check the fields; ``device`` (when given) is what the ragged walk
        (``attention_impl`` auto or ragged) is checked against. With
        ``serving=True`` the training sections are not checked: a server
        loads weights whichever mesh trained them."""
        m = self.model
        if m.alibi and m.learned_pos_emb:
            raise ValueError("alibi and learned_pos_emb are mutually exclusive")
        if m.rope and (m.alibi or m.learned_pos_emb):
            raise ValueError("rope excludes alibi and learned_pos_emb")
        if m.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"bad model.norm {m.norm}")
        if m.mlp not in ("gelu", "swiglu", "moe"):
            raise ValueError(f"bad model.mlp {m.mlp}")
        if m.mlp == "moe":
            if m.moe_num_experts < 2:
                raise ValueError("mlp='moe' needs moe_num_experts >= 2")
            if m.moe_capacity_factor <= 0:
                # expert_capacity() would clamp every expert to capacity 1
                raise ValueError(
                    f"moe_capacity_factor must be > 0, got {m.moe_capacity_factor}"
                )
            if m.moe_mlp_act not in ("gelu", "swiglu"):
                raise ValueError(f"bad moe_mlp_act {m.moe_mlp_act}")
            if not 1 <= m.moe_top_k <= m.moe_num_experts:
                raise ValueError("moe_top_k must be in [1, moe_num_experts]")
        if m.n_kv_heads < 0 or m.mlp_hidden_size < 0:
            raise ValueError("n_kv_heads and mlp_hidden_size must be >= 0")
        if m.n_kv_heads and m.n_heads % m.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if m.rope and m.d_head % 2:
            raise ValueError("rope needs an even d_head")
        _validate_lora(m)
        if m.param_dtype != "float32":
            # JAX builds every parameter in param_dtype; the port keeps fp32
            # masters, so its parameter list would part from JAX's
            raise NotImplementedError(
                f"model.param_dtype={m.param_dtype!r} is not ported to photon_tpu_torch "
                "yet; set float32 or run with photon_tpu"
            )
        if m.attn_impl not in ("pallas", "xla", "ring"):
            raise ValueError(f"bad model.attn_impl {m.attn_impl!r}")
        if not serving:
            self._validate_training()
        srv = self.photon.serve
        if srv.n_slots < 1 or srv.block_size < 1:
            raise ValueError(
                f"serve needs n_slots >= 1 and block_size >= 1, got "
                f"{srv.n_slots}/{srv.block_size}"
            )
        if srv.n_blocks < 0:
            raise ValueError(f"serve.n_blocks must be >= 0 (0 = auto), got {srv.n_blocks}")
        if srv.max_queue < 1 or srv.max_new_tokens < 1:
            raise ValueError(
                f"serve needs max_queue >= 1 and max_new_tokens >= 1, got "
                f"{srv.max_queue}/{srv.max_new_tokens}"
            )
        if srv.prefill_token_budget < 1:
            raise ValueError(
                f"serve.prefill_token_budget must be >= 1, got "
                f"{srv.prefill_token_budget}"
            )
        if srv.attention_impl not in ("auto", "ragged", "gather"):
            raise ValueError(
                f"serve.attention_impl must be one of auto/ragged/gather, "
                f"got {srv.attention_impl!r}"
            )
        if srv.attention_impl != "gather" and device is not None:
            _check_ragged_device(device)
        if srv.drain_timeout_s <= 0:
            raise ValueError(f"serve.drain_timeout_s must be > 0, got {srv.drain_timeout_s}")
        if not 0 <= srv.port <= 65535:
            raise ValueError(f"serve.port must be in [0, 65535], got {srv.port}")
        if srv.prefix_cache_blocks < 0:
            raise ValueError(
                f"serve.prefix_cache_blocks must be >= 0 (0 = no cap), got "
                f"{srv.prefix_cache_blocks}"
            )
        if srv.hotswap_poll_s <= 0:
            raise ValueError(f"serve.hotswap_poll_s must be > 0, got {srv.hotswap_poll_s}")
        _validate_speculative(srv.speculative)
        _validate_adapters(self)
        _validate_fleet(srv.fleet)
        return self


    def _validate_training(self) -> None:
        m, tr, ph = self.model, self.train, self.photon
        if m.resid_pdrop != 0.0:
            raise ValueError("resid_pdrop > 0 is not implemented (dropout-free pretraining)")
        if m.attn_impl == "ring":
            raise NotImplementedError("attn_impl 'ring' needs a multi-device mesh; not ported yet")
        if self.mesh.size != 1:
            raise NotImplementedError(
                f"a mesh of {self.mesh.size} devices: photon_tpu_torch trains on one device"
            )
        if ph.mesh_autotune:
            raise NotImplementedError("photon.mesh_autotune is not ported yet")
        micro = tr.device_microbatch_size
        if isinstance(micro, str) and micro != "auto":
            raise ValueError(f"device_microbatch_size must be an int or 'auto', got {micro!r}")
        if tr.global_batch_size < 1 or (micro != "auto" and micro < 1):
            raise ValueError("global_batch_size and device_microbatch_size must be >= 1")
        if micro != "auto" and tr.global_batch_size % micro:
            raise ValueError("global_batch_size must be divisible by device_microbatch_size")
        if tr.loss_chunk_tokens < 0:
            raise ValueError("train.loss_chunk_tokens must be >= 0")
        if self.optimizer.name not in ("adopt", "adamw"):
            raise ValueError(f"unknown optimizer {self.optimizer.name!r}")
        if self.scheduler.name != "cosine_with_warmup":
            raise ValueError(f"unknown scheduler {self.scheduler.name!r}")
        self._validate_federation()

    def _validate_federation(self) -> None:
        fl, ph = self.fl, self.photon
        if fl.n_clients_per_round > fl.n_total_clients:
            raise ValueError("n_clients_per_round > n_total_clients")
        if fl.strategy_name not in STRATEGY_NAMES:
            raise ValueError(f"unknown fl.strategy_name {fl.strategy_name!r}")
        if fl.client_count_scaling not in ("none", "linear", "sqrt"):
            raise ValueError(f"bad client_count_scaling {fl.client_count_scaling}")
        if ph.host_threads < 0:
            raise ValueError(f"photon.host_threads must be >= 0 (0 = auto), got {ph.host_threads}")
        comp = ph.compression
        if comp.policy not in COMPRESSION_POLICIES:
            raise ValueError(f"unknown compression.policy {comp.policy!r}")
        if comp.policy == "delta":
            warnings.warn(
                "compression.policy='delta' is lossless but INFLATES the "
                "wire ~2x on fp32 payloads (float64 deltas); use delta_q8 "
                "or delta_topk_q8 to actually reduce bytes",
                stacklevel=3,
            )
        if not 0.0 < comp.topk_ratio <= 1.0:
            raise ValueError(f"compression.topk_ratio must be in (0, 1], got {comp.topk_ratio}")
        if comp.q8_block_size < 1:
            raise ValueError(f"compression.q8_block_size must be >= 1, got {comp.q8_block_size}")
        if comp.ef_max_clients < 1:
            raise ValueError(
                f"compression.ef_max_clients must be >= 1, got {comp.ef_max_clients}")
        mem = ph.membership
        if mem.ping_interval_rounds < 0 or mem.ping_timeout_s < 0:
            raise ValueError("membership ping knobs must be >= 0")
        if mem.suspect_after_misses < 1 or mem.dead_after_misses < mem.suspect_after_misses:
            raise ValueError(
                "membership needs 1 <= suspect_after_misses <= dead_after_misses, got "
                f"{mem.suspect_after_misses}/{mem.dead_after_misses}"
            )
        if mem.reconnect_backoff_base_s <= 0 or mem.reconnect_backoff_max_s < mem.reconnect_backoff_base_s:
            raise ValueError(
                "membership reconnect backoff needs 0 < base_s <= max_s, got "
                f"{mem.reconnect_backoff_base_s}/{mem.reconnect_backoff_max_s}"
            )
        if not 0.0 <= mem.reconnect_backoff_jitter < 1.0:
            raise ValueError(
                f"membership.reconnect_backoff_jitter must be in [0, 1), got "
                f"{mem.reconnect_backoff_jitter}"
            )
        if mem.reconnect_max_attempts < 0:
            raise ValueError("membership.reconnect_max_attempts must be >= 0 (0 = unlimited)")
        for what, on in (
            ("photon.comm_stack.collective", ph.comm_stack.collective),
            ("photon.chaos", bool(ph.chaos.get("enabled", False))),
            ("photon.telemetry", bool(ph.telemetry.get("enabled", False))),
            ("photon.async_rounds", bool(ph.async_rounds.get("enabled", False))),
        ):
            if on:
                raise NotImplementedError(
                    f"{what} is not ported to photon_tpu_torch yet; turn it off "
                    "or run with photon_tpu"
                )


def _validate_speculative(spec: SpeculativeConfig) -> None:
    """``serve.speculative``'s bounds, with the JAX package's texts."""
    if not 1 <= spec.k <= 32:
        raise ValueError(
            f"serve.speculative.k must be in [1, 32], got {spec.k} "
            "(the verify grid runs k+1 columns — a deeper draft than 32 "
            "is past any n-gram drafter's useful horizon)"
        )
    if spec.draft_budget < 1:
        raise ValueError(
            f"serve.speculative.draft_budget must be >= 1, got {spec.draft_budget}"
        )
    if not 1 <= spec.min_ngram <= spec.max_ngram:
        raise ValueError(
            f"serve.speculative needs 1 <= min_ngram <= max_ngram, got "
            f"{spec.min_ngram}/{spec.max_ngram}"
        )
    if not 0.0 <= spec.accept_floor <= 1.0:
        raise ValueError(
            f"serve.speculative.accept_floor must be in [0, 1], got {spec.accept_floor}"
        )
    if not 0.0 < spec.ewma_alpha <= 1.0:
        raise ValueError(
            f"serve.speculative.ewma_alpha must be in (0, 1], got {spec.ewma_alpha}"
        )
    if spec.probe_ticks < 0:
        raise ValueError(
            f"serve.speculative.probe_ticks must be >= 0 (0 = never probe), got "
            f"{spec.probe_ticks}"
        )


def _validate_fleet(flt: FleetConfig) -> None:
    """``serve.fleet``'s bounds, with the JAX package's texts."""
    if flt.replicas < 1:
        raise ValueError(f"serve.fleet.replicas must be >= 1, got {flt.replicas}")
    for pname in ("port", "control_port"):
        pv = getattr(flt, pname)
        if not 0 <= pv <= 65535:
            raise ValueError(f"serve.fleet.{pname} must be in [0, 65535], got {pv}")
    if flt.prefix_affinity_blocks < 0:
        raise ValueError(
            f"serve.fleet.prefix_affinity_blocks must be >= 0 (0 = no "
            f"prefix affinity), got {flt.prefix_affinity_blocks}"
        )
    if flt.report_poll_s <= 0 or flt.report_timeout_s <= 0:
        raise ValueError(
            f"serve.fleet needs report_poll_s > 0 and report_timeout_s "
            f"> 0, got {flt.report_poll_s}/{flt.report_timeout_s}"
        )
    if flt.route_retries < 0:
        raise ValueError(f"serve.fleet.route_retries must be >= 0, got {flt.route_retries}")


def _validate_lora(m: ModelConfig) -> None:
    """``model.lora_*``, with the JAX package's texts."""
    if m.lora_rank < 0:
        raise ValueError(f"model.lora_rank must be >= 0, got {m.lora_rank}")
    if not m.lora_rank:
        return
    if m.lora_alpha <= 0:
        raise ValueError(f"model.lora_alpha must be > 0, got {m.lora_alpha}")
    bad = [t for t in m.lora_targets if t not in LORA_TARGETABLE]
    if bad:
        raise ValueError(
            f"model.lora_targets {bad} are not adaptable dense modules "
            f"(choose from {LORA_TARGETABLE})"
        )
    if m.mlp == "moe":
        raise ValueError("model.lora_rank with mlp='moe' is not supported")


def _validate_adapters(cfg: "Config") -> None:
    """``photon.adapters``, with the JAX package's texts (its checks of
    ``photon_tpu/config/schema.py``)."""
    ad = cfg.photon.adapters
    if not ad.enabled:
        return
    if ad.rank < 1:
        raise ValueError(
            f"photon.adapters.rank must be >= 1 when enabled, got {ad.rank} "
            "(rank 0 is no adapter at all)"
        )
    if ad.alpha <= 0:
        raise ValueError(
            f"photon.adapters.alpha must be > 0, got {ad.alpha} "
            "(the LoRA delta scales by alpha/rank)"
        )
    if not ad.targets:
        raise ValueError(
            "photon.adapters.targets is empty — name at least one dense module "
            f"to adapt (choose from {LORA_TARGETABLE})"
        )
    bad = [t for t in ad.targets if t not in LORA_TARGETABLE]
    if bad:
        raise ValueError(
            f"photon.adapters.targets {bad} are not adaptable dense modules "
            f"(choose from {LORA_TARGETABLE})"
        )
    if cfg.model.mlp == "moe":
        raise ValueError(
            "photon.adapters with model.mlp='moe' is not supported: "
            "batch-global expert capacity breaks per-slot adapter purity "
            "(the same reason MoE is prefix-cache-ineligible)"
        )
    if ad.pool_size < 1:
        raise ValueError(f"photon.adapters.pool_size must be >= 1, got {ad.pool_size}")
    if not isinstance(ad.cohorts, dict):
        raise ValueError(
            "photon.adapters.cohorts must map cohort name -> [cid, ...], got "
            f"{type(ad.cohorts).__name__}"
        )
    if not ad.cohorts:
        raise ValueError(
            "photon.adapters.enabled needs a non-empty cohorts map (cohort name "
            "-> [cid, ...]; serve-side configs may use empty cid lists — the "
            "names select the adapter bank)"
        )
    seen: dict[int, str] = {}
    for name, cids in ad.cohorts.items():
        if not isinstance(cids, (list, tuple)):
            raise ValueError(
                f"photon.adapters.cohorts[{name!r}] must be a list of client ids, "
                f"got {type(cids).__name__}"
            )
        for cid in cids:
            if not isinstance(cid, int) or cid < 0:
                raise ValueError(
                    f"photon.adapters.cohorts[{name!r}] has a bad client id {cid!r} "
                    "(need ints >= 0)"
                )
            if cid in seen:
                raise ValueError(
                    f"client id {cid} appears in cohorts {seen[cid]!r} AND {name!r} — "
                    "cohorts must not overlap (one adapter per client)"
                )
            seen[cid] = name
    if cfg.fl.aggregate_momenta:
        raise ValueError(
            "photon.adapters with fl.aggregate_momenta is not supported: the "
            "adapter wire carries A/B factors only (momenta piggybacking is a "
            "full-payload feature)"
        )
    if cfg.photon.comm_stack.collective_device_optimizer:
        raise ValueError(
            "photon.adapters runs the per-cohort server optimizers on host "
            "(adapter payloads are tiny); set "
            "comm_stack.collective_device_optimizer=false"
        )


def _check_ragged_device(device: Any) -> None:
    """The ragged walk on a CUDA device runs the kernel, which is built for
    ``sm_90a`` only. On the CPU it runs the kernel's plain version, which
    the caller asked for by naming the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise ValueError("the ragged attention walk on cuda, but no CUDA device")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise ValueError(
            f"serve.attention_impl auto/ragged needs a Hopper card (sm_90a) on cuda; "
            f"{torch.cuda.get_device_name(dev)} is sm_{cap[0]}{cap[1]}"
        )


def _plain(x: Any) -> Any:
    """Tuples → lists, recursively, so ``yaml.safe_dump`` can write it."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _build(cls: type, d: dict[str, Any]) -> Any:
    """A dataclass from a (possibly partial) dict, nested sections
    included; an unknown key raises, as in the JAX package."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for name, value in d.items():
        if name not in names:
            raise ValueError(f"unknown config key {cls.__name__}.{name}")
        hint = hints.get(name)
        if dataclasses.is_dataclass(hint) and isinstance(value, dict):
            value = _build(hint, value)
        elif (hint is tuple or typing.get_origin(hint) is tuple) and isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)
