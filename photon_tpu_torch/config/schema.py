"""The port's own copy of the config schema (``photon_tpu/config/schema.py``).

``ModelConfig``, ``ServeConfig``, ``OptimizerConfig``, ``SchedulerConfig``,
``MeshConfig``, ``TrainConfig``, ``DatasetConfig``, ``FLConfig``,
``CommStackConfig``, ``CompressionConfig``, ``MembershipConfig``,
``AdaptersConfig``, ``ChaosConfig``, ``TelemetryConfig``,
``AsyncRoundsConfig`` and ``PhotonConfig`` carry the same fields, names
and defaults as the JAX package's, so a resolved YAML written by either
package loads in the other with equal fields. ``photon.adapters``
(per-cohort LoRA), ``model.lora_*``, ``photon.chaos``,
``photon.telemetry`` with its SLO autopilot (:class:`AutopilotConfig`),
the collective plane's ``comm_stack.collective_*`` knobs and
``photon.async_rounds`` are validated with the JAX package's texts.
``serve.speculative`` is a :class:`SpeculativeConfig` and ``serve.fleet``
a :class:`FleetConfig`, validated with the JAX package's ``ValueError``
texts, as are the prefix-cache and hot-swap fields of
:class:`ServeConfig`.

:meth:`Config.validate` accepts what the JAX package's accepts and raises
its texts where it refuses. LoRA factors, adapters,
``optimizer.freeze_patterns``, the ``auto`` microbatch probe and the
collective plane train on a mesh of any size. ``model.param_dtype`` is
``float32`` or ``bfloat16`` (the JAX package's tree in either: norms stay
fp32); with ``bfloat16`` the paths on which the JAX package cannot finish
are refused with its failure named: a federated round of any driver
(:meth:`Config.refuse_param_dtype_in_round`) and the pipeline over
``pipe``. Every mesh axis trains (``parallel/spmd.py``, the pipeline in
``parallel/pipeline.py``), with the JAX package's rules for ``pipe`` and
``expert`` and their texts; ``attn_impl: ring`` and
``photon.mesh_autotune`` too; :func:`effective_model_config` is the JAX
package's attention fallback for a mesh. ``mlp: moe`` is checked as the
JAX package checks it (its ``ValueError`` texts);
``device_microbatch_size: auto`` runs the trainer's probe.
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

#: the ``model.param_dtype`` values the port builds its tree in
PARAM_DTYPES = ("float32", "bfloat16")


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
    """The device mesh of one client (``parallel/mesh.py``): ``data``
    (batch data parallel), ``fsdp`` (sharded weights and optimizer state),
    ``tensor`` (heads and MLP columns), ``sequence`` (ring attention),
    ``pipe`` (pipeline stages) and ``expert`` (MoE experts; a batch axis
    too). ``surplus_devices`` is what ``make_mesh`` does with a device
    list that is not a whole multiple of the mesh: warn, error or
    ignore."""

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
    aggregation plane (``parallel/collective_agg.py``) and the collective
    runner (``federation/collective_round.py``)."""

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
class ChaosConfig:
    """Deterministic fault injection (``photon_tpu_torch/chaos``): the JAX
    package's fields and defaults. Off by default, and it must stay off in
    production configs; disabled, every hook site is a ``None`` check."""

    enabled: bool = False
    seed: int = 1234  # each process's stream is seeded by (seed, scope)
    # control plane: per-envelope-frame fault probabilities (federation/tcp.py)
    tcp_drop_p: float = 0.0
    tcp_delay_p: float = 0.0
    tcp_delay_max_s: float = 0.05
    tcp_duplicate_p: float = 0.0
    tcp_corrupt_p: float = 0.0  # one bit flipped; refused by the CRC32 framing
    # object store: per-access fault probabilities (checkpoint/store.py)
    store_slow_p: float = 0.0
    store_slow_max_s: float = 0.05
    store_partial_p: float = 0.0  # the temp file written, never renamed into place
    store_bitflip_p: float = 0.0  # caught by the manifest's checksums
    # node crash: os._exit(137) at a phase of fit handling
    crash_phase: str = ""  # "" | pre-fit | mid-fit | pre-reply (the collective
    #                      # round's pre-exchange | mid-exchange | pre-update too)
    crash_round: int = 0  # only at this server round (0 = any)
    crash_node_id: str = ""  # only on this node ("" = any)
    # a file that makes the crash happen once: a restarted node sees it
    crash_marker: str = ""
    # cap on the corrupting store faults (partial, bitflip; reads and
    # writes) of one process's injector; 0 = unlimited
    store_fault_max: int = 0
    # a NaN in a client's shipped fit result at this round (0 = off)
    nan_delta_round: int = 0
    nan_delta_cid: int = -1  # -1 = every client of that round
    # kill one serving replica after the router placed this many requests
    replica_kill_after_requests: int = 0  # 0 = off
    replica_kill_id: str = ""  # "" = a seeded pick among the live replicas
    # a client's fit slowdown factor: 0 = off; >= 1 = the factor (the full
    # factor on fit_delay_cid, or a seeded one in [1, factor] on every cid)
    fit_delay_factor: float = 0.0
    fit_delay_cid: int = -1
    # seconds of stall per token a serving step carried (0 = off)
    serve_stall_per_token_s: float = 0.0
    # the n-th serving device-memory sample inflated by 1 + frac * n (0 = off)
    serve_hbm_ramp_frac: float = 0.0


@dataclass
class AutopilotConfig:
    """SLO autopilot (``photon_tpu_torch/telemetry/autopilot.py``; the JAX
    package's fields, defaults and checks).

    A feedback controller that closes the observe→actuate loop: declared
    SLO targets are evaluated periodically against windowed reductions of
    the typed-metric hub, and breaches drive runtime-mutable knobs the
    owning subsystems registered at install time. OFF by default; the
    disabled cost is one ``None`` check per hook site. Rules whose target
    is 0 are individually off. Every actuation is reversible: after
    ``relax_after`` consecutive clean evaluations a rule probes its knob
    back toward the value the subsystem declared at registration.
    """

    enabled: bool = False
    period_s: float = 0.25  # min seconds between evaluations, per plane
    cooldown_s: float = 2.0  # per-rule min seconds between actuations
    relax_after: int = 3  # clean evaluations before a relax probe
    window_s: float = 30.0  # trailing window for metric reductions
    decisions: int = 64  # decision ring surfaced on /statusz
    # hysteresis for rules without an explicit clear bound: an evaluation
    # is clean only when observed <= clear_frac * target
    clear_frac: float = 0.8
    # serve: queue saturation -> shrink prefill_token_budget so admissions
    # drain through cheaper ticks before the 429 path fires
    queue_high_frac: float = 0.75  # breach when ewma(depth)/max_queue >= this
    queue_clear_frac: float = 0.25  # hysteresis: clean only at/below this
    prefill_budget_min: int = 16  # knob floor (declared value is the ceiling)
    prefill_shrink: float = 0.5  # multiplicative tighten step
    # serve: TPOT p50 SLO -> lower the SpecController K ceiling (0 = off)
    tpot_p50_slo_s: float = 0.0
    spec_k_min: int = 1
    # serve/collective: HBM-growth alert -> prefix-cache eviction + adapter
    # LRU shrink (the reclaim action)
    reclaim_free_blocks: int = 8  # PrefixCache.ensure_free target
    # collective: straggler-frac p90 over the window -> tighten the stage
    # timeout (0 = off)
    straggler_p90: float = 0.0
    stage_timeout_min_s: float = 5.0
    stage_timeout_shrink: float = 0.75
    # collective: wire-bytes slope (bytes/s) -> escalate collective
    # quantization off->q8 (0 = off)
    wire_slope_bytes_per_s: float = 0.0
    # async: stale-reject rate (rejects per version advance) -> widen
    # max_staleness within [declared, max_staleness_hi] (0 = off)
    async_reject_per_version: float = 0.0
    max_staleness_hi: int = 16
    # fleet: a replica whose compile counter moved on this many consecutive
    # report polls or whose HBM watcher latched is drained and restarted
    # through the control plane (0 = the compile rule off)
    replica_compile_streak: int = 0


@dataclass
class TelemetryConfig:
    """Distributed tracing + structured telemetry plane
    (``photon_tpu_torch/telemetry``; the JAX package's fields, defaults and
    checks).

    OFF by default; disabled cost is a single ``None`` check per hook site
    (the same discipline as ``photon.chaos``). Enabled, the server merges
    its own round-phase spans with node spans shipped back on
    ``FitRes``/``EvaluateRes``/``Ack`` into one Perfetto/Chrome-trace JSON
    under ``dir``, writes a structured JSONL event log beside it, and —
    with ``prom_port`` set — serves ``/metrics``, ``/statusz`` and
    ``POST /debug/profile`` on ``127.0.0.1:{prom_port}``. ``autopilot`` is
    the SLO controller's block (:class:`AutopilotConfig`), installed with
    the plane.
    """

    enabled: bool = False
    dir: str = ""  # "" → {photon.save_path}/telemetry
    prom_port: int = 0  # 0 = no /metrics endpoint
    max_buffered_spans: int = 4096  # per-process cap; overflow drops oldest
    #: capture a torch.profiler trace covering the FIRST N rounds of the run
    #: (0 = off; the same controller also serves on-demand POST
    #: /debug/profile requests). Artifacts land beside trace-{run}.json.
    profile_rounds: int = 0
    #: per-instrument ring-buffer samples the typed-metric hub retains
    metrics_retention: int = 512
    #: the SLO autopilot: the feedback controller that closes the
    #: observe→actuate loop over the hub this plane installs
    autopilot: AutopilotConfig = field(default_factory=AutopilotConfig)


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
class AsyncRoundsConfig:
    """Asynchronous federated rounds (``federation/async_round.py``; same
    fields and defaults as the JAX package). Off by default. On, a buffered
    version clock replaces the round clock: clients stream deltas when they
    finish, the server folds each full buffer of ``buffer_size`` arrivals
    under staleness-discounted weights, ``max_staleness`` rejects a staler
    delta (its client is re-dispatched from the fresh version) and
    ``min_arrivals`` holds the clock until enough distinct clients landed.
    ``buffer_size == fl.n_total_clients`` with equal client speeds is the
    synchronous round, bit for bit."""

    enabled: bool = False
    #: K, deltas buffered before the version advances; 0 = the full cohort
    buffer_size: int = 0
    #: distinct clients a full buffer needs before it folds
    min_arrivals: int = 1
    max_staleness: int = 4
    staleness_policy: str = "poly"  # poly: (1 + s)^-power | const: 1
    staleness_power: float = 1.0
    #: version advances to run (0 = fl.n_rounds)
    n_versions: int = 0
    #: simulated seconds of one client fit, scaled per client by chaos's
    #: ``fit_delay_factor`` (the discrete-event clock's unit)
    fit_time_s: float = 1.0


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
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    async_rounds: AsyncRoundsConfig = field(default_factory=AsyncRoundsConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
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
        if m.param_dtype not in PARAM_DTYPES:
            raise NotImplementedError(
                f"model.param_dtype={m.param_dtype!r} is not ported to photon_tpu_torch; "
                f"set one of {PARAM_DTYPES}"
            )
        if m.attn_impl not in ("pallas", "xla", "ring"):
            raise ValueError(f"bad model.attn_impl {m.attn_impl!r}")
        if not serving:
            self._validate_training()
            self._refuse_unfinished_param_dtype()
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
        _validate_chaos(self.photon.chaos)
        self._validate_collective()
        _validate_fleet(srv.fleet)
        _validate_telemetry(self.photon.telemetry)
        return self


    def _validate_training(self) -> None:
        m, tr, ph = self.model, self.train, self.photon
        if m.resid_pdrop != 0.0:
            raise ValueError("resid_pdrop > 0 is not implemented (dropout-free pretraining)")
        self._validate_mesh()
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

    def _validate_mesh(self) -> None:
        """The mesh checks of training: JAX's (the pipeline's and the expert
        axis's), with its texts."""
        mesh, m = self.mesh, self.model
        if mesh.surplus_devices not in ("warn", "error", "ignore"):
            raise ValueError(
                f"mesh.surplus_devices must be one of ('warn', 'error', "
                f"'ignore'), got {mesh.surplus_devices!r}"
            )
        for axis, size in mesh.__dict__.items():
            if axis != "surplus_devices" and size < 1:
                raise ValueError(f"mesh.{axis} must be >= 1, got {size}")
        if mesh.pipe > 1:
            if self.train.device_microbatch_size == "auto":
                raise ValueError(
                    "device_microbatch_size='auto' is not supported with "
                    "mesh.pipe > 1 (the OOM probe builds the non-pipelined "
                    "step); set an explicit microbatch size"
                )
            if m.n_layers % mesh.pipe:
                raise ValueError(
                    f"n_layers={m.n_layers} must divide evenly into "
                    f"mesh.pipe={mesh.pipe} stages"
                )
            if mesh.sequence > 1:
                raise ValueError(
                    "mesh.pipe > 1 with mesh.sequence > 1 is not supported: "
                    "ring attention's shard_map cannot nest inside the "
                    "pipeline's manual pipe axis"
                )
            if sum(a > 1 for a in (mesh.data, mesh.fsdp, mesh.expert)) > 1:
                raise ValueError(
                    "mesh.pipe > 1 supports at most ONE batch-sharded axis "
                    "> 1 (data, fsdp, or expert): compound batch sharding "
                    "inside the partial-manual pipeline region hits an XLA "
                    "SPMD partitioner CHECK failure "
                    "(spmd_partitioner_util.cc group-count assertion). "
                    "Fold the batch parallelism into one axis"
                )
        if m.mlp == "moe":
            if mesh.expert > 1 and m.moe_num_experts % mesh.expert:
                raise ValueError(
                    f"moe_num_experts={m.moe_num_experts} must be "
                    f"divisible by mesh.expert={mesh.expert}"
                )
        elif mesh.expert > 1:
            raise ValueError("mesh.expert > 1 requires model.mlp='moe'")

    def _refuse_unfinished_param_dtype(self) -> None:
        """A ``model.param_dtype`` other than float32 on the training paths
        the JAX package cannot finish with it: a federated round (the
        collective plane, async rounds and adapter rounds are named by the
        config; the other drivers call :meth:`refuse_param_dtype_in_round`)
        and the pipeline over ``pipe``."""
        if self.model.param_dtype == "float32":
            return
        ph = self.photon
        for what, on in (("the collective plane", ph.comm_stack.collective),
                         ("photon.async_rounds", ph.async_rounds.enabled),
                         ("photon.adapters", ph.adapters.enabled)):
            if on:
                self.refuse_param_dtype_in_round(what)
        self.refuse_param_dtype_on_pipe(self.mesh.pipe)

    def refuse_param_dtype_on_pipe(self, pipe: int) -> None:
        """Raise for a ``model.param_dtype`` other than float32 on a layout
        with ``pipe > 1`` (the config's mesh, or the one the autotuner
        picked): the JAX package's pipelined step aborts in XLA's compiler
        with it."""
        if pipe > 1 and self.model.param_dtype != "float32":
            raise NotImplementedError(
                f"model.param_dtype={self.model.param_dtype!r} with mesh.pipe > 1 is refused: "
                "the JAX package's pipelined step aborts in XLA's compiler with it (a CHECK "
                "failure in hlo_instruction.cc, 'Invalid binary instruction opcode copy')"
            )

    def refuse_param_dtype_in_round(self, what: str = "a federated round") -> None:
        """Raise for a ``model.param_dtype`` other than float32 in a
        federated round (``what`` names the round's runner): the JAX package cannot
        finish one. Its strategy keeps the server's parameters in float32
        (``photon_tpu/strategy/base.py:90``), so each client's
        ``validate_arrays`` rejects the first broadcast and the server
        stops (``photon_tpu/federation/server.py:310``)."""
        if self.model.param_dtype == "float32":
            return
        dt = self.model.param_dtype
        raise NotImplementedError(
            f"model.param_dtype={dt!r} in {what} is refused: the JAX package cannot finish "
            "such a round (its strategy keeps the server's parameters in float32, and every "
            f"client rejects the first broadcast: 'expected .../{dt}, got .../float32'); "
            "train centrally or set float32"
        )

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


    def _validate_collective(self) -> None:
        """``photon.async_rounds`` and the collective plane's
        ``comm_stack.collective_*`` knobs, with the JAX package's texts."""
        ar = self.photon.async_rounds
        if ar.staleness_policy not in ("poly", "const"):
            raise ValueError(
                f"async_rounds.staleness_policy must be 'poly' or 'const', "
                f"got {ar.staleness_policy!r}"
            )
        if ar.buffer_size < 0:
            raise ValueError(
                f"async_rounds.buffer_size must be >= 0 (0 = full cohort), "
                f"got {ar.buffer_size}"
            )
        if ar.max_staleness < 0:
            raise ValueError(
                f"async_rounds.max_staleness must be >= 0, got {ar.max_staleness}"
            )
        if ar.staleness_power < 0:
            raise ValueError(
                f"async_rounds.staleness_power must be >= 0, got "
                f"{ar.staleness_power}"
            )
        if ar.n_versions < 0:
            raise ValueError(
                f"async_rounds.n_versions must be >= 0 (0 = fl.n_rounds), "
                f"got {ar.n_versions}"
            )
        if ar.fit_time_s <= 0:
            raise ValueError(
                f"async_rounds.fit_time_s must be > 0, got {ar.fit_time_s}"
            )
        if ar.enabled:
            if not self.photon.comm_stack.collective:
                raise ValueError(
                    "photon.async_rounds needs comm_stack.collective=true: "
                    "the buffered server folds arrivals through the "
                    "device-resident aggregation plane"
                )
            k = ar.buffer_size or self.fl.n_total_clients
            if k > self.fl.n_total_clients:
                raise ValueError(
                    f"async_rounds.buffer_size={ar.buffer_size} exceeds "
                    f"fl.n_total_clients={self.fl.n_total_clients} — the "
                    "buffer could never fill"
                )
            if not 1 <= ar.min_arrivals <= k:
                raise ValueError(
                    f"async_rounds.min_arrivals must be in [1, K={k}], got "
                    f"{ar.min_arrivals} (above K the clock could never "
                    "advance)"
                )
        elif (
            ar.buffer_size or ar.min_arrivals != 1 or ar.max_staleness != 4
            or ar.staleness_policy != "poly" or ar.staleness_power != 1.0
            or ar.n_versions or ar.fit_time_s != 1.0
        ):
            warnings.warn(
                "photon.async_rounds knobs are set but async_rounds.enabled="
                "False — the synchronous round clock will run",
                stacklevel=3,
            )
        cs = self.photon.comm_stack
        if self.photon.compression.policy != "off" and cs.collective:
            raise ValueError(
                "compression applies to the pointer planes (shm/objstore/"
                "inline); the collective comm stack aggregates on-device and "
                "bypasses the wire codec — set compression.policy='off' "
                "(in-collective quantization is its own knob: "
                "comm_stack.collective_quantization)"
            )
        from photon_tpu_torch.compression.quantize import COLLECTIVE_QUANTIZATIONS

        if cs.collective_quantization not in COLLECTIVE_QUANTIZATIONS:
            raise ValueError(
                f"comm_stack.collective_quantization must be one of "
                f"{COLLECTIVE_QUANTIZATIONS}, got {cs.collective_quantization!r}"
            )
        if cs.collective_replica < 1:
            raise ValueError(
                f"comm_stack.collective_replica must be >= 1, got "
                f"{cs.collective_replica}"
            )
        if cs.collective_q8_block < 0:
            raise ValueError(
                f"comm_stack.collective_q8_block must be >= 0 (0 = codec "
                f"default), got {cs.collective_q8_block}"
            )
        if cs.collective_stage_timeout_s < 0:
            raise ValueError(
                f"comm_stack.collective_stage_timeout_s must be >= 0 "
                f"(0 = no deadlines), got {cs.collective_stage_timeout_s}"
            )
        if not 0.0 < cs.collective_quorum <= 1.0:
            raise ValueError(
                f"comm_stack.collective_quorum must be in (0, 1], got "
                f"{cs.collective_quorum}"
            )
        if cs.collective_retry_budget < 0:
            raise ValueError(
                f"comm_stack.collective_retry_budget must be >= 0, got "
                f"{cs.collective_retry_budget}"
            )
        if not cs.collective and (
            cs.collective_quantization != "off"
            or cs.collective_replica != 1
            or cs.collective_q8_block != 0
            or cs.collective_device_optimizer
            or not cs.collective_zero1
            or cs.collective_stage_timeout_s != 0.0
            or cs.collective_quorum != 0.5
            or cs.collective_retry_budget != 1
        ):
            raise ValueError(
                "comm_stack.collective_{quantization,replica,q8_block,"
                "device_optimizer,zero1,stage_timeout_s,quorum,retry_budget} "
                "shape the collective aggregation plane — set "
                "comm_stack.collective=true (the driver topologies "
                "would silently ignore them)"
            )


def effective_model_config(model: ModelConfig, mesh: MeshConfig) -> ModelConfig:
    """The model config a step builder uses on ``mesh`` (the JAX package's
    function of that name): the config of record is never changed. With a
    warning each, ``pipe > 1`` turns ``pallas`` into ``xla`` (the pipeline's
    stages run the dense attention, as JAX's do), and ``sequence > 1`` turns
    ``pallas`` into ``ring``: a sequence-sharded mesh needs the
    context-parallel dispatch."""
    if mesh.pipe > 1 and model.attn_impl == "pallas":
        warnings.warn(
            "mesh.pipe > 1 with attn_impl=pallas: falling back to "
            "attn_impl=xla inside pipeline stages",
            stacklevel=2,
        )
        return dataclasses.replace(model, attn_impl="xla")
    if mesh.sequence > 1 and model.attn_impl == "pallas":
        warnings.warn(
            "mesh.sequence > 1 with attn_impl=pallas: upgrading to "
            "attn_impl=ring (context-parallel flash over the sequence axis)",
            stacklevel=2,
        )
        return dataclasses.replace(model, attn_impl="ring")
    return model


def _validate_telemetry(tel: TelemetryConfig) -> None:
    """``photon.telemetry``'s bounds, its SLO autopilot's included, with
    the JAX package's texts."""
    if not 0 <= tel.prom_port <= 65535:
        raise ValueError(
            f"telemetry.prom_port must be in [0, 65535] (0 = off), got "
            f"{tel.prom_port}"
        )
    if tel.max_buffered_spans < 1:
        raise ValueError(
            f"telemetry.max_buffered_spans must be >= 1, got "
            f"{tel.max_buffered_spans}"
        )
    if tel.profile_rounds < 0:
        raise ValueError(
            f"telemetry.profile_rounds must be >= 0 (0 = off), got "
            f"{tel.profile_rounds}"
        )
    if tel.metrics_retention < 1:
        raise ValueError(
            f"telemetry.metrics_retention must be >= 1, got "
            f"{tel.metrics_retention}"
        )
    if tel.profile_rounds and not tel.enabled:
        warnings.warn(
            "telemetry.profile_rounds is set but telemetry.enabled=False "
            "— no profile will be captured",
            stacklevel=3,
        )
    apc = tel.autopilot
    if apc.enabled and not tel.enabled:
        raise ValueError(
            "telemetry.autopilot.enabled needs telemetry.enabled=true: "
            "the controller reads the process-global metrics hub and "
            "health monitor"
        )
    for ok, text in (
        (apc.period_s > 0, f"period_s must be > 0, got {apc.period_s}"),
        (apc.cooldown_s >= 0, f"cooldown_s must be >= 0, got {apc.cooldown_s}"),
        (apc.relax_after >= 1, f"relax_after must be >= 1, got {apc.relax_after}"),
        (apc.window_s > 0, f"window_s must be > 0, got {apc.window_s}"),
        (apc.decisions >= 1, f"decisions must be >= 1, got {apc.decisions}"),
        (0.0 < apc.clear_frac <= 1.0, f"clear_frac must be in (0, 1], got {apc.clear_frac}"),
        (0.0 < apc.queue_high_frac <= 1.0,
         f"queue_high_frac must be in (0, 1], got {apc.queue_high_frac}"),
        (0.0 <= apc.queue_clear_frac < apc.queue_high_frac,
         f"queue_clear_frac must be in [0, queue_high_frac={apc.queue_high_frac}), got "
         f"{apc.queue_clear_frac}"),
        (apc.prefill_budget_min >= 1,
         f"prefill_budget_min must be >= 1, got {apc.prefill_budget_min}"),
        (0.0 < apc.prefill_shrink < 1.0,
         f"prefill_shrink must be in (0, 1), got {apc.prefill_shrink}"),
        (apc.tpot_p50_slo_s >= 0,
         f"tpot_p50_slo_s must be >= 0 (0 = off), got {apc.tpot_p50_slo_s}"),
        (apc.spec_k_min >= 1, f"spec_k_min must be >= 1, got {apc.spec_k_min}"),
        (apc.reclaim_free_blocks >= 0,
         f"reclaim_free_blocks must be >= 0, got {apc.reclaim_free_blocks}"),
        (0.0 <= apc.straggler_p90 <= 1.0,
         f"straggler_p90 must be in [0, 1] (0 = off), got {apc.straggler_p90}"),
        (apc.stage_timeout_min_s > 0,
         f"stage_timeout_min_s must be > 0, got {apc.stage_timeout_min_s}"),
        (0.0 < apc.stage_timeout_shrink < 1.0,
         f"stage_timeout_shrink must be in (0, 1), got {apc.stage_timeout_shrink}"),
        (apc.wire_slope_bytes_per_s >= 0,
         f"wire_slope_bytes_per_s must be >= 0 (0 = off), got {apc.wire_slope_bytes_per_s}"),
        (apc.async_reject_per_version >= 0,
         f"async_reject_per_version must be >= 0 (0 = off), got "
         f"{apc.async_reject_per_version}"),
        (apc.max_staleness_hi >= 0,
         f"max_staleness_hi must be >= 0, got {apc.max_staleness_hi}"),
        (apc.replica_compile_streak >= 0,
         f"replica_compile_streak must be >= 0 (0 = off), got {apc.replica_compile_streak}"),
    ):
        if not ok:
            raise ValueError(f"telemetry.autopilot.{text}")


def _validate_chaos(ch: ChaosConfig) -> None:
    """``photon.chaos``'s bounds, and the JAX package's warning for knobs
    set while chaos is off."""
    from photon_tpu_torch.chaos.injector import validate_chaos_config

    validate_chaos_config(ch)
    if not ch.enabled and (ch.crash_phase or any(getattr(ch, p) > 0.0 for p in (
            "tcp_drop_p", "tcp_delay_p", "tcp_duplicate_p", "tcp_corrupt_p",
            "store_slow_p", "store_partial_p", "store_bitflip_p",
            "serve_stall_per_token_s", "serve_hbm_ramp_frac"))):
        warnings.warn(
            "photon.chaos knobs are set but chaos.enabled=False — no "
            "faults will be injected",
            stacklevel=3,
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
