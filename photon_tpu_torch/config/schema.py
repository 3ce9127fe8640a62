"""The port's own copy of the config fields that serving and training read.

``ModelConfig``, ``ServeConfig``, ``OptimizerConfig``, ``SchedulerConfig``,
``MeshConfig``, ``TrainConfig`` and ``DatasetConfig`` carry the same
fields, names and defaults as ``photon_tpu/config/schema.py``, so a
resolved YAML written by the JAX package loads here unchanged.
:class:`Config` reads those sections, ``seed``, ``wandb_project``,
``run_uuid`` and the ``photon`` keys below, and ignores every other
section (federation, telemetry): nothing here uses them yet.

:meth:`Config.validate` raises ``NotImplementedError`` for the features
this package does not port yet, so such a config fails at start-up
instead of running without them: MoE, LoRA adapters, speculative
decoding, the prefix cache, hot-swap and the fleet router everywhere; and
for training (``validate(serving=False)``, the default) a mesh of more
than one device, ring attention, ``device_microbatch_size: auto`` and the
mesh autotuner.
"""

from __future__ import annotations

import dataclasses
import pathlib
import typing
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
    mlp: str = "gelu"  # gelu | swiglu | moe (moe is not served here yet)
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
class ServeConfig:
    """Continuous-batching serving plane (same fields as the JAX package).

    ``attention_impl``: ``"auto"`` and ``"ragged"`` walk each slot's live
    blocks through the hand-written CUDA kernel on the card (its plain
    PyTorch version on the CPU); ``"gather"`` is the full-width dense
    gather, the oracle. ``speculative`` and ``fleet`` are kept as the raw
    sections: only their ``enabled`` flag is read, to refuse them.
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
    speculative: dict = field(default_factory=dict)
    fleet: dict = field(default_factory=dict)


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
    device_microbatch_size: int | str = 8  # "auto" is not ported
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


@dataclass
class PhotonConfig:
    serve: ServeConfig = field(default_factory=ServeConfig)
    save_path: str = "/tmp/photon_tpu"
    adapters_enabled: bool = False
    checkpoint: bool = True
    keep_checkpoints: int = 3
    mesh_autotune: bool = False


@dataclass
class Config:
    run_uuid: str = "dev"
    seed: int = 17
    wandb_project: str | None = None
    model: ModelConfig = field(default_factory=ModelConfig)
    photon: PhotonConfig = field(default_factory=PhotonConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)

    # -- (de)serialization ----------------------------------------------
    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        """Read the sections this package uses from a (JAX-written)
        resolved config dict; other sections are ignored."""
        d = d or {}
        ph = d.get("photon") or {}
        base = PhotonConfig()
        return cls(
            run_uuid=str(d.get("run_uuid", "dev")),
            seed=int(d.get("seed", 17)),
            wandb_project=d.get("wandb_project"),
            model=_build(ModelConfig, d.get("model") or {}),
            photon=PhotonConfig(
                serve=_build(ServeConfig, ph.get("serve") or {}),
                save_path=str(ph.get("save_path", base.save_path)),
                adapters_enabled=bool((ph.get("adapters") or {}).get("enabled", False)),
                checkpoint=bool(ph.get("checkpoint", base.checkpoint)),
                keep_checkpoints=int(ph.get("keep_checkpoints", base.keep_checkpoints)),
                mesh_autotune=bool(ph.get("mesh_autotune", base.mesh_autotune)),
            ),
            **{name: _build(sec, d.get(name) or {}) for name, sec in _SECTIONS.items()},
        )

    @classmethod
    def from_yaml(cls, path: str | pathlib.Path) -> "Config":
        return cls.from_dict(yaml.safe_load(pathlib.Path(path).read_text()) or {})

    def to_dict(self) -> dict[str, Any]:
        """The same nesting as the JAX package's resolved config, so either
        package can read the file back."""
        ph = self.photon
        return {
            "run_uuid": self.run_uuid,
            "seed": self.seed,
            "wandb_project": self.wandb_project,
            "model": _plain(dataclasses.asdict(self.model)),
            "photon": {
                "serve": _plain(dataclasses.asdict(ph.serve)),
                "save_path": ph.save_path,
                "adapters": {"enabled": ph.adapters_enabled},
                "checkpoint": ph.checkpoint,
                "keep_checkpoints": ph.keep_checkpoints,
                "mesh_autotune": ph.mesh_autotune,
            },
            **{name: _plain(dataclasses.asdict(getattr(self, name))) for name in _SECTIONS},
        }

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
            raise NotImplementedError(
                "model.mlp='moe' is not served by photon_tpu_torch yet"
            )
        if m.n_kv_heads < 0 or m.mlp_hidden_size < 0:
            raise ValueError("n_kv_heads and mlp_hidden_size must be >= 0")
        if m.n_kv_heads and m.n_heads % m.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if m.rope and m.d_head % 2:
            raise ValueError("rope needs an even d_head")
        if m.lora_rank > 0:
            raise NotImplementedError("LoRA adapters (model.lora_rank > 0) are not ported yet")
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
        for what, on in (
            ("photon.adapters", self.photon.adapters_enabled),
            ("serve.speculative", bool(srv.speculative.get("enabled", False))),
            ("serve.prefix_cache", srv.prefix_cache),
            ("serve.hotswap", srv.hotswap),
            ("serve.fleet", bool(srv.fleet.get("enabled", False))),
        ):
            if on:
                raise NotImplementedError(
                    f"{what} is not served by photon_tpu_torch yet; turn it "
                    "off or serve with photon_tpu"
                )
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
        if isinstance(micro, str):
            if micro == "auto":
                raise NotImplementedError("device_microbatch_size 'auto' is not ported yet")
            raise ValueError(f"device_microbatch_size must be an int or 'auto', got {micro!r}")
        if micro < 1 or tr.global_batch_size < 1:
            raise ValueError("global_batch_size and device_microbatch_size must be >= 1")
        if tr.global_batch_size % micro:
            raise ValueError("global_batch_size must be divisible by device_microbatch_size")
        if tr.loss_chunk_tokens < 0:
            raise ValueError("train.loss_chunk_tokens must be >= 0")
        if self.optimizer.name not in ("adopt", "adamw"):
            raise ValueError(f"unknown optimizer {self.optimizer.name!r}")
        if self.scheduler.name != "cosine_with_warmup":
            raise ValueError(f"unknown scheduler {self.scheduler.name!r}")


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


def _plain(d: dict) -> dict:
    """Tuples → lists, so ``yaml.safe_dump`` can write the dict."""
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


_SECTIONS = {"optimizer": OptimizerConfig, "scheduler": SchedulerConfig, "mesh": MeshConfig,
             "train": TrainConfig, "dataset": DatasetConfig}


def _build(cls: type, d: dict[str, Any]) -> Any:
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for name, value in d.items():
        if name not in names:
            raise ValueError(f"unknown config key {cls.__name__}.{name}")
        hint = hints.get(name)
        if (hint is tuple or typing.get_origin(hint) is tuple) and isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)
