"""Config schema and the model presets (mpt-125m, llama-1b)."""

from __future__ import annotations

import pathlib

import yaml

from photon_tpu_torch.config.schema import (  # noqa: F401
    Config,
    DatasetConfig,
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    PhotonConfig,
    SchedulerConfig,
    ServeConfig,
    TrainConfig,
)

_PRESET_DIR = pathlib.Path(__file__).parent / "presets"


def list_presets() -> list[str]:
    return sorted(p.stem for p in _PRESET_DIR.glob("*.yaml"))


def load_preset(name: str) -> Config:
    """A preset (e.g. ``mpt-125m``): its model, optimizer, scheduler and
    train sections over the defaults."""
    path = _PRESET_DIR / f"{name}.yaml"
    if not path.exists():
        raise ValueError(f"unknown preset {name!r}; available: {list_presets()}")
    return Config.from_dict(yaml.safe_load(path.read_text())).validate()
