"""Config schema and the model presets: the JAX package's eight YAMLs,
byte for byte (mpt-125m, mpt-125m-moe8, mpt-350m, mpt-760m, mpt-1b,
mpt-3b, mpt-7b, llama-1b)."""

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


def load_preset(name: str, **overrides) -> Config:
    """A preset (e.g. ``mpt-125m``): its model, optimizer, scheduler and
    train sections over the defaults, then ``overrides`` merged last (a
    dict updates its section, e.g. ``fl={"n_rounds": 10}``; anything else
    replaces the key), as the JAX package's ``load_preset`` does."""
    path = _PRESET_DIR / f"{name}.yaml"
    if not path.exists():
        raise ValueError(f"unknown preset {name!r}; available: {list_presets()}")
    d = yaml.safe_load(path.read_text())
    for key, val in overrides.items():
        if isinstance(val, dict):
            d.setdefault(key, {}).update(val)
        else:
            d[key] = val
    return Config.from_dict(d).validate()
