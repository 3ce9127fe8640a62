"""Validated per-round client configs (the port of
``photon_tpu/federation/configs.py``).

Every knob the client runtime reads from ``FitIns.config`` /
``EvaluateIns.config`` is declared and typed here: an unknown (for example
misspelled) key raises instead of silently doing nothing, and
string-encoded values are parsed with ``ast.literal_eval``. Round
metadata (cids, round, local steps, client states, cumulative server
steps) travels as typed fields of :class:`FitIns`.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any


class ConfigError(ValueError):
    """A per-round config failed validation (unknown key or bad type)."""


def _parse(value: Any, want: type, name: str) -> Any:
    """Coerce a possibly string-encoded value (reference: ``validate_ast``,
    ``configs.py:185-214``) and type-check it."""
    if isinstance(value, str) and want is not str:
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError) as e:
            raise ConfigError(f"{name}: unparseable string {value!r}") from e
    if want is bool:
        if not isinstance(value, bool):
            raise ConfigError(f"{name}: expected bool, got {type(value).__name__}")
    elif want is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f"{name}: expected int, got {type(value).__name__}")
    elif want is list:
        if value is None:
            return []
        if not isinstance(value, (list, tuple)) or not all(isinstance(x, str) for x in value):
            raise ConfigError(f"{name}: expected list[str], got {value!r}")
        return list(value)
    elif want is dict:
        if value is None:
            return None
        if not isinstance(value, dict):
            raise ConfigError(f"{name}: expected dict, got {type(value).__name__}")
    return value


_FIELD_KINDS = {bool: bool, int: int, list: list, dict: dict}


def _from_dict(cls, d: dict[str, Any] | None):
    d = dict(d or {})
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise ConfigError(
            f"{cls.__name__}: unknown key(s) {sorted(unknown)}; "
            f"valid keys: {sorted(fields)}"
        )
    kwargs = {}
    for name, value in d.items():
        f = fields[name]
        want = f.metadata.get("kind", type(f.default) if f.default is not None else dict)
        kwargs[name] = _parse(value, want, f"{cls.__name__}.{name}")
    return cls(**kwargs)


def _knob(kind: type, default: Any) -> Any:
    if kind is list:
        return field(default_factory=list, metadata={"kind": list})
    return field(default=default, metadata={"kind": kind})


@dataclass
class FitRoundConfig:
    """Knobs the server may set per fit round (reference ``FitConfig``
    behavior fields, ``clients/configs.py:55-214``; reset-knob semantics
    ``clients/utils.py:177-254``)."""

    # drop optimizer state before local training (reference reset_optimizer)
    reset_optimizer: bool = _knob(bool, False)
    # rewind the client's train loader to the start (reference reset_dataset_state)
    reset_dataset_state: bool = _knob(bool, False)
    # save/load per-client step checkpoints with skip-if-done resume
    # (reference client checkpoint path, ``llm_config_functions.py:642-764``)
    client_checkpoints: bool = _knob(bool, False)
    # param-path regexes kept client-local across rounds (reference
    # personalized_layers)
    personalize_patterns: list = _knob(list, None)
    # param-path regexes re-randomized each round (reference random_layers)
    randomize_patterns: list = _knob(list, None)
    # explicit per-cid loader states pushed by the server (no reference
    # analog; used for exact data-order control in tests/migrations)
    loader_state: dict | None = _knob(dict, None)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "FitRoundConfig":
        return _from_dict(cls, d)


@dataclass
class EvaluateRoundConfig:
    """Knobs for federated eval rounds (reference ``EvaluateConfig``,
    ``clients/configs.py:289-425``)."""

    # compute unigram-normalized CE/PPL when the client's freq dict exists
    use_unigram_metrics: bool = _knob(bool, True)
    # missing freq dict is an error instead of a silent skip (reference
    # allow_unigram_metrics_failures, inverted default)
    allow_unigram_failures: bool = _knob(bool, True)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "EvaluateRoundConfig":
        return _from_dict(cls, d)
