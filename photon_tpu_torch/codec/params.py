"""Parameter tree ⇄ flat ndarray-list codec, and the JAX ⇄ torch bridge.

The port's copy of ``photon_tpu/codec/params.py``: a flat list of numpy
arrays plus (names, shapes, dtypes) metadata, in sorted ``/``-joined name
order. The port's tree is a nested dict of tensors with exactly the JAX
tree's names, shapes and dtypes, so the flat list moves between the two
packages byte for byte (:func:`params_from_numpy` /
:func:`params_to_numpy`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable

import numpy as np
import torch

#: momenta-extended payload prefixes (a momenta-aggregating run ships
#: ``[params | m1 | m2]``); serving keeps the params only
M1_PREFIX = "__momenta_1__/"


@dataclasses.dataclass(frozen=True)
class ParamsMetadata:
    """Names, shapes and dtypes of the flat parameter list."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[str, ...]

    @classmethod
    def from_ndarrays(cls, names: Iterable[str], arrays: Iterable[np.ndarray]) -> "ParamsMetadata":
        names = tuple(names)
        arrays = list(arrays)
        return cls(
            names=names,
            shapes=tuple(tuple(a.shape) for a in arrays),
            dtypes=tuple(str(a.dtype) for a in arrays),
        )

    @property
    def nbytes_each(self) -> list[int]:
        return [int(np.prod(s, dtype=np.int64)) * np.dtype(d).itemsize
                for s, d in zip(self.shapes, self.dtypes)]

    @property
    def total_bytes(self) -> int:
        return sum(self.nbytes_each)

    def to_json(self) -> str:
        return json.dumps({"names": list(self.names), "shapes": [list(s) for s in self.shapes],
                           "dtypes": list(self.dtypes)})

    @classmethod
    def from_dict(cls, d: dict) -> "ParamsMetadata":
        """From a parsed manifest; unknown keys (the transport's ``codec``
        header) are ignored."""
        return cls(names=tuple(d["names"]), shapes=tuple(tuple(s) for s in d["shapes"]),
                   dtypes=tuple(d["dtypes"]))

    @classmethod
    def from_json(cls, s: str) -> "ParamsMetadata":
        return cls.from_dict(json.loads(s))

    def validate_arrays(self, arrays: list[np.ndarray]) -> None:
        if len(arrays) != len(self.names):
            raise ValueError(f"expected {len(self.names)} arrays, got {len(arrays)}")
        for name, shape, dtype, a in zip(self.names, self.shapes, self.dtypes, arrays):
            if tuple(a.shape) != shape or str(a.dtype) != dtype:
                raise ValueError(
                    f"array {name!r}: expected {shape}/{dtype}, got {tuple(a.shape)}/{a.dtype}"
                )


def flatten(params: dict, prefix: str = "") -> dict[str, Any]:
    """Nested dict → ``{"a/b/c": leaf}`` in sorted name order."""
    out: dict[str, Any] = {}
    for key, val in params.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten(val, name + "/"))
        else:
            out[name] = val
    return dict(sorted(out.items()))


def unflatten(flat: dict[str, Any]) -> dict:
    """``{"a/b/c": leaf}`` → nested dict."""
    tree: dict = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host array that owns its memory: for a CPU tensor ``.numpy()``
    would be a view of the tensor's storage, which later in-place updates
    (the optimizer, ``set_parameters``) overwrite."""
    if t.dtype == torch.bfloat16:
        raise ValueError("bf16 tensors have no numpy dtype; keep the fp32 master copy")
    return t.detach().to("cpu", copy=True).numpy()


def params_to_ndarrays(params: dict) -> tuple[ParamsMetadata, list[np.ndarray]]:
    """Tree → (metadata, host numpy arrays) in canonical order."""
    flat = flatten(params)
    arrays = [to_numpy(t) for t in flat.values()]
    return ParamsMetadata.from_ndarrays(flat.keys(), arrays), arrays


def params_from_ndarrays(template: dict, metadata: ParamsMetadata,
                         arrays: list[np.ndarray]) -> dict:
    """(metadata, arrays) → tree shaped like ``template``, on the
    template's device, with validation."""
    metadata.validate_arrays(arrays)
    flat = flatten(template)
    if tuple(flat) != metadata.names:
        raise ValueError(
            "parameter name mismatch between template and metadata; "
            f"first diff: {_first_diff(flat, metadata.names)}"
        )
    return unflatten({
        n: torch.from_numpy(np.array(a)).to(t.device)
        for (n, t), a in zip(flat.items(), arrays)
    })


def params_from_numpy(flat_names: Iterable[str], arrays: list[np.ndarray],
                      cfg, device: str | torch.device = "cpu") -> dict:
    """The JAX package's parameters (numpy arrays in codec order) → the
    port's tree on ``device``. Names and shapes are checked against the
    tree ``cfg`` describes; dtypes are kept as stored."""
    from photon_tpu_torch.models.mpt import param_shapes

    names = tuple(flat_names)
    want = param_shapes(cfg)
    if names != tuple(want):
        raise ValueError(
            "parameter names do not match the model config; first diff: "
            f"{_first_diff(names, tuple(want))}"
        )
    if len(arrays) != len(names):
        raise ValueError(f"expected {len(names)} arrays, got {len(arrays)}")
    flat = {}
    for name, a in zip(names, arrays):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"array {name!r}: expected {want[name]}, got {tuple(a.shape)}")
        flat[name] = torch.from_numpy(np.array(a)).to(device)  # a copy: npz arrays are read-only
    return unflatten(flat)


def params_to_numpy(params: dict) -> tuple[list[str], list[np.ndarray]]:
    """Inverse of :func:`params_from_numpy`: (sorted names, numpy arrays)."""
    meta, arrays = params_to_ndarrays(params)
    return list(meta.names), arrays


def strip_momenta(metadata: ParamsMetadata, arrays: list[np.ndarray]
                  ) -> tuple[ParamsMetadata, list[np.ndarray]]:
    """Drop the aggregated momenta a momenta-shipping run appends
    (``[params | m1 | m2]``); a plain payload passes through."""
    if not any(n.startswith(M1_PREFIX) for n in metadata.names):
        return metadata, arrays
    if len(arrays) % 3:
        raise ValueError("momenta payload is not [params | m1 | m2]")
    n = len(arrays) // 3
    for name, base in zip(metadata.names[n: 2 * n], metadata.names[:n]):
        if name != M1_PREFIX + base:
            raise ValueError(f"momenta section misaligned at {name!r}")
    return ParamsMetadata.from_ndarrays(metadata.names[:n], arrays[:n]), arrays[:n]


def _first_diff(a: Iterable[str], b: Iterable[str]) -> str:
    for x, y in zip(a, b):
        if x != y:
            return f"{x!r} vs {y!r}"
    return "length mismatch"
