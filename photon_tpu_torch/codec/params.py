"""Parameter tree ⇄ flat ndarray-list codec, and the JAX ⇄ torch bridge.

The port's copy of ``photon_tpu/codec/params.py``: a flat list of numpy
arrays plus (names, shapes, dtypes) metadata, in sorted ``/``-joined name
order. The port's tree is a nested dict of tensors with exactly the JAX
tree's names, shapes and dtypes, so the flat list moves between the two
packages byte for byte (:func:`params_from_numpy` /
:func:`params_to_numpy`).

numpy has no bfloat16, so the port holds a bf16 leaf on the host as its
raw 16-bit words (an ``np.uint16`` array), and its metadata names the
dtype ``"bfloat16"`` (itemsize 2), as the JAX package's does; the words
are never widened. :meth:`ParamsMetadata.validate_arrays` accepts such a
leaf, or one in a dtype numpy calls ``bfloat16`` (the JAX package's, from
``ml_dtypes``), where ``"bfloat16"`` is expected. A bf16 leaf read back
from an npz is a ``|V2`` array (the npy format has no bfloat16); loading
one into a bf16 slot raises :class:`Bf16NpzError`, because the JAX
package cannot load it either.
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
#: the dtype name of a bf16 leaf in metadata
BF16 = "bfloat16"
#: what ``np.load`` returns for a bf16 leaf of an npz
VOID16 = np.dtype("V2")


class Bf16NpzError(ValueError):
    """A bf16 leaf read back from an npz, where numpy left it a ``|V2``
    array, handed to a bf16 slot."""

    def __init__(self, name: str) -> None:
        super().__init__(
            f"array {name!r}: a bfloat16 leaf read back from an npz ('|V2' member) cannot be "
            "loaded: the npy format has no bfloat16, and the JAX package, which writes such "
            "members too, cannot load them either ('Dtype |V2 is not a valid JAX array "
            "type'); resume or evaluate from a float32 run"
        )


def dtype_name(t: torch.Tensor) -> str:
    """The metadata dtype of a tensor: numpy's name (``"float32"``,
    ``"int32"``), or ``"bfloat16"``."""
    return str(t.dtype).removeprefix("torch.")


def host_dtype(dtype: str) -> np.dtype:
    """The numpy dtype holding a leaf of metadata dtype ``dtype`` on the
    host (``"bfloat16"``: its words, ``np.uint16``)."""
    return np.dtype(np.uint16) if dtype == BF16 else np.dtype(dtype)


def itemsize(dtype: str) -> int:
    """Bytes per element of a metadata dtype (``"bfloat16"``: 2)."""
    return host_dtype(dtype).itemsize


def _holds(dtype: str, a: np.ndarray) -> bool:
    """Whether host array ``a`` holds a leaf of metadata dtype ``dtype``:
    the dtype itself, or a bf16 leaf's 16-bit words."""
    if str(a.dtype) == dtype:
        return True
    return dtype == BF16 and a.dtype == np.uint16


@dataclasses.dataclass(frozen=True)
class ParamsMetadata:
    """Names, shapes and dtypes of the flat parameter list."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[str, ...]

    @classmethod
    def from_ndarrays(cls, names: Iterable[str], arrays: Iterable[np.ndarray],
                      dtypes: Iterable[str] | None = None) -> "ParamsMetadata":
        """Names and shapes of ``arrays``; their dtypes unless ``dtypes``
        names them (a bf16 leaf's ``np.uint16`` words are ``"bfloat16"``)."""
        names = tuple(names)
        arrays = list(arrays)
        return cls(
            names=names,
            shapes=tuple(tuple(a.shape) for a in arrays),
            dtypes=tuple(dtypes) if dtypes is not None else tuple(str(a.dtype) for a in arrays),
        )

    @property
    def nbytes_each(self) -> list[int]:
        return [int(np.prod(s, dtype=np.int64)) * itemsize(d)
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
            if dtype == BF16 and a.dtype == VOID16:
                raise Bf16NpzError(name)
            if tuple(a.shape) != shape or not _holds(dtype, a):
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


def refuse_npz_bf16(slots: dict[str, torch.dtype], arrays: list[np.ndarray]) -> None:
    """Raise :class:`Bf16NpzError` where an npz's ``|V2`` leaf would fill
    a bf16 slot (``slots``: name → dtype, in the arrays' order)."""
    for (name, dtype), a in zip(slots.items(), arrays):
        if dtype == torch.bfloat16 and a.dtype == VOID16:
            raise Bf16NpzError(name)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host array that owns its memory: for a CPU tensor ``.numpy()``
    would be a view of the tensor's storage, which later in-place updates
    (the optimizer, ``set_parameters``) overwrite. A bf16 tensor comes back
    as its 16-bit words (``np.uint16``)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_tensor(a: np.ndarray, dtype: str, name: str = "") -> torch.Tensor:
    """A CPU tensor of metadata dtype ``dtype`` from host array ``a`` (a
    copy: npz arrays are read-only); a bf16 leaf's words are reinterpreted,
    never converted."""
    if dtype == BF16:
        if a.dtype == VOID16:
            raise Bf16NpzError(name)
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def tensors_to_ndarrays(names: Iterable[str], tensors: Iterable[torch.Tensor]
                        ) -> tuple[ParamsMetadata, list[np.ndarray]]:
    """(metadata, fresh host arrays) of ``tensors``, each in its own
    dtype."""
    tensors = list(tensors)
    arrays = [to_numpy(t) for t in tensors]
    return ParamsMetadata.from_ndarrays(names, arrays, [dtype_name(t) for t in tensors]), arrays


def params_to_ndarrays(params: dict) -> tuple[ParamsMetadata, list[np.ndarray]]:
    """Tree → (metadata, host numpy arrays) in canonical order."""
    flat = flatten(params)
    return tensors_to_ndarrays(flat.keys(), flat.values())


def params_from_ndarrays(template: dict, metadata: ParamsMetadata,
                         arrays: list[np.ndarray]) -> dict:
    """(metadata, arrays) → tree shaped like ``template``, on the
    template's device, with validation. A bf16 slot of ``template`` takes
    only a bf16 leaf (:class:`Bf16NpzError` for an npz's ``|V2`` one)."""
    flat = flatten(template)
    refuse_npz_bf16({n: t.dtype for n, t in flat.items()}, arrays)
    metadata.validate_arrays(arrays)
    if tuple(flat) != metadata.names:
        raise ValueError(
            "parameter name mismatch between template and metadata; "
            f"first diff: {_first_diff(flat, metadata.names)}"
        )
    return unflatten({
        n: to_tensor(a, d, n).to(t.device)
        for (n, t), a, d in zip(flat.items(), arrays, metadata.dtypes)
    })


def params_from_numpy(flat_names: Iterable[str], arrays: list[np.ndarray],
                      cfg, device: str | torch.device = "cpu") -> dict:
    """The JAX package's parameters (numpy arrays in codec order) → the
    port's tree on ``device``. Names and shapes are checked against the
    tree ``cfg`` describes; dtypes are kept as stored, a bf16 leaf's words
    (``np.uint16``, or numpy's ``bfloat16`` from ``ml_dtypes``) becoming
    a bf16 tensor where ``cfg`` builds that leaf in bf16."""
    from photon_tpu_torch.models.mpt import param_dtypes, param_shapes

    names = tuple(flat_names)
    want = param_shapes(cfg)
    want_dt = param_dtypes(cfg)
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
        bf16 = want_dt[name] == torch.bfloat16 and (a.dtype == np.uint16 or a.dtype == VOID16
                                                    or str(a.dtype) == BF16)
        flat[name] = to_tensor(a, BF16 if bf16 else str(a.dtype), name).to(device)
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
    return ParamsMetadata(metadata.names[:n], metadata.shapes[:n], metadata.dtypes[:n]), arrays[:n]


def _first_diff(a: Iterable[str], b: Iterable[str]) -> str:
    for x, y in zip(a, b):
        if x != y:
            return f"{x!r} vs {y!r}"
    return "length mismatch"
