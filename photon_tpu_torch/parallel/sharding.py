"""Sharding rules for MPT parameters, batches and optimizer state (the port
of ``photon_tpu/parallel/sharding.py``).

The rule table :data:`_RULES` is JAX's, verbatim, matched against the
port's flat ``/``-joined parameter names (the JAX package joins its tree
paths the same way). A spec is a tuple with one entry a dimension:
``None`` (replicated), an axis name, or a tuple of axis names (the
dimension splits over their product, the first axis major), as JAX's
``PartitionSpec``. Layout (parameters carry a leading ``[n_layers]``
axis, sharded over ``pipe``):

- ``wqkv``/``up_proj`` kernels ``[L, D, F]``: F on ``tensor``, D on
  ``fsdp``; ``out_proj``/``down_proj`` ``[L, F, D]``: F on ``tensor``, D
  on ``fsdp``;
- ``wte`` ``[V, D]``: V on ``fsdp``, D on ``tensor``; ``wpe`` ``[S, D]``:
  D on ``fsdp``; norm scales replicated;
- token batches ``[B, S]``: B over ``(data, fsdp, expert)``, S over
  ``sequence`` (:func:`batch_spec`).

Any dimension that its axes do not divide is replicated instead
(:func:`_fit_spec`). :func:`shard_params` stores each distinct shard once,
on the device of the first mesh position that holds it
(:class:`ShardedTensor`); :func:`state_shardings` gives the optimizer
moments their parameter's spec by shape, as JAX does.
"""

from __future__ import annotations

import itertools
import re

import numpy as np
import torch

from photon_tpu_torch.parallel.mesh import AXES, Mesh

# ordered (path-regex, spec) rules; first match wins (JAX's table)
_RULES: list[tuple[str, tuple]] = [
    (r"wte/embedding$", ("fsdp", "tensor")),
    (r"^wpe$", (None, "fsdp")),
    (r"router$", ("pipe", "fsdp", None)),
    (r"(moe_up|moe_gate)$", ("pipe", "expert", "fsdp", "tensor")),
    (r"moe_down$", ("pipe", "expert", "tensor", "fsdp")),
    (r"(wqkv|up_proj|gate_proj|q_proj|k_proj|v_proj)/kernel$", ("pipe", "fsdp", "tensor")),
    (r"(out_proj|down_proj)/kernel$", ("pipe", "tensor", "fsdp")),
    (r"(wqkv|up_proj|gate_proj|q_proj|k_proj|v_proj)/bias$", ("pipe", "tensor")),
    (r"(out_proj|down_proj)/bias$", ("pipe", "fsdp")),
    (r"lm_head/kernel$", ("tensor", "fsdp")),
    (r"(ln_1|ln_2)/(scale|bias)$", ("pipe",)),
    (r"ln_f/(scale|bias)$", ()),
]


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _fit_spec(spec: tuple, shape: tuple[int, ...], mesh: Mesh) -> tuple:
    """Drop axes that do not divide the dimension (or overflow the rank),
    and axes the mesh does not have."""
    out = []
    for i, dim in enumerate(shape):
        axis = spec[i] if i < len(spec) else None
        names = _axes(axis)
        if not names or any(a not in mesh.shape for a in names):
            out.append(None)
            continue
        size = int(np.prod([mesh.shape[a] for a in names]))
        out.append(axis if dim % size == 0 else None)
    return tuple(out)


def _shape(v) -> tuple[int, ...]:
    """A tensor's, an array's or a :class:`ShardedTensor`'s shape, or a
    shape given as a tuple."""
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return tuple(v.shape) if hasattr(v, "shape") else tuple(np.shape(v))


def spec_for(name: str, shape: tuple[int, ...], mesh: Mesh) -> tuple:
    for pattern, spec in _RULES:
        if re.search(pattern, name):
            return _fit_spec(spec, tuple(shape), mesh)
    return (None,) * len(shape)  # replicate unknowns


def param_specs(params: dict, mesh: Mesh) -> dict:
    """Spec of every parameter: a flat ``{name: tensor, array or shape}``
    dict, or a nested tree (the same structure comes back)."""
    if any(isinstance(v, dict) for v in params.values()):
        from photon_tpu_torch.codec.params import flatten, unflatten

        return unflatten(param_specs(flatten(params), mesh))
    return {n: spec_for(n, _shape(v), mesh) for n, v in params.items()}


def batch_spec(mesh: Mesh) -> tuple:
    """Tokens ``[B, S]``: the batch over ``data × fsdp × expert``, the
    sequence over ``sequence``."""
    del mesh
    return (("data", "fsdp", "expert"), "sequence")


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------

def position_coords(mesh: Mesh) -> list[dict[str, int]]:
    """Each position's index on every axis, in the mesh's flat order."""
    return [dict(zip(AXES, idx)) for idx in itertools.product(*map(range, mesh.devices.shape))]


def shard_index(spec: tuple, coords: dict[str, int], mesh: Mesh) -> tuple[int, ...]:
    """The shard a position holds: its index along each dimension (the
    axes of a dimension's entry taken as one mixed-radix number, the first
    axis major)."""
    out = []
    for entry in spec:
        idx = 0
        for a in _axes(entry):
            idx = idx * mesh.shape[a] + coords[a]
        out.append(idx)
    return tuple(out)


def shard_counts(spec: tuple, mesh: Mesh) -> tuple[int, ...]:
    return tuple(int(np.prod([mesh.shape[a] for a in _axes(e)])) for e in spec)


def shard_region(shape, spec: tuple, key: tuple[int, ...], mesh: Mesh) -> tuple[slice, ...]:
    """The slices of the full tensor that shard ``key`` covers."""
    out = []
    for dim, n, i in zip(shape, shard_counts(spec, mesh), key):
        step = dim // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


class ShardedTensor:
    """One tensor of a meshed state: its full ``shape``, its ``spec``, and
    each distinct shard once (``shards[key]``), on the device of the first
    mesh position holding that shard. ``keys[p]`` is position ``p``'s
    shard."""

    def __init__(self, shape, spec: tuple, mesh: Mesh, shards: dict) -> None:
        self.shape = tuple(shape)
        self.spec = spec
        self.mesh = mesh
        self.counts = shard_counts(spec, mesh)
        self.keys = [shard_index(spec, c, mesh) for c in position_coords(mesh)]
        self.shards = shards

    @classmethod
    def from_full(cls, full: torch.Tensor, spec: tuple, mesh: Mesh,
                  dtype: torch.dtype | None = None) -> "ShardedTensor":
        st = cls(full.shape, spec, mesh, {})
        for key, dev in zip(st.keys, mesh.devices.flat):
            if key not in st.shards:
                piece = full[shard_region(full.shape, spec, key, mesh)]
                st.shards[key] = piece.to(device=dev, dtype=dtype or full.dtype).clone()
        return st

    def items(self):
        """``(key, shard)`` in key order."""
        return sorted(self.shards.items())

    def region(self, key) -> tuple[slice, ...]:
        return shard_region(self.shape, self.spec, key, self.mesh)

    def full(self, device: torch.device, transform=None) -> torch.Tensor:
        """The whole tensor on ``device``, concatenated from the shards
        (differentiable: the gradient of the gather scatters back to each
        shard). ``transform`` is applied to every shard before it moves
        (a cast moves the smaller dtype)."""
        def rec(prefix: tuple, dim: int) -> torch.Tensor:
            if dim == len(self.counts):
                t = self.shards[prefix]
                t = transform(t) if transform is not None else t
                return t.to(device)
            parts = [rec(prefix + (j,), dim + 1) for j in range(self.counts[dim])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

        return rec((), 0)

    @torch.no_grad()
    def to_full(self) -> torch.Tensor:
        """The whole tensor on the first shard's device, outside autograd."""
        return self.full(self.shards[min(self.shards)].device)

    @torch.no_grad()
    def copy_from_full(self, full: torch.Tensor) -> None:
        """Overwrite every shard from a whole tensor, in place."""
        for key, t in self.shards.items():
            t.copy_(full[self.region(key)].to(device=t.device, dtype=t.dtype))


def shard_params(params: dict, mesh: Mesh) -> dict[str, ShardedTensor]:
    """A host (or device) flat parameter dict → ``{name: ShardedTensor}``
    by the rule table; a nested tree is flattened first."""
    if any(isinstance(v, dict) for v in params.values()):
        from photon_tpu_torch.codec.params import flatten

        params = flatten(params)
    specs = param_specs(params, mesh)
    return {n: ShardedTensor.from_full(
        p.detach() if isinstance(p, torch.Tensor) else torch.from_numpy(np.array(p)),
        specs[n], mesh) for n, p in params.items()}


def state_shardings(params: dict, opt_state: dict, mesh: Mesh) -> dict:
    """Specs for an optimizer state (flat, under optax's names): a moment
    takes the spec of the first parameter, in the codec's (sorted-name)
    order, whose shape equals its own (JAX's shape lookup with
    ``setdefault``, so two parameters of one shape share the first one's
    spec); scalars and counters are replicated."""
    shape_to_spec: dict[tuple, tuple] = {}
    for name, spec in param_specs(params, mesh).items():
        shape_to_spec.setdefault(_shape(params[name]), spec)
    return {k: shape_to_spec.get(_shape(v), (None,) * len(_shape(v)))
            for k, v in opt_state.items()}
