"""The ambient mesh (the port of ``photon_tpu/parallel/context.py``).

Attention over a mesh (the ring, the sharded flash dispatch in
``ops/attention.py``) needs the concrete :class:`~photon_tpu_torch.
parallel.mesh.Mesh`, while the model code carries only its config. The
caller publishes the mesh here for the duration of a call instead of
threading it through every function. JAX's ``partial_shard_map`` is a
shim over two jax versions' spellings of ``shard_map`` and has no
counterpart: the port has no ``shard_map``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from photon_tpu_torch.parallel.mesh import Mesh

_CURRENT: list[Mesh] = []


def current_mesh() -> Mesh | None:
    return _CURRENT[-1] if _CURRENT else None


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()
