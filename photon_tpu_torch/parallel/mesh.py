"""The device mesh of one client (the port of ``photon_tpu/parallel/mesh.py``).

A :class:`Mesh` is JAX's: an array of devices shaped ``(data, fsdp,
tensor, sequence, pipe, expert)`` with named axes. Each entry is a
``torch.device``, and one device may fill several positions: on one H100
a mesh may name ``cuda:0`` four times, and on the CPU ``cpu`` repeats (as
``parallel/collective_agg.py::local_devices`` does).

Axes, as in the JAX package:

- ``data``: batch data parallelism (the gradient sum);
- ``fsdp``: parameter and optimizer-state sharding (ZeRO-3);
- ``tensor``: attention heads and MLP columns split over positions;
- ``sequence``: context parallelism (ring attention, ``ops/ring_attention.py``);
- ``pipe``: pipeline stages (``parallel/pipeline.py``);
- ``expert``: MoE experts split over positions, and a batch axis.

**One process drives the whole mesh, as JAX does.** The train step
(``parallel/spmd.py``) holds every position: parameters are stored as
shards on their positions' devices, and each layer runs position by
position, with the collectives written as tensor operations between the
positions' devices (``.to(device)``, ``torch.cat``, sums in a fixed rank
order). Autograd then supplies the transposes that GSPMD inserts: the
gradient of a gather is a scatter, and the gradient of a replicated use
is a sum, so the data-parallel all-reduce and the fsdp reduce-scatter fall
out of one ``backward``. Why one process, and not one process or one
thread per position:

- *The JAX contract.* JAX's ``Trainer(cfg, mesh=...)`` drives a mesh from
  one process, so every caller (``centralized``, the federated node, the
  collective runner) takes a mesh without a process gang of its own.
- *Precedent.* The collective plane's ``ClientMesh`` already runs a grid
  whose rows one process owns, with in-process collectives.
- *One H100.* NCCL refuses two ranks on one GPU; a process per position
  would push every per-layer gather through pinned host memory and open
  a CUDA context per position.
- *No thread per position.* The autograd engine runs a device's backward
  on one worker thread per device; position threads that block in a
  collective inside the backward would deadlock.

A mesh that spans processes (NCCL, one process per card) is not built
here: no path of the JAX package trains on one. Its only process gang,
the collective runner (``jax.distributed.initialize``), pins each
process's client Trainer to one local device.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from photon_tpu_torch.config.schema import MeshConfig

AXES = ("data", "fsdp", "tensor", "sequence", "pipe", "expert")


class Mesh:
    """``devices``: an ndarray of ``torch.device`` over :data:`AXES`."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...] = AXES) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {devices.ndim} for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list[torch.device]:
        """The devices of the mesh, each once, in position order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _local_devices() -> list[torch.device]:
    """The local cards (JAX's ``jax.devices()`` on a GPU host)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(cfg: MeshConfig, devices: Sequence | None = None) -> Mesh:
    """Mesh over ``devices[:cfg.size]`` (default: the local cards, refused
    when there are fewer than ``cfg.size``, as JAX does). An explicit
    ``devices`` list may name one device several times. A surplus that is
    not a whole multiple of the mesh size answers ``cfg.surplus_devices``:
    ``"warn"`` (default), ``"error"`` or ``"ignore"``; an exact multiple
    stays silent (several same-size meshes carved from one list)."""
    devices = _local_devices() if devices is None else [torch.device(d) for d in devices]
    if cfg.size > len(devices):
        raise ValueError(f"mesh needs {cfg.size} devices, have {len(devices)}")
    surplus = len(devices) % cfg.size
    if surplus:
        policy = getattr(cfg, "surplus_devices", "warn")
        msg = (
            f"mesh of size {cfg.size} truncates a {len(devices)}-device list "
            f"that is not a whole multiple ({surplus} device(s) would idle) — "
            "likely a mis-sized mesh config (set mesh.surplus_devices='ignore' "
            "if intentional)"
        )
        if policy == "error":
            raise ValueError(msg)
        if policy != "ignore":
            warnings.warn(msg, stacklevel=2)
    devs = np.empty(cfg.size, dtype=object)
    devs[:] = devices[: cfg.size]
    return Mesh(devs.reshape(cfg.data, cfg.fsdp, cfg.tensor, cfg.sequence, cfg.pipe,
                             cfg.expert))


def single_device_mesh(device: str | torch.device | None = None) -> Mesh:
    device = _local_devices()[0] if device is None else torch.device(device)
    devs = np.empty(1, dtype=object)
    devs[0] = device
    return Mesh(devs.reshape(1, 1, 1, 1, 1, 1))
