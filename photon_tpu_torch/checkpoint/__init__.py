"""Checkpoints: the object stores, serialization, the server round manager
and the client (per-step) manager."""

from photon_tpu_torch.checkpoint.client import ClientCheckpointManager  # noqa: F401
from photon_tpu_torch.checkpoint.server import ServerCheckpointManager  # noqa: F401
from photon_tpu_torch.checkpoint.store import (  # noqa: F401
    FileStore,
    ObjectStore,
    S3Store,
    make_store,
)
