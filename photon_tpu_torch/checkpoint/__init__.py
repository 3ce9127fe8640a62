"""Round checkpoints: the object store, npz serialization, the manager."""

from photon_tpu_torch.checkpoint.server import ServerCheckpointManager  # noqa: F401
from photon_tpu_torch.checkpoint.store import FileStore  # noqa: F401
