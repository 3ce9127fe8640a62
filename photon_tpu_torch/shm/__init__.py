"""Named shared-memory plane for parameter payloads on one host."""

from photon_tpu_torch.shm.plane import (  # noqa: F401
    ShmSegment,
    read_params,
    shm_dir,
    unlink,
    wait_for,
    write_params,
)
