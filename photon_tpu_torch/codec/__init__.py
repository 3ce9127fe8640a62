"""Parameter codec (flat ndarray list + metadata)."""

from photon_tpu_torch.codec.params import (  # noqa: F401
    ParamsMetadata,
    params_from_ndarrays,
    params_from_numpy,
    params_to_ndarrays,
    params_to_numpy,
)
