"""Array-list and state blob (de)serialization for checkpoints (the same
formats as ``photon_tpu/checkpoint/serialization.py``): ``.npz`` with the
arrays under indexed keys ``arr_000000..`` plus a ``__names__`` manifest,
because npz key order is alphabetical and payload order is load-bearing;
small control state (steps, loader positions) as a pickled dict."""

from __future__ import annotations

import io
import json
import pickle
from typing import Any

import numpy as np

from photon_tpu_torch.codec.params import ParamsMetadata


def arrays_to_npz(metadata: ParamsMetadata, arrays: list[np.ndarray]) -> bytes:
    metadata.validate_arrays(arrays)
    buf = io.BytesIO()
    np.savez(
        buf,
        __names__=np.frombuffer(json.dumps(list(metadata.names)).encode(), np.uint8),
        **{f"arr_{i:06d}": a for i, a in enumerate(arrays)},
    )
    return buf.getvalue()


def npz_to_arrays(data: bytes) -> tuple[ParamsMetadata, list[np.ndarray]]:
    with np.load(io.BytesIO(data)) as z:
        names = tuple(json.loads(bytes(z["__names__"]).decode()))
        arrays = [z[f"arr_{i:06d}"] for i in range(len(names))]
    return ParamsMetadata.from_ndarrays(names, arrays), arrays


def state_to_bytes(state: dict[str, Any]) -> bytes:
    return pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)


def bytes_to_state(data: bytes) -> dict[str, Any]:
    return pickle.loads(data)
