"""Array-list and state blob (de)serialization for checkpoints (the same
formats as ``photon_tpu/checkpoint/serialization.py``): ``.npz`` with the
arrays under indexed keys ``arr_000000..`` plus a ``__names__`` manifest,
because npz key order is alphabetical and payload order is load-bearing;
small control state (steps, loader positions) as a pickled dict.

A bf16 leaf (its ``np.uint16`` words, metadata dtype ``"bfloat16"``) is
written as the JAX package's ``np.savez`` writes an ``ml_dtypes`` bfloat16
array: an npy member of descr ``'<V2'`` over the same bytes, so each
member equals the JAX package's byte for byte. :func:`npz_to_arrays`
returns such a member as numpy reads it, a ``|V2`` array; loading it into
a bf16 slot raises ``codec.params.Bf16NpzError`` (the JAX package cannot
load it either)."""

from __future__ import annotations

import io
import json
import pickle
import zipfile
from typing import Any

import numpy as np

from photon_tpu_torch.codec.params import BF16, ParamsMetadata

#: the npy descr of ``ml_dtypes.bfloat16``, which ``np.save`` writes
BF16_DESCR = "<V2"


def _write_member(zf: zipfile.ZipFile, key: str, a: np.ndarray, bf16: bool) -> None:
    """One ``{key}.npy`` member, as ``np.savez`` writes it."""
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        if bf16:
            a = np.ascontiguousarray(a)
            np.lib.format.write_array_header_1_0(
                f, {"descr": BF16_DESCR, "fortran_order": False, "shape": a.shape})
            f.write(a.tobytes())
        else:
            np.lib.format.write_array(f, np.asanyarray(a), allow_pickle=False)


def arrays_to_npz(metadata: ParamsMetadata, arrays: list[np.ndarray]) -> bytes:
    metadata.validate_arrays(arrays)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        _write_member(zf, "__names__",
                      np.frombuffer(json.dumps(list(metadata.names)).encode(), np.uint8), False)
        for i, (a, dtype) in enumerate(zip(arrays, metadata.dtypes)):
            _write_member(zf, f"arr_{i:06d}", a, dtype == BF16)
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
