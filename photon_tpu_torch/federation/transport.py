"""Bulk-tensor transport plane: write payloads behind pointers and
resolve :class:`ParamPointer`s (the port of
``photon_tpu/federation/transport.py``).

- ``shm``      named segments on one host (``photon_tpu_torch/shm``);
- ``objstore`` the checkpoint object store (file / NFS / mounted bucket);
- ``inline``   arrays inside the message (tests, tiny models only).

Segments and store objects use the JAX package's formats, so a payload
written by either package reads in the other. The wire codec is not
ported (``photon.compression`` is refused at ``validate()``): a pointer
that carries a codec header raises. Bytes moved are counted in
:attr:`ParamTransport.stats`.
"""

from __future__ import annotations

import json

import numpy as np

from photon_tpu_torch.checkpoint.serialization import arrays_to_npz, npz_to_arrays
from photon_tpu_torch.checkpoint.store import FileStore
from photon_tpu_torch.codec.params import ParamsMetadata
from photon_tpu_torch.federation.messages import ParamPointer
from photon_tpu_torch.shm import plane as shm
from photon_tpu_torch.utils.profiling import WireStats

#: how long a reader waits for a payload to appear
_WAIT_S = 120.0


class ParamTransport:
    """Writer and reader of parameter payloads behind pointers."""

    def __init__(self, mode: str = "shm", store: FileStore | None = None) -> None:
        if mode not in ("shm", "objstore", "inline"):
            raise ValueError(f"unknown transport mode {mode!r}")
        if mode == "objstore" and store is None:
            raise ValueError("objstore transport needs a store")
        self.mode = mode
        self.store = store
        if mode == "shm":
            # reap temp segments a killed writer left behind
            shm.sweep_stale_tmp()
        self.stats = WireStats()
        self._owned: list[str] = []  # segments / objects this transport wrote

    # -- write -----------------------------------------------------------
    def put(self, tag: str, metadata: ParamsMetadata, arrays: list[np.ndarray]) -> ParamPointer:
        """Write a payload and return its pointer."""
        self.stats.record_sent(metadata.total_bytes, metadata.total_bytes)
        if self.mode == "shm":
            shm.write_params(tag, metadata, arrays)
            self._owned.append(tag)
            return ParamPointer("shm", tag, metadata.to_json())
        if self.mode == "objstore":
            assert self.store is not None
            key = f"transport/{tag}.npz"
            # transient: deleted at round end, so no fsync on the hot path
            self.store.put(key, arrays_to_npz(metadata, arrays), durable=False)
            self._owned.append(key)
            return ParamPointer("objstore", key, metadata.to_json())
        metadata.validate_arrays(arrays)
        return ParamPointer("inline", "", metadata.to_json(),
                            inline=[np.asarray(a) for a in arrays])

    # -- read ------------------------------------------------------------
    def get(self, ptr: ParamPointer) -> tuple[ParamsMetadata, list[np.ndarray]]:
        """Resolve a pointer to ``(metadata, arrays)``, copied out of the
        segment or object (the writer frees it after the round)."""
        meta_d = json.loads(ptr.metadata_json)
        if meta_d.get("codec") is not None:
            raise NotImplementedError(
                f"pointer {ptr.locator!r} carries a {meta_d['codec'].get('policy')} payload; "
                "the wire codec is not ported to photon_tpu_torch"
            )
        metadata = ParamsMetadata.from_dict(meta_d)
        self.stats.record_recv(metadata.total_bytes, metadata.total_bytes)
        if ptr.kind == "shm":
            shm.wait_for(ptr.locator, timeout=_WAIT_S)
            got, arrays = shm.read_params(ptr.locator)
        elif ptr.kind == "objstore":
            assert self.store is not None, "objstore pointer but transport has no store"
            self.store.wait_for(ptr.locator, timeout=_WAIT_S)
            got, arrays = npz_to_arrays(self.store.get(ptr.locator))
        elif ptr.kind == "inline":
            got, arrays = metadata, [np.asarray(a) for a in ptr.inline or []]
        else:
            raise ValueError(f"unknown pointer kind {ptr.kind!r}")
        metadata.validate_arrays(arrays)
        return got, arrays

    # -- lifecycle -------------------------------------------------------
    def free(self, ptr: ParamPointer) -> None:
        """Release the payload behind a pointer."""
        if ptr.kind == "shm":
            shm.unlink(ptr.locator)
        elif ptr.kind == "objstore" and self.store is not None:
            self.store.delete(ptr.locator)

    def cleanup(self) -> None:
        for name in self._owned:
            if self.mode == "shm":
                shm.unlink(name)
            elif self.mode == "objstore" and self.store is not None:
                self.store.delete(name)
        self._owned.clear()
