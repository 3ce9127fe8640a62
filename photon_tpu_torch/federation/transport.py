"""Bulk-tensor transport plane: write payloads behind pointers and
resolve :class:`ParamPointer`s (the port of
``photon_tpu/federation/transport.py``).

- ``shm``      named segments on one host (``photon_tpu_torch/shm``);
- ``objstore`` the checkpoint object store (file / NFS / a bucket);
- ``inline``   arrays inside the message (tests, tiny models only).

Segments and store objects use the JAX package's formats, so a payload
written by either package reads in the other. With a ``compression``
policy, :meth:`ParamTransport.put` can encode a payload through the wire
codec (``photon_tpu_torch/compression``): the compressed bytes ride the
same planes as one uint8 blob, and the pointer's ``metadata_json`` keeps
the original names, shapes and dtypes and gains a ``codec`` header. Raw
and wire bytes moved, both directions, are counted in
:attr:`ParamTransport.stats`.
"""

from __future__ import annotations

import json

import numpy as np

from photon_tpu_torch.checkpoint.serialization import arrays_to_npz, npz_to_arrays
from photon_tpu_torch.checkpoint.store import ObjectStore
from photon_tpu_torch.codec.params import ParamsMetadata
from photon_tpu_torch.compression import CompressedPayload, make_codec
from photon_tpu_torch.federation.messages import ParamPointer
from photon_tpu_torch.shm import plane as shm
from photon_tpu_torch.utils.hostpool import HostPool
from photon_tpu_torch.utils.profiling import WireStats

#: how long a reader waits for a payload to appear
_WAIT_S = 120.0
#: the layer name of a serialized CompressedPayload on the planes (model
#: paths are "/"-joined keys, so it never collides; the JAX package's name)
_BLOB_NAME = "__pcmp_blob__"


def _blob_metadata(nbytes: int) -> ParamsMetadata:
    return ParamsMetadata(names=(_BLOB_NAME,), shapes=((nbytes,),), dtypes=("uint8",))


class ParamTransport:
    """Writer and reader of parameter payloads behind pointers.
    ``compression`` is a ``CompressionConfig``, a policy string or a
    :class:`~photon_tpu_torch.compression.Codec` (None or ``off``: no
    codec); ``host_threads`` sizes the pool the codec's per-layer work
    runs on (the server swaps in its own pool)."""

    def __init__(self, mode: str = "shm", store: ObjectStore | None = None,
                 compression=None, host_threads: int = 1) -> None:
        if mode not in ("shm", "objstore", "inline"):
            raise ValueError(f"unknown transport mode {mode!r}")
        if mode == "objstore" and store is None:
            raise ValueError("objstore transport needs a store")
        self.mode = mode
        self.store = store
        if mode == "shm":
            # reap temp segments a killed writer left behind
            shm.sweep_stale_tmp()
        self.codec = make_codec(compression)
        self.stats = WireStats()
        self.host_pool = HostPool(host_threads)
        self._owned: list[str] = []  # segments / objects this transport wrote

    def set_reference(self, arrays: list[np.ndarray] | None) -> None:
        """Pin the round's global params as the codec's delta base (no-op
        without a codec)."""
        if self.codec is not None:
            self.codec.set_reference(arrays)

    # -- write -----------------------------------------------------------
    def put(self, tag: str, metadata: ParamsMetadata, arrays: list[np.ndarray],
            compress: bool = False, key=None) -> ParamPointer:
        """Write a payload and return its pointer. ``compress=True`` goes
        through the codec when there is one (raw otherwise); ``key`` names
        the error-feedback residual stream (the client id)."""
        if compress and self.codec is not None:
            payload = self.codec.encode(metadata, arrays, key=key, pool=self.host_pool)
            blob = np.frombuffer(payload.to_bytes(), dtype=np.uint8)
            self.stats.record_sent(metadata.total_bytes, blob.nbytes)
            meta_d = json.loads(metadata.to_json())
            meta_d["codec"] = {"policy": payload.policy, "version": payload.version,
                               "wire_nbytes": int(blob.nbytes)}
            ptr = self._put_raw(tag, _blob_metadata(blob.nbytes), [blob])
            return ParamPointer(ptr.kind, ptr.locator, json.dumps(meta_d), inline=ptr.inline)
        self.stats.record_sent(metadata.total_bytes, metadata.total_bytes)
        return self._put_raw(tag, metadata, arrays)

    def _put_raw(self, tag: str, metadata: ParamsMetadata,
                 arrays: list[np.ndarray]) -> ParamPointer:
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
    def get(self, ptr: ParamPointer, decode: bool = True
            ) -> tuple[ParamsMetadata, list[np.ndarray] | CompressedPayload]:
        """Resolve a pointer to ``(metadata, arrays)``, copied out of the
        segment or object (the writer frees it after the round). For a
        compressed pointer, ``decode=False`` returns ``(metadata,
        CompressedPayload)``: the server's fold decodes one client at a
        time."""
        meta_d = json.loads(ptr.metadata_json)
        metadata = ParamsMetadata.from_dict(meta_d)
        codec_info = meta_d.get("codec")
        if codec_info is None:
            self.stats.record_recv(metadata.total_bytes, metadata.total_bytes)
            return self._get_raw(ptr, metadata)
        _, (blob,) = self._get_raw(ptr, _blob_metadata(int(codec_info["wire_nbytes"])))
        payload = CompressedPayload.from_bytes(bytes(blob))
        self.stats.record_recv(metadata.total_bytes, payload.wire_nbytes)
        if not decode:
            return metadata, payload
        if self.codec is None:
            raise RuntimeError(
                f"pointer {ptr.locator!r} carries a {codec_info['policy']} payload but this "
                "transport has no codec — construct it with the run's CompressionConfig"
            )
        arrays = self.codec.decode(payload, pool=self.host_pool)
        metadata.validate_arrays(arrays)
        return metadata, arrays

    def _get_raw(self, ptr: ParamPointer, metadata: ParamsMetadata
                 ) -> tuple[ParamsMetadata, list[np.ndarray]]:
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
        self.host_pool.close()  # reusable: the next submit rebuilds it
