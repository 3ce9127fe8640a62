"""Named shared-memory plane: parameter hand-off between processes on one
host without copying through the control messages.

The port of ``photon_tpu/shm/plane.py``, with the same segment layout, so
a segment written by either package reads in the other:
``[16B header][metadata JSON][payload bytes]``; the header is magic
``0x50484F54`` ("PHOT"), version, metadata length and a commit flag, all
``u32``. A segment is a plain file in :func:`shm_dir` (``/dev/shm``, or
``$PHOTON_SHM_DIR`` when set: a small ``/dev/shm`` cannot hold full-width
payloads) mapped with ``mmap``. A writer fills a pid-suffixed temp file,
sets the commit flag last and renames it into place, so a reader only ever
maps a complete segment. A large copy goes through the native
multi-threaded memcpy (``photon_tpu_torch.native``) where its library
builds, as the JAX package's does, and otherwise fans out over a thread
pool (numpy releases the GIL on memcpy).
"""

from __future__ import annotations

import mmap
import os
import pathlib
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from photon_tpu_torch import native
from photon_tpu_torch.codec.params import ParamsMetadata, host_dtype

_MAGIC = 0x50484F54  # "PHOT"
_VERSION = 1
_HEADER = struct.Struct("<IIII")
_COPY_CHUNK = 64 << 20  # 64 MiB per copy task
_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def shm_dir() -> pathlib.Path:
    """Where segments live: ``$PHOTON_SHM_DIR``, else ``/dev/shm``."""
    return pathlib.Path(os.environ.get("PHOTON_SHM_DIR", "/dev/shm"))


def _path(name: str) -> pathlib.Path:
    if "/" in name or name.startswith("."):
        raise ValueError(f"bad shm name {name!r}")
    return shm_dir() / f"photon-{name}"


def _copy_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                       thread_name_prefix="photon-shm")
        return _pool


class ShmSegment:
    """A mapped segment; the module-level helpers do one-shot IO."""

    def __init__(self, name: str, size: int | None = None, create: bool = False,
                 path: pathlib.Path | None = None) -> None:
        self.name = name
        p = path if path is not None else _path(name)
        if create:
            if size is None:
                raise ValueError("size required to create")
            fd = os.open(p, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, _HEADER.size + size)
                self.mm = mmap.mmap(fd, _HEADER.size + size)
            finally:
                os.close(fd)
            self.mm[: _HEADER.size] = _HEADER.pack(_MAGIC, _VERSION, 0, 0)
        else:
            fd = os.open(p, os.O_RDWR)
            try:
                self.mm = mmap.mmap(fd, os.fstat(fd).st_size)
            finally:
                os.close(fd)
            magic, version, _, _ = _HEADER.unpack_from(self.mm, 0)
            if magic != _MAGIC or version != _VERSION:
                self.mm.close()
                raise ValueError(f"segment {name!r} has bad header")

    @property
    def committed(self) -> bool:
        return _HEADER.unpack_from(self.mm, 0)[3] == 1

    def commit(self, meta_len: int) -> None:
        self.mm[: _HEADER.size] = _HEADER.pack(_MAGIC, _VERSION, meta_len, 1)

    @property
    def meta_len(self) -> int:
        return _HEADER.unpack_from(self.mm, 0)[2]

    def payload(self) -> memoryview:
        return memoryview(self.mm)[_HEADER.size + self.meta_len:]

    def body(self) -> memoryview:
        return memoryview(self.mm)[_HEADER.size:]

    def close(self) -> None:
        self.mm.close()


def _parallel_copy(dst: memoryview, src: memoryview) -> None:
    n = len(src)
    if n <= _COPY_CHUNK:
        dst[:n] = src
        return
    if native.available():
        native.parallel_memcpy(dst[:n], src)
        return
    _pool_copy(dst, src)


def _pool_copy(dst: memoryview, src: memoryview) -> None:
    """The copy without the native library: ``_COPY_CHUNK`` pieces on the
    copy pool's threads."""
    n = len(src)
    d = np.frombuffer(dst, np.uint8, count=n)
    s = np.frombuffer(src, np.uint8, count=n)
    pool = _copy_pool()
    futures = [pool.submit(np.copyto, d[off: off + _COPY_CHUNK], s[off: off + _COPY_CHUNK])
               for off in range(0, n, _COPY_CHUNK)]
    for f in futures:
        f.result()


def write_params(name: str, metadata: ParamsMetadata, arrays: list[np.ndarray]) -> None:
    """Write the flat array list into the named segment and commit it."""
    metadata.validate_arrays(arrays)
    meta_bytes = metadata.to_json().encode()
    final = _path(name)
    tmp = final.parent / (final.name + f".tmp-{os.getpid()}")
    seg = ShmSegment(name, size=len(meta_bytes) + metadata.total_bytes, create=True, path=tmp)
    try:
        body = seg.body()
        try:
            body[: len(meta_bytes)] = meta_bytes
            off = len(meta_bytes)
            for a in arrays:
                a = np.ascontiguousarray(a)
                chunk = body[off: off + a.nbytes]
                try:
                    _parallel_copy(chunk, memoryview(a.reshape(-1).view(np.uint8)))
                finally:
                    chunk.release()
                off += a.nbytes
        finally:
            body.release()
        seg.commit(len(meta_bytes))
    except BaseException:
        seg.close()
        tmp.unlink(missing_ok=True)
        raise
    seg.close()
    os.rename(tmp, final)


def read_params(name: str) -> tuple[ParamsMetadata, list[np.ndarray]]:
    """(metadata, arrays) of a committed segment, copied out of it (the
    writer unlinks the segment once the round is done with it)."""
    seg = ShmSegment(name)
    try:
        if not seg.committed:
            raise BlockingIOError(f"segment {name!r} not committed yet")
        meta = ParamsMetadata.from_json(bytes(seg.body()[: seg.meta_len]).decode())
        payload = seg.payload()
        arrays: list[np.ndarray] = []
        off = 0
        for shape, dtype, nbytes in zip(meta.shapes, meta.dtypes, meta.nbytes_each):
            view = np.frombuffer(payload, dtype=host_dtype(dtype),
                                 count=int(np.prod(shape, dtype=np.int64)), offset=off)
            arrays.append(view.reshape(shape).copy())
            del view
            off += nbytes
        payload.release()
    finally:
        seg.close()
    return meta, arrays


def wait_for(name: str, timeout: float = 60.0, poll: float = 0.01) -> None:
    """Block until the segment exists and is committed."""
    deadline = time.monotonic() + timeout
    path = _path(name)
    while time.monotonic() < deadline:
        if path.exists():
            try:
                seg = ShmSegment(name)
                ok = seg.committed
                seg.close()
                if ok:
                    return
            except (ValueError, OSError):
                pass
        time.sleep(poll)
    raise TimeoutError(f"shm segment {name!r} not ready after {timeout}s")


def unlink(name: str, missing_ok: bool = True) -> None:
    try:
        _path(name).unlink()
    except FileNotFoundError:
        if not missing_ok:
            raise


def sweep_stale_tmp() -> int:
    """Unlink ``photon-*.tmp-<pid>`` temp segments whose writer is dead (a
    writer killed mid-write would otherwise pin its pages forever)."""
    n = 0
    for p in shm_dir().glob("photon-*.tmp-*"):
        pid_s = p.name.rpartition(".tmp-")[2]
        if not pid_s.isdigit():
            continue
        pid = int(pid_s)
        if pid == os.getpid():
            continue  # our own in-flight write
        try:
            os.kill(pid, 0)
            continue  # writer still alive
        except ProcessLookupError:
            pass
        except PermissionError:
            continue  # pid exists under another uid
        try:
            p.unlink()
            n += 1
        except OSError:
            pass
    return n
