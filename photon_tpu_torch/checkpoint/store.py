"""Filesystem object store: atomic put, get, list, copy and delete.

The port's copy of ``photon_tpu/checkpoint/store.py:FileStore``: keys are
``/``-separated paths under a root directory; writes go to a temp file
that is renamed into place, so a reader polling ``exists`` never sees a
torn object. Durable writes (the default) fsync the file before the
rename and the directory after it; transient ones (the transport's
per-round payloads) skip the flushes.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import time


class FileStore:
    def __init__(self, root: str | pathlib.Path) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> pathlib.Path:
        p = (self.root / key).resolve()
        if not str(p).startswith(str(self.root.resolve())):
            raise ValueError(f"key escapes store root: {key!r}")
        return p

    def put(self, key: str, data: bytes, durable: bool = True) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.parent / f".{p.name}.tmp-{os.getpid()}"
        if not durable:
            tmp.write_bytes(data)
            os.rename(tmp, p)
            return
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, p)
        try:
            dirfd = os.open(p.parent, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
        except OSError:
            return  # no directory opens here: the rename is still atomic
        try:
            os.fsync(dirfd)
        except OSError:
            pass  # directory fsync unsupported (some network mounts)
        finally:
            os.close(dirfd)

    def get(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def delete(self, key: str) -> None:
        """Remove an object, or every object under a prefix."""
        p = self._path(key)
        if p.is_file():
            p.unlink()
        elif p.is_dir():
            shutil.rmtree(p)

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

    def copy(self, src_key: str, dst_key: str) -> None:
        self.put(dst_key, self.get(src_key))

    def wait_for(self, key: str, timeout: float = 120.0, poll: float = 0.1) -> None:
        """Poll until ``key`` exists."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.exists(key):
                return
            time.sleep(poll)
        raise TimeoutError(f"object {key!r} not visible after {timeout}s")

    def list(self, prefix: str) -> list[str]:
        base = self._path(prefix) if prefix else self.root
        if not base.exists():
            return []
        found = base.rglob("*") if base.is_dir() else [base]
        root = self.root.resolve()
        return sorted(
            str(p.resolve().relative_to(root))
            for p in found
            # in-flight atomic-write temp files are not objects yet
            if p.is_file() and not (p.name.startswith(".") and ".tmp-" in p.name)
        )
