"""Filesystem object store: atomic put, get, list and delete.

The port's copy of ``photon_tpu/checkpoint/store.py:FileStore``: keys are
``/``-separated paths under a root directory; writes go to a temp file
that is fsynced and renamed into place, so a reader polling ``exists``
never sees a torn object.
"""

from __future__ import annotations

import os
import pathlib
import shutil


class FileStore:
    def __init__(self, root: str | pathlib.Path) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> pathlib.Path:
        p = (self.root / key).resolve()
        if not str(p).startswith(str(self.root.resolve())):
            raise ValueError(f"key escapes store root: {key!r}")
        return p

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.parent / f".{p.name}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, p)

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
