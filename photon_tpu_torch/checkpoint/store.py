"""Object stores for checkpoints and the bulk parameter plane (the port's
copy of ``photon_tpu/checkpoint/store.py``, without its chaos hooks).

- :class:`ObjectStore`: the contract every backend keeps. Keys are
  ``/``-separated paths; a put is atomic (a reader polling ``exists``
  never sees a torn object); ``list`` matches whole path components.
- :class:`FileStore`: a directory (single host, NFS or a mounted bucket).
  Writes go to a temp file renamed into place; durable writes (the
  default) fsync the file before the rename and the directory after it,
  transient ones (the transport's per-round payloads) skip the flushes.
- :class:`S3Store`: a bucket through a boto3 S3 client. The client is
  injected (the contract tests pass an in-memory fake); without one,
  boto3 is imported when the store is made and refused when absent.
- :func:`make_store`: ``s3://bucket/prefix`` or a path.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import time


class ObjectStore:
    """Key → bytes. Keys are ``/``-separated paths."""

    def put(self, key: str, data: bytes, durable: bool = True) -> None:
        """Atomic write. ``durable=False`` may skip the crash-durability
        work (fsync) for transient objects."""
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove an object, or every object under a prefix."""
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        raise NotImplementedError

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


class FileStore(ObjectStore):
    """Filesystem-backed store with atomic writes."""

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


class S3Store(ObjectStore):
    """A bucket (and key prefix) as an object store. ``client`` is any
    object with the boto3 S3 client's ``put_object``/``get_object``/
    ``head_object``/``delete_object``/``copy_object`` and
    ``get_paginator("list_objects_v2")``."""

    def __init__(self, bucket: str, prefix: str = "", client=None) -> None:
        if client is None:
            try:
                import boto3  # noqa: PLC0415 — optional, only for a real bucket
            except ImportError as e:
                raise NotImplementedError(
                    "s3:// backend requires boto3, which is unavailable here; "
                    "mount the bucket and use a file path instead"
                ) from e
            client = boto3.client("s3")
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.client = client

    def _key(self, key: str) -> str:
        key = key.strip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def put(self, key: str, data: bytes, durable: bool = True) -> None:
        del durable  # an S3 PUT is atomic and durable when it returns
        self.client.put_object(Bucket=self.bucket, Key=self._key(key), Body=data)

    def get(self, key: str) -> bytes:
        return self.client.get_object(Bucket=self.bucket, Key=self._key(key))["Body"].read()

    def exists(self, key: str) -> bool:
        try:
            self.client.head_object(Bucket=self.bucket, Key=self._key(key))
            return True
        except Exception as e:  # noqa: BLE001 — botocore's ClientError, unimported
            code = getattr(e, "response", {}).get("Error", {}).get("Code", "")
            if code in ("404", "NoSuchKey", "NotFound"):
                return False
            raise

    def delete(self, key: str) -> None:
        # the object itself and any "directory" under it, as FileStore
        self.client.delete_object(Bucket=self.bucket, Key=self._key(key))
        for sub in self.list(key):
            self.client.delete_object(Bucket=self.bucket, Key=self._key(sub))

    def list(self, prefix: str) -> list[str]:
        # the store prefix ends in "/" so a sibling "<prefix>-old/x" stays out
        base = f"{self.prefix}/" if self.prefix else ""
        full = self._key(prefix) if prefix else base
        out = []
        for page in self.client.get_paginator("list_objects_v2").paginate(
                Bucket=self.bucket, Prefix=full):
            for item in page.get("Contents", []):
                k = item["Key"]
                rel = k[len(base):] if base and k.startswith(base) else k
                # whole path components, as FileStore: "a/b" never lists "a/bc"
                if not prefix or rel == prefix or rel.startswith(prefix.strip("/") + "/"):
                    out.append(rel)
        return sorted(out)

    def copy(self, src_key: str, dst_key: str) -> None:
        self.client.copy_object(Bucket=self.bucket, Key=self._key(dst_key),
                                CopySource={"Bucket": self.bucket, "Key": self._key(src_key)})


def make_store(uri: str) -> ObjectStore:
    """``/path`` or ``file:///path`` → :class:`FileStore`;
    ``s3://bucket/prefix`` → :class:`S3Store` (needs boto3)."""
    if uri.startswith("file://"):
        return FileStore(uri[len("file://"):])
    if uri.startswith("s3://"):
        bucket, _, prefix = uri[len("s3://"):].partition("/")
        if not bucket:
            raise ValueError(f"bad s3 uri {uri!r}")
        return S3Store(bucket, prefix)
    return FileStore(uri)
