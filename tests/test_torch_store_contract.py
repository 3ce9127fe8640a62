"""The port's object stores (``photon_tpu_torch.checkpoint.store``) against
the contract the JAX package's backends keep (``tests/test_store_contract.py``,
one case for each of its cases): atomic visibility, path-component prefix
listing, ``wait_for`` polling, idempotent deletes. Every contract case runs
on ``FileStore`` and on ``S3Store`` over the JAX suite's in-memory fake of
the boto3 client (boto3 is absent here); an object written by either
package's ``FileStore`` reads in the other's, and ``make_store`` refuses
``s3://`` without boto3 with the JAX package's text.
"""

import threading
import time

import pytest

from photon_tpu.checkpoint.store import FileStore as JaxFileStore
from photon_tpu.checkpoint.store import make_store as jax_make_store
from photon_tpu_torch.checkpoint.store import FileStore, ObjectStore, S3Store, make_store
from tests.test_store_contract import FakeS3Client
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


@pytest.fixture(params=["file", "s3"])
def store(request, tmp_path) -> ObjectStore:
    if request.param == "file":
        return FileStore(tmp_path / "store")
    return S3Store("bucket", prefix="runs/test", client=FakeS3Client())


def test_put_get_roundtrip_and_overwrite(store):
    store.put("a/b/blob.bin", b"v1")
    assert store.get("a/b/blob.bin") == b"v1"
    store.put("a/b/blob.bin", b"v2-longer")
    assert store.get("a/b/blob.bin") == b"v2-longer"


def test_exists_lifecycle(store):
    assert not store.exists("x")
    store.put("x", b"1")
    assert store.exists("x")
    store.delete("x")
    assert not store.exists("x")


def test_delete_is_idempotent(store):
    store.delete("never/existed")


def test_delete_directory_like(store):
    store.put("run/1/a", b"1")
    store.put("run/1/b", b"2")
    store.put("run/2/a", b"3")
    store.delete("run/1")
    assert store.list("run") == ["run/2/a"]


def test_list_prefix_is_path_component_based(store):
    """``a/b`` must not match the sibling ``a/bc``."""
    store.put("a/b/one", b"1")
    store.put("a/b/two", b"2")
    store.put("a/bc/three", b"3")
    assert store.list("a/b") == ["a/b/one", "a/b/two"]
    assert store.list("a") == ["a/b/one", "a/b/two", "a/bc/three"]
    assert store.list("missing") == []


def test_list_many_pages(store):
    keys = [f"p/{i:03d}" for i in range(10)]
    for k in keys:
        store.put(k, b"x")
    assert store.list("p") == keys  # the fake pages at 3: 4 pages


def test_copy(store):
    store.put("src", b"payload")
    store.copy("src", "deep/dst")
    assert store.get("deep/dst") == b"payload"
    assert store.get("src") == b"payload"


def test_wait_for_sees_concurrent_writer(store):
    t = threading.Timer(0.15, lambda: store.put("late", b"here"))
    t.start()
    store.wait_for("late", timeout=5.0, poll=0.01)
    assert store.get("late") == b"here"
    t.join(timeout=5)


def test_wait_for_times_out(store):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        store.wait_for("never", timeout=0.2, poll=0.02)
    assert time.monotonic() - t0 < 2.0


def test_get_missing_raises(store):
    with pytest.raises(Exception):
        store.get("missing-key")


# -- backend-specific ------------------------------------------------------


def test_filestore_tmp_files_invisible(tmp_path):
    fs = FileStore(tmp_path / "s")
    (fs.root / ".blob.tmp-999").write_bytes(b"partial")
    assert fs.list("") == []
    assert not fs.exists("blob")


def test_filestore_rejects_escaping_keys(tmp_path):
    fs = FileStore(tmp_path / "s")
    with pytest.raises(ValueError):
        fs.put("../outside", b"x")


def test_s3store_prefix_isolation():
    client = FakeS3Client()
    a = S3Store("b", prefix="run-a", client=client)
    b = S3Store("b", prefix="run-b", client=client)
    a.put("k", b"A")
    b.put("k", b"B")
    assert a.get("k") == b"A" and b.get("k") == b"B"
    assert a.list("") == ["k"]


def test_make_store_dispatch(tmp_path):
    assert isinstance(make_store(str(tmp_path / "x")), FileStore)
    assert isinstance(make_store(f"file://{tmp_path}/y"), FileStore)
    try:
        import boto3  # noqa: F401

        assert isinstance(make_store("s3://bucket/prefix"), S3Store)
    except ImportError:
        with pytest.raises(NotImplementedError, match="boto3") as port_err:
            make_store("s3://bucket/prefix")
        with pytest.raises(NotImplementedError) as jax_err:
            jax_make_store("s3://bucket/prefix")
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError):
        make_store("s3://")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_filestore_objects_cross_packages(tmp_path, writer):
    """The same keys and bytes in the same layout: either package's
    ``FileStore`` reads and lists what the other wrote."""
    w, r = (JaxFileStore, FileStore) if writer == "jax" else (FileStore, JaxFileStore)
    src, dst = w(tmp_path / "s"), r(tmp_path / "s")
    src.put("run/1/params.npz", b"\x00\x01params")
    src.put("run/1/momentum.npz", b"m", durable=False)
    assert dst.list("run") == ["run/1/momentum.npz", "run/1/params.npz"]
    assert dst.get("run/1/params.npz") == b"\x00\x01params"
