"""The port's native host helpers (``photon_tpu_torch/native``) against
numpy and zlib, JAX's five cases of ``tests/test_native.py``, run on the
library the port builds with g++ from its own source.

Where this host has no C++ compiler the library cannot build; the four
library cases then fail rather than skip (the helpers would silently take
their fallbacks), and the fallback case runs as it does everywhere.
"""

import zlib

import numpy as np
import pytest

from photon_tpu_torch import native
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


@pytest.fixture
def lib():
    assert native.available(), native.build_error
    assert native.library_path().parent == native.BUILD_DIR
    return native.get_lib()


def test_gather_widen_u16(lib):
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 1 << 16, 32, dtype=np.uint16) for _ in range(17)]
    out = np.empty((17, 32), np.int32)
    before = native.calls["gather_rows"]
    native.gather_rows(rows, out)
    assert native.calls["gather_rows"] == before + 1
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(out[i], r.astype(np.int32))


def test_gather_widen_u32(lib):
    rng = np.random.default_rng(1)
    rows = [rng.integers(0, 1 << 18, 16, dtype=np.uint32) for _ in range(5)]
    out = np.empty((5, 16), np.int32)
    native.gather_rows(rows, out)
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(out[i], r.astype(np.int32))


def test_par_memcpy_large(lib):
    rng = np.random.default_rng(2)
    src = rng.integers(0, 255, 40 << 20, dtype=np.uint8)  # crosses the thread threshold
    dst = np.zeros_like(src)
    before = native.calls["parallel_memcpy"]
    native.parallel_memcpy(dst, src)
    assert native.calls["parallel_memcpy"] == before + 1
    np.testing.assert_array_equal(dst, src)
    with pytest.raises(ValueError, match="destination bytes"):
        native.parallel_memcpy(dst[:10], src)


def test_crc32_matches_zlib(lib):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 255, 100_000, dtype=np.uint8).tobytes()
    assert native.crc32(data) == zlib.crc32(data)
    assert native.crc32(data, seed=123) == zlib.crc32(data, 123)
    arr = np.frombuffer(data, np.uint8).reshape(100, 1000)[:, ::2]  # not contiguous
    assert native.crc32(arr) == zlib.crc32(np.ascontiguousarray(arr).tobytes())


def test_fallback_paths_work(monkeypatch):
    """With the library hidden, every helper falls back to numpy/zlib and
    counts no call."""
    monkeypatch.setattr(native, "_LIB", False)
    before = dict(native.calls)
    assert not native.available()
    rows = [np.arange(8, dtype=np.uint16), np.arange(8, 16, dtype=np.uint16)]
    out = np.empty((2, 8), np.int32)
    native.gather_rows(rows, out)
    np.testing.assert_array_equal(out[1], np.arange(8, 16))
    src = np.arange(100, dtype=np.uint8)
    dst = np.zeros_like(src)
    native.parallel_memcpy(dst, src)
    np.testing.assert_array_equal(dst, src)
    assert native.crc32(src.tobytes()) == zlib.crc32(src.tobytes())
    assert native.calls == before


def test_library_is_built_from_the_port_source(lib, tmp_path, monkeypatch):
    """A fresh build directory builds the library again from
    ``native/csrc/photon_native.cpp``; no compiler leaves the fallbacks."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available() and native.library_path().exists()
    assert native.library_path().parent == tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    assert not native.available() and "no C++ compiler" in native.build_error


def test_shm_put_through_native_reads_back_the_numpy_bytes(lib, tmp_path, monkeypatch):
    """A segment larger than one copy chunk, written through the native
    memcpy, holds the bytes the numpy thread-pool path writes."""
    from photon_tpu_torch.codec.params import ParamsMetadata
    from photon_tpu_torch.shm import plane

    monkeypatch.setenv("PHOTON_SHM_DIR", str(tmp_path))
    monkeypatch.setattr(plane, "_COPY_CHUNK", 1 << 20)  # 4 MiB arrays take the parallel copy
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((1024, 1024)).astype(np.float32),
              rng.integers(0, 1 << 16, (3, 5)).astype(np.uint16)]
    meta = ParamsMetadata(("a", "b"), ((1024, 1024), (3, 5)), ("float32", "bfloat16"))
    before = native.calls["parallel_memcpy"]
    plane.write_params("native", meta, arrays)
    assert native.calls["parallel_memcpy"] == before + 1
    monkeypatch.setattr(native, "_LIB", False)
    plane.write_params("numpy", meta, arrays)
    assert native.calls["parallel_memcpy"] == before + 1
    assert (tmp_path / plane._path("native").name).read_bytes() == \
        (tmp_path / plane._path("numpy").name).read_bytes()
    got_meta, got = plane.read_params("native")
    assert got_meta == meta
    assert got[1].dtype == np.uint16  # a bf16 leaf's words, read without ml_dtypes
    for a, b in zip(got, arrays):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
