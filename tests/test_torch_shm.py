"""The port's shared-memory plane (``photon_tpu_torch/shm/plane.py``) against
``tests/test_shm.py``'s cases: the round trip, a rewrite swapping the file
atomically under a reader's mapping, a read before commit, ``wait_for``'s
timeout, segments crossing between the packages (the port keeps JAX's
layout; it has no blob or scalar segments), the cross-process hand-off,
``unlink`` and names, the sweep of a dead writer's temp segment (a live
writer's survives), the transport's start-up sweep, and the thread-pool
copy of a payload over 64 MiB.
"""

import multiprocessing as mp
import os
import subprocess
import uuid

import numpy as np
import pytest

from photon_tpu.codec import ParamsMetadata as JaxMetadata
from photon_tpu.shm import read_params as jax_read_params
from photon_tpu.shm import write_params as jax_write_params
from photon_tpu_torch.codec.params import ParamsMetadata
from photon_tpu_torch.shm.plane import (
    ShmSegment,
    read_params,
    shm_dir,
    sweep_stale_tmp,
    unlink,
    wait_for,
    write_params,
)
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


@pytest.fixture
def name():
    n = f"test-{uuid.uuid4().hex[:8]}"
    yield n
    unlink(n)


def _arrays():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(4, 8)).astype(np.float32),
            rng.integers(0, 100, (3,)).astype(np.int64),
            rng.normal(size=(2, 2, 2)).astype(np.float32)]


def _meta(arrays, cls=ParamsMetadata):
    return cls.from_ndarrays(["a", "b", "c"], arrays)


def test_params_roundtrip(name):
    arrays = _arrays()
    write_params(name, _meta(arrays), arrays)
    meta, back = read_params(name)
    assert meta == _meta(arrays)
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)


def test_rewrite_swaps_atomically_under_a_reader(name):
    """A rewrite renames a new file into place: a mapping opened before it
    keeps the old snapshot, a fresh read sees the new one."""
    arrays = _arrays()
    write_params(name, _meta(arrays), arrays)
    held = ShmSegment(name)
    try:
        before = bytes(held.payload()[: arrays[0].nbytes])
        write_params(name, _meta(arrays), [a * 2 for a in arrays])
        assert bytes(held.payload()[: arrays[0].nbytes]) == before
    finally:
        held.close()
    np.testing.assert_array_equal(read_params(name)[1][0], arrays[0] * 2)


def test_read_before_commit_raises(name):
    seg = ShmSegment(name, size=64, create=True)
    seg.close()
    with pytest.raises(BlockingIOError):
        read_params(name)


def test_wait_for_timeout():
    with pytest.raises(TimeoutError):
        wait_for(f"never-{uuid.uuid4().hex[:6]}", timeout=0.2, poll=0.05)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segments_cross_packages(name, writer):
    arrays = _arrays()
    if writer == "jax":
        jax_write_params(name, _meta(arrays, JaxMetadata), arrays)
        meta, back = read_params(name)
        assert tuple(meta.names) == ("a", "b", "c")
    else:
        write_params(name, _meta(arrays), arrays)
        meta, back = jax_read_params(name, copy=True)
        assert tuple(meta.names) == ("a", "b", "c")
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _child(name: str, q) -> None:
    wait_for(name, timeout=20)
    meta, arrays = read_params(name)
    q.put((tuple(meta.names), [float(a.sum()) for a in arrays]))


def test_cross_process_handoff(name):
    """A writing parent and a child waiting on the segment (spawned)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    child = ctx.Process(target=_child, args=(name, q))
    child.start()
    arrays = _arrays()
    write_params(name, _meta(arrays), arrays)
    names, sums = q.get(timeout=60)
    child.join(timeout=10)
    assert not child.is_alive()
    assert names == ("a", "b", "c")
    np.testing.assert_allclose(sums, [float(a.sum()) for a in arrays], rtol=1e-6)


def test_unlink_and_names(name):
    arrays = _arrays()
    write_params(name, _meta(arrays), arrays)
    path = shm_dir() / f"photon-{name}"
    assert path.exists()
    unlink(name)
    assert not path.exists()
    unlink(name)  # missing_ok
    with pytest.raises(FileNotFoundError):
        unlink(name, missing_ok=False)
    for bad in ("a/b", ".hidden"):
        with pytest.raises(ValueError, match="bad shm name"):
            write_params(bad, _meta(arrays), arrays)


def _dead_pid() -> int:
    proc = subprocess.Popen(["sleep", "0"])
    proc.wait()  # reaped: the pid is dead, not a zombie
    return proc.pid


def test_sweep_stale_tmp_reaps_dead_writers_only():
    """A writer killed mid-write leaks a pid-suffixed temp segment; the
    sweep reaps it when that pid is dead, and leaves a live writer's."""
    tag = uuid.uuid4().hex[:8]
    orphan = shm_dir() / f"photon-{tag}-params.tmp-{_dead_pid()}"
    own = shm_dir() / f"photon-{tag}-own.tmp-{os.getpid()}"
    orphan.write_bytes(b"torn")
    own.write_bytes(b"inflight")
    try:
        assert sweep_stale_tmp() >= 1
        assert not orphan.exists()
        assert own.exists()
    finally:
        orphan.unlink(missing_ok=True)
        own.unlink(missing_ok=True)


def test_transport_startup_sweeps_orphans():
    from photon_tpu_torch.federation.transport import ParamTransport

    orphan = shm_dir() / f"photon-{uuid.uuid4().hex[:8]}.tmp-{_dead_pid()}"
    orphan.write_bytes(b"torn")
    try:
        ParamTransport("shm").cleanup()
        assert not orphan.exists()
    finally:
        orphan.unlink(missing_ok=True)


def test_large_params_threaded_copy(name):
    """A payload over 64 MiB goes through the thread-pool copy."""
    big = [np.arange(20_000_000, dtype=np.float32)]  # 80 MB
    write_params(name, ParamsMetadata.from_ndarrays(["big"], big), big)
    out = read_params(name)[1][0]
    np.testing.assert_array_equal(out[:5], big[0][:5])
    np.testing.assert_array_equal(out[-5:], big[0][-5:])
