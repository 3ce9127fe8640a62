"""The port's host plane against ``tests/test_host_plane.py``: the async
server checkpoint (its barrier, snapshot isolation, a write error at the
barrier, the overlap with the next round) and the fold (an error from the
lookahead, a peak of one chunk, ``agg_decode_time`` without the blocking
fetch). Each case is JAX's, run on the port's ``ServerCheckpointManager``,
``strategy.aggregation`` and ``ServerApp``; the fold's result is also held
to JAX's ``aggregate_inplace`` bit for bit.
"""

import time

import numpy as np
import pytest

from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
from photon_tpu_torch.codec.params import ParamsMetadata
from photon_tpu_torch.strategy.aggregation import _FOLD_CHUNK, _fold_into, aggregate_inplace
from photon_tpu_torch.utils.hostpool import HostPool
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


def _payload(seed, n_layers=7):
    rng = np.random.default_rng(seed)
    shapes = [(129, 65), (513,), (33, 9, 5), (2048,), (7, 7), (1,), (300, 11)][:n_layers]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------

def test_fused_fold_peak_allocation_is_chunk_not_payload():
    """A 16 MiB fp32 array folded into an fp64 accumulator allocates one
    chunk's fp64 temporary at a time, never the payload's 32 MiB."""
    import tracemalloc

    n = 4 << 20
    y = np.full(n, 0.5, np.float32)
    acc = np.ones(n, np.float64)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        _fold_into(acc, y, 0.25, 0.75)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 2 * _FOLD_CHUNK * 8, f"fold transient {peak / 2**20:.1f} MiB"
    np.testing.assert_allclose(acc, 0.25 + 0.5 * 0.75)


def test_agg_decode_time_excludes_blocking_fetch():
    """The decode KPI does not absorb the wait for a client's reply, and
    the fold's bits are JAX's."""
    from photon_tpu.strategy.aggregation import aggregate_inplace as jax_aggregate

    def slow_stream():
        yield _payload(0), 2
        time.sleep(0.25)  # the client still training
        yield _payload(1), 3

    timings: dict = {}
    got, n = aggregate_inplace(slow_stream(), timings=timings)
    assert timings["decode_s"] < 0.2, f"decode_s={timings['decode_s']:.3f}s charged the wait"
    want, n_jax = jax_aggregate(iter([(_payload(0), 2), (_payload(1), 3)]))
    assert n == n_jax == 5
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def test_aggregate_error_propagates_from_lookahead():
    def boom():
        yield _payload(0), 3
        yield _payload(1), 2
        raise RuntimeError("stream died")

    with pytest.raises(RuntimeError, match="stream died"):
        aggregate_inplace(boom(), pool=HostPool(4))
    with pytest.raises(ValueError, match="non-positive"):
        aggregate_inplace(iter([(_payload(0), 5), (_payload(1), 0)]), pool=HostPool(4))


# ---------------------------------------------------------------------------
# async server checkpoints
# ---------------------------------------------------------------------------

class SlowStore(FileStore):
    """A FileStore with a delay on each put and the time each landed."""

    def __init__(self, root, delay=0.15):
        super().__init__(root)
        self.delay = delay
        self.completed: dict[str, float] = {}

    def put(self, key, data):
        time.sleep(self.delay)
        super().put(key, data)
        self.completed[key] = time.monotonic()


def _round_payload(seed=0):
    arrays = _payload(seed, n_layers=3)
    return ParamsMetadata.from_ndarrays([f"l{i}/w" for i in range(len(arrays))], arrays), arrays


def test_async_save_then_load_barrier(tmp_path):
    """A load or a resume never sees a half-landed async round."""
    store = SlowStore(tmp_path, delay=0.1)
    mgr = ServerCheckpointManager(store, "run1")
    meta, params = _round_payload()
    t0 = time.monotonic()
    enqueue_s = mgr.save_round_async(5, meta, params, {"momentum": params}, {"round": 5},
                                     cleanup_keep=(3, ("momentum",)))
    assert enqueue_s < 0.05  # the snapshot and the enqueue are cheap; the puts are not
    assert time.monotonic() - t0 < 0.1
    assert mgr.last_barrier_wait_s < 0.05  # no earlier write to wait for
    m, p, st, server_state = mgr.load_round(5, ("momentum",))
    assert server_state == {"round": 5}
    np.testing.assert_array_equal(p[0], params[0])
    assert mgr.resolve_resume_round(-1, ("momentum",)) == 5
    assert mgr.last_async_write_s > 0.0


def test_async_save_write_error_surfaces_at_barrier(tmp_path):
    class BrokenStore(FileStore):
        def put(self, key, data):
            raise OSError("disk on fire")

    mgr = ServerCheckpointManager(BrokenStore(tmp_path), "run1")
    meta, params = _round_payload()
    mgr.save_round_async(1, meta, params)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait_pending()
    mgr.wait_pending()  # the error is consumed: the manager is usable again


def test_async_snapshot_isolated_from_later_mutation(tmp_path):
    """The snapshot copies the containers one level deep: slots rebound
    after the save do not reach the write."""
    store = SlowStore(tmp_path, delay=0.05)
    mgr = ServerCheckpointManager(store, "run1")
    meta, params = _round_payload()
    momenta = [np.zeros_like(a) for a in params]
    server_state = {"client_states": {0: {"steps": 1}}, "round": 1}
    mgr.save_round_async(1, meta, params, {"momentum": momenta}, server_state)
    momenta[0] = np.full_like(momenta[0], 9.0)
    server_state["client_states"] = {9: {"steps": 9}}
    server_state["round"] = 2
    _, _, st, loaded = mgr.load_round(1, ("momentum",))
    np.testing.assert_array_equal(st["momentum"][0], np.zeros_like(params[0]))
    assert loaded == {"client_states": {0: {"steps": 1}}, "round": 1}


def _fed_app(tmp_path, store, n_rounds=2):
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.federation import InProcessDriver, NodeAgent, ParamTransport, ServerApp

    cfg = Config()
    cfg.run_uuid = "hostplane"
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 32, 2, 2, 16, 64
    m.attn_impl, m.compute_dtype = "xla", "float32"
    cfg.optimizer.name, cfg.optimizer.lr = "adopt", 1e-3
    cfg.scheduler.t_warmup, cfg.scheduler.t_max = 2, 1000
    cfg.train.global_batch_size = cfg.train.device_microbatch_size = 4
    cfg.train.eval_batches = 2
    fl = cfg.fl
    fl.n_total_clients, fl.n_clients_per_round, fl.n_rounds, fl.local_steps = 4, 2, n_rounds, 2
    fl.strategy_name, fl.eval_interval_rounds, fl.sample_seed = "nesterov", 0, 99
    cfg.photon.save_path, cfg.photon.checkpoint = str(tmp_path / "save"), True
    cfg.photon.host_threads = 1
    cfg.dataset.synthetic = True
    cfg.validate()
    driver = InProcessDriver(cfg, lambda nid: NodeAgent(cfg, nid, lambda: ParamTransport("inline"),
                                                        device="cpu"), n_nodes=2)
    return ServerApp(cfg, driver, ParamTransport("inline"),
                     ckpt_mgr=ServerCheckpointManager(store, cfg.run_uuid))


def test_async_checkpoint_overlaps_next_round(tmp_path):
    """Round 2's broadcast fires before round 1's checkpoint write lands,
    and after the run both rounds are whole on disk."""
    store = SlowStore(tmp_path / "ckpt", delay=0.15)
    app = _fed_app(tmp_path, store)
    bcast_at: dict[int, float] = {}
    orig = app.broadcast_parameters

    def timed_broadcast(server_round):
        bcast_at.setdefault(server_round, time.monotonic())
        return orig(server_round)

    app.broadcast_parameters = timed_broadcast
    try:
        app.run()
    finally:
        app.driver.shutdown()
    done_r1 = store.completed[f"{app.cfg.run_uuid}/server/1/state.bin"]
    assert bcast_at[2] < done_r1, (bcast_at[2], done_r1)
    mgr = ServerCheckpointManager(store, app.cfg.run_uuid)
    assert 2 in mgr.valid_rounds(app.strategy.state_keys)
    _, p, _, server_state = mgr.load_round(2, app.strategy.state_keys)
    for a, b in zip(p, app.strategy.current_parameters):
        np.testing.assert_array_equal(a, b)
    assert server_state["server_steps_cumulative"] == app.server_steps_cumulative
