"""Live checkpoint hot-swap in the port (``photon_tpu_torch.serve.hotswap``,
``PagedEngine.set_params``, the scheduler's swap point,
``ServerCheckpointManager.latest_complete_round``).

All CPU, fp32, a tiny mpt (d 32, 2 layers, vocab 96, block 4):

1. against the JAX package: ``latest_complete_round`` gives JAX's answer
   on a store the JAX package wrote, a torn round included, reading no
   object;
2. port against port, one case for each case of ``tests/test_hotswap.py``
   (its telemetry case is in ``tests/test_torch_observatory.py``), the watcher
   driven through ``poll_once``: the swap, a corrupt round skipped once,
   the drain fence, the health gate (blocking on ``failing``, open on an
   unreachable or malformed answer), a failed apply releasing its waiter
   (and, when it failed after the old params were released, the engine
   marked failed until the watcher's retry succeeds),
   in-flight requests finishing on the old params with the prefix cache
   flushed, zero requests dropped across a live swap, ``/healthz``; and
   the CLI (``python -m photon_tpu_torch.serve``) tracking a new round.
"""

import http.client
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
import torch

from photon_tpu.config.schema import Config as JaxConfig
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_cfg(*, prefix_cache=True, n_slots=2, max_new=8) -> JaxConfig:
    cfg = JaxConfig()
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.vocab_size = 32, 2, 4, 96
    m.attn_impl, m.compute_dtype, m.max_seq_len = "xla", "float32", 32
    s = cfg.photon.serve
    s.n_slots, s.block_size, s.max_new_tokens, s.prefix_cache = n_slots, 4, max_new, prefix_cache
    cfg.run_uuid = "hs"
    return cfg.validate()


def _cfg(**kw):
    from photon_tpu_torch.config.schema import Config

    return Config.from_dict(_jax_cfg(**kw).to_dict()).validate("cpu")


def _save_round(mgr, cfg, rnd, seed):
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models.mpt import init_params

    params = init_params(cfg.model, seed=seed)
    mgr.save_round(rnd, *params_to_ndarrays(params), server_state={"server_round": rnd})
    return params


def _offline_greedy(cfg, params, prompt, n):
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    buf = torch.zeros((1, len(prompt) + n), dtype=torch.long)
    buf[0, : len(prompt)] = torch.tensor(prompt)
    toks, _ = make_cached_generate_fn(cfg.model, params).many(
        buf, torch.tensor([len(prompt)]), n)
    return [int(x) for x in toks[0, len(prompt):]]


def _watcher(batcher, mgr, cfg, **kw):
    from photon_tpu_torch.serve.hotswap import CheckpointWatcher

    return CheckpointWatcher(batcher, mgr, cfg, **kw)


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("GET", path)
    return json.loads(c.getresponse().read())


def _statusz_server(body: bytes):
    """A stand-in for the training run's /statusz, answering ``body()``."""

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):  # noqa: N802 — http.server API
            data = body()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=httpd.serve_forever, name="test-statusz", daemon=True)
    t.start()
    return httpd, t, f"http://127.0.0.1:{httpd.server_address[1]}/statusz"


# ---------------------------------------------------------------------------
# 1. latest_complete_round
# ---------------------------------------------------------------------------

def test_latest_complete_round_matches_jax_on_jax_store(tmp_path):
    from photon_tpu.checkpoint import FileStore as JaxStore
    from photon_tpu.checkpoint.server import MANIFEST_FILE
    from photon_tpu.checkpoint.server import ServerCheckpointManager as JaxManager
    from photon_tpu.codec import params_to_ndarrays
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    jcfg = _jax_cfg()
    jmgr = JaxManager(JaxStore(tmp_path), "hs")
    store = FileStore(tmp_path)
    assert ServerCheckpointManager(store, "hs").latest_complete_round() is None
    for rnd in (1, 2, 3):
        jmgr.save_round(rnd, *params_to_ndarrays(init_params(jcfg.model, seed=rnd)),
                        server_state={"server_round": rnd})
    (tmp_path / f"hs/server/3/{MANIFEST_FILE}").unlink()  # round 3 torn
    reads = []
    orig = store.get
    store.get = lambda k: (reads.append(k), orig(k))[1]
    got = ServerCheckpointManager(store, "hs").latest_complete_round()
    assert got == JaxManager(JaxStore(tmp_path), "hs").latest_complete_round() == 2
    assert reads == []  # presence only


def test_latest_complete_round_is_presence_only_and_skips_torn(tmp_path):
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.checkpoint.server import MANIFEST_FILE

    cfg = _cfg()
    store = FileStore(tmp_path)
    mgr = ServerCheckpointManager(store, "hs")
    for rnd in (1, 2, 3):
        _save_round(mgr, cfg, rnd, seed=rnd)
    store.delete(f"hs/server/3/{MANIFEST_FILE}")
    reads = []
    orig = store.get
    store.get = lambda k: (reads.append(k), orig(k))[1]
    assert ServerCheckpointManager(store, "hs").latest_complete_round() == 2
    assert reads == []


# ---------------------------------------------------------------------------
# 2. the watcher and the swap point
# ---------------------------------------------------------------------------

@pytest.fixture()
def served(tmp_path):
    """A round-1 checkpoint served by a live batcher (prefix cache on)."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _cfg()
    store = FileStore(tmp_path)
    mgr = ServerCheckpointManager(store, "hs")
    params1 = _save_round(mgr, cfg, 1, seed=1)
    engine = PagedEngine.from_checkpoint(cfg, store=store, resume_round=-1, device="cpu")
    batcher = ContinuousBatcher(engine, max_queue=16).start()
    yield cfg, store, mgr, params1, engine, batcher
    batcher.close()


def test_watcher_swaps_to_new_round(served):
    cfg, store, mgr, params1, engine, batcher = served
    w = _watcher(batcher, mgr, cfg, poll_s=0.05)
    assert w.poll_once() == "idle"
    prompt = [5, 9, 2, 7]
    assert batcher.submit(prompt, 4).result(timeout=60) == _offline_greedy(cfg, params1, prompt, 4)
    params2 = _save_round(mgr, cfg, 2, seed=2)
    assert w.poll_once() == "swapped"
    assert engine.loaded_round == 2 and batcher.swaps == 1 and w.swaps_applied == 1
    assert batcher.submit(prompt, 4).result(timeout=60) == _offline_greedy(cfg, params2, prompt, 4)
    assert w.poll_once() == "idle"


def test_watcher_skips_corrupt_candidate_and_keeps_serving(served):
    """Round 2's params object has one byte flipped: skipped with one
    warning and counted once, the old round keeps serving, and a later
    clean round still swaps."""
    cfg, store, mgr, params1, engine, batcher = served
    w = _watcher(batcher, mgr, cfg, poll_s=0.05)
    _save_round(mgr, cfg, 2, seed=2)
    key = "hs/server/2/current_server_parameters.npz"
    data = bytearray(store.get(key))
    data[len(data) // 2] ^= 0x01
    store.put(key, bytes(data))
    with pytest.warns(UserWarning, match="skipping candidate round 2"):
        assert w.poll_once() == "skipped-corrupt"
    assert w.rejected_corrupt == 1 and engine.loaded_round == 1
    prompt = [3, 1, 4, 1]
    assert batcher.submit(prompt, 4).result(timeout=60) == _offline_greedy(cfg, params1, prompt, 4)
    assert w.poll_once() == "skipped-corrupt"
    assert w.rejected_corrupt == 1  # once per round, not per poll
    params3 = _save_round(mgr, cfg, 3, seed=3)
    assert w.poll_once() == "swapped" and engine.loaded_round == 3
    assert batcher.submit(prompt, 4).result(timeout=60) == _offline_greedy(cfg, params3, prompt, 4)


def test_watcher_refuses_during_drain(served):
    cfg, store, mgr, params1, engine, batcher = served
    w = _watcher(batcher, mgr, cfg, poll_s=0.05)
    _save_round(mgr, cfg, 2, seed=2)
    assert batcher.drain(5.0) is True
    assert w.poll_once() == "skipped-draining"
    assert engine.loaded_round == 1 and w.swaps_applied == 0
    with pytest.raises(Exception, match="draining"):
        batcher.request_swap({}, loaded_round=2)


def test_watcher_health_gate_blocks_failing_federation(served):
    cfg, store, mgr, params1, engine, batcher = served
    state = {"status": "failing"}
    httpd, t, url = _statusz_server(lambda: json.dumps(
        {"status": state["status"], "planes": {"federation": {"status": state["status"]}}}
    ).encode())
    try:
        w = _watcher(batcher, mgr, cfg, poll_s=0.05, statusz_url=url)
        _save_round(mgr, cfg, 2, seed=2)
        with pytest.warns(UserWarning, match="federation-failing"):
            assert w.poll_once() == "skipped-health"
        assert engine.loaded_round == 1
        state["status"] = "ok"
        assert w.poll_once() == "swapped" and engine.loaded_round == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)
    w2 = _watcher(batcher, mgr, cfg, poll_s=0.05, statusz_url=url)  # unreachable: open
    _save_round(mgr, cfg, 3, seed=3)
    assert w2.poll_once() == "swapped" and engine.loaded_round == 3


def test_watcher_health_gate_fails_open_on_non_dict_json(served):
    cfg, store, mgr, params1, engine, batcher = served
    answers = iter([b"[1, 2, 3]\n", b'{"planes": [1]}', b"not json"])
    httpd, t, url = _statusz_server(lambda: next(answers))
    try:
        w = _watcher(batcher, mgr, cfg, poll_s=0.05, statusz_url=url)
        for rnd in (2, 3, 4):
            _save_round(mgr, cfg, rnd, seed=rnd)
            assert w.poll_once() == "swapped" and engine.loaded_round == rnd
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)


def test_failed_swap_apply_releases_waiter_and_keeps_serving(served):
    """A ``set_params`` that raises before it touches the params (as its
    refusal with a slot active does) releases the waiter, and the old
    round keeps serving."""
    cfg, store, mgr, params1, engine, batcher = served
    real = engine.set_params
    engine.set_params = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("injected swap failure"))
    try:
        done = batcher.request_swap(dict(params1), loaded_round=99)
        assert done.wait(30)
        assert engine.loaded_round == 1 and batcher.swaps == 0
    finally:
        engine.set_params = real
    prompt = [4, 4, 2, 1]
    assert batcher.submit(prompt, 3).result(timeout=60) == _offline_greedy(cfg, params1, prompt, 3)


def test_failed_param_conversion_marks_engine_failed_until_next_swap(served, monkeypatch):
    """``compute_params`` raises inside the real ``set_params`` (as an
    out-of-memory on the card would), after the old tensors were released:
    the engine is marked failed, ``/healthz`` answers 503 ``failed``, a
    queued request fails and a new one is refused with 503, and the
    watcher's retry of the same round brings serving back."""
    from photon_tpu_torch.serve import engine as engine_mod
    from photon_tpu_torch.serve.frontend import ServeFrontend
    from photon_tpu_torch.serve.scheduler import EngineFailedError

    cfg, store, mgr, params1, engine, batcher = served
    real = engine_mod.compute_params

    def oom(*a, **k):
        raise RuntimeError("injected out of memory")

    fe = ServeFrontend(batcher, max_new_tokens_cap=8)
    fe.watcher = w = _watcher(batcher, mgr, cfg, poll_s=0.05)
    port = fe.start()
    gate = threading.Event()
    real_step = engine.mixed_step

    def slow_step(*a, **k):  # hold each step until the swap is staged
        gate.wait(10)
        return real_step(*a, **k)

    try:
        params2 = _save_round(mgr, cfg, 2, seed=2)
        monkeypatch.setattr(engine_mod, "compute_params", oom)
        engine.mixed_step = slow_step
        running = batcher.submit([5, 9, 2, 7], 3)
        deadline = time.monotonic() + 30
        while engine.n_active == 0 and time.monotonic() < deadline:
            time.sleep(0.002)
        done = batcher.request_swap(params2, loaded_round=2)
        queued = batcher.submit([1, 2, 3], 2)  # waits: admission is paused
        gate.set()
        assert running.result(timeout=60) == _offline_greedy(cfg, params1, [5, 9, 2, 7], 3)
        assert done.wait(30)
        with pytest.raises(RuntimeError, match="injected out of memory"):
            queued.result(timeout=30)
        assert engine.failed and "injected out of memory" in engine.failed
        assert engine.params is None and engine.loaded_round == 1 and batcher.swaps == 0
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c.request("GET", "/healthz")
        r = c.getresponse()
        h = json.loads(r.read())
        assert r.status == 503 and h["status"] == "failed" and "out of memory" in h["error"]
        c.request("POST", "/generate", body=json.dumps({"tokens": [1, 2], "max_new_tokens": 2}))
        r = c.getresponse()
        assert r.status == 503 and "out of memory" in json.loads(r.read())["error"]
        with pytest.raises(EngineFailedError):
            batcher.submit([1, 2, 3], 2)
        with pytest.raises(RuntimeError, match="swap to round 2 failed"):
            real_step(None)
        monkeypatch.setattr(engine_mod, "compute_params", real)
        assert w.poll_once() == "swapped"  # the watcher retries the round
        assert engine.failed is None and engine.loaded_round == 2 and batcher.swaps == 1
        assert _get(port, "/healthz")["status"] == "ok"
        prompt = [4, 4, 2, 1]
        assert batcher.submit(prompt, 3).result(timeout=60) == _offline_greedy(
            cfg, params2, prompt, 3)
    finally:
        gate.set()
        engine.mixed_step = real_step
        fe.close()


def test_inflight_finish_on_old_params_and_cache_flushes(served):
    """A swap staged mid-generation: the running request's whole output is
    the old round's, the swap applies after it, the prefix cache is
    flushed, and a set_params with a slot active is refused."""
    cfg, store, mgr, params1, engine, batcher = served
    warm = [5, 9, 2, 7, 1, 8]
    batcher.submit(warm, 2).result(timeout=60)
    assert len(engine.prefix_cache) > 0
    params2 = _save_round(mgr, cfg, 2, seed=2)
    gate = threading.Event()
    real_step = engine.mixed_step

    def slow_step(*a, **k):  # hold each step until the swap is staged
        gate.wait(10)
        return real_step(*a, **k)

    engine.mixed_step = slow_step
    try:
        req = batcher.submit(warm + [4], 8)
        deadline = time.monotonic() + 30
        while engine.n_active == 0 and time.monotonic() < deadline:
            time.sleep(0.002)
        assert engine.n_active > 0
        with pytest.raises(RuntimeError, match="active slots"):
            engine.set_params(params2, loaded_round=2)
        done = batcher.request_swap(params2, loaded_round=2)
        assert batcher.swap_pending
        gate.set()
        assert req.result(timeout=60) == _offline_greedy(cfg, params1, warm + [4], 8)
    finally:
        engine.mixed_step = real_step
    assert done.wait(30)
    assert engine.loaded_round == 2 and len(engine.prefix_cache) == 0
    assert engine.free_blocks == engine.n_blocks
    assert batcher.submit(warm, 4).result(timeout=60) == _offline_greedy(cfg, params2, warm, 4)


def test_zero_dropped_requests_across_live_swap(served):
    """HTTP traffic across a watcher-driven swap: every reply is a 200
    whose tokens are the old or the new round's, and the server ends on
    the new round."""
    from photon_tpu_torch.serve.frontend import ServeFrontend

    cfg, store, mgr, params1, engine, batcher = served
    fe = ServeFrontend(batcher, max_new_tokens_cap=8)
    port = fe.start()
    w = _watcher(batcher, mgr, cfg, poll_s=0.02)
    prompt = [5, 9, 2, 7]
    results, lock = [], threading.Lock()

    def client():
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        for _ in range(6):
            c.request("POST", "/generate", json.dumps({"tokens": prompt, "max_new_tokens": 6}))
            r = c.getresponse()
            body = json.loads(r.read())
            with lock:
                results.append((r.status, body))
        c.close()

    try:
        threads = [threading.Thread(target=client, name=f"hs-client-{i}", daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        while not results:
            time.sleep(0.005)
        params2 = _save_round(mgr, cfg, 2, seed=2)
        w.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        w.close()
        fe.close()
    want = (_offline_greedy(cfg, params1, prompt, 6), _offline_greedy(cfg, params2, prompt, 6))
    assert len(results) == 18 and all(s == 200 for s, _ in results)
    assert all(body["tokens"] in want for _, body in results)
    assert engine.loaded_round == 2 and batcher.swaps == 1 and w.swaps_applied == 1
    assert any(body["tokens"] == want[1] for _, body in results)


def test_healthz_reports_hotswap_and_prefix(served):
    from photon_tpu_torch.serve.frontend import ServeFrontend

    cfg, store, mgr, params1, engine, batcher = served
    fe = ServeFrontend(batcher, max_new_tokens_cap=8)
    fe.watcher = _watcher(batcher, mgr, cfg, poll_s=0.05)
    port = fe.start()
    try:
        batcher.submit([5, 9, 2], 2).result(timeout=60)
        h = _get(port, "/healthz")
        assert h["round"] == 1 and h["swaps"] == 0
        assert h["prefix_cache"]["entries"] == len(engine.prefix_cache)
        assert h["hotswap"]["last_outcome"] == "idle"
        assert "speculative" not in h  # off in this config
    finally:
        fe.close()


def test_serve_cli_tracks_new_round(tmp_path):
    """``python -m photon_tpu_torch.serve`` with hot-swap, the prefix cache
    and speculative decoding on: the startup line says so, a round saved
    while it runs is swapped in, and SIGTERM closes it cleanly."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    cfg = _cfg()
    sc = cfg.photon.serve
    sc.enabled, sc.hotswap, sc.hotswap_poll_s = True, True, 0.1
    sc.speculative.enabled = True
    cfg.to_yaml(tmp_path / "resolved.yaml")
    mgr = ServerCheckpointManager(FileStore(tmp_path / "store"), "hs")
    _save_round(mgr, cfg, 1, seed=1)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.serve", "--config",
         str(tmp_path / "resolved.yaml"), "--store", str(tmp_path / "store"), "--port", "0",
         "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline())
        assert info["round"] == 1 and info["prefix_cache"] and info["hotswap"]
        port = info["port"]
        params2 = _save_round(mgr, cfg, 2, seed=2)
        deadline = time.monotonic() + 60
        # the watcher counts its swap when it wakes after the scheduler has
        # applied it (within its 0.2 s wait), so both are polled for
        while time.monotonic() < deadline:
            h = _get(port, "/healthz")
            if h["round"] == 2 and h["hotswap"]["swaps_applied"] == 1:
                break
            time.sleep(0.05)
        h = _get(port, "/healthz")
        assert h["round"] == 2 and h["swaps"] == 1 and h["hotswap"]["swaps_applied"] == 1
        assert h["speculative"]["k"] == 4
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("POST", "/generate", json.dumps({"tokens": [5, 9, 2, 7], "max_new_tokens": 6}))
        assert json.loads(c.getresponse().read())["tokens"] == \
            _offline_greedy(cfg, params2, [5, 9, 2, 7], 6)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
