"""The port's runtime invariant detectors
(``photon_tpu_torch/analysis/runtime.py``): one case for each of
``tests/test_analysis.py``'s runtime cases (the lock-order recorder and the
retrace sentinel), plus:

- parity with the JAX package's ``LockOrderRecorder`` and
  ``RetraceSentinel`` on the same scripted acquisitions and compile
  events (edges, cycles, counts, violations and the texts they raise);
- the port's compile feed: a kernel library ``ops/_build.load`` builds or
  loads for the first time is one compile, a second load of it none; on
  the CPU a stand-in library (the C runtime) takes the place of nvcc's;
- the five serving sentinel cases of the JAX suite
  (``test_serve.py``, ``test_serve_prefix.py``, ``test_ragged_attention.py``,
  ``test_speculative.py``, ``test_adapter_serve.py``) against the port's
  engine and scheduler, each also reading that the scheduler's
  ``serve/tick`` steady point fired in the guarded window; a planted load
  in that window is billed to ``serve/tick``;
- the lock-order served fixture (``test_serve.py``'s): an engine and a
  batcher with telemetry and the autopilot on, built and driven under the
  recorder, with no cycle at its teardown;
- the server round loop's ``server/round`` steady point.
"""

import contextlib
import ctypes.util
import threading

import numpy as np
import pytest

from photon_tpu_torch import telemetry
from photon_tpu_torch.analysis import runtime as rt
from photon_tpu_torch.ops import _build
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Tiny models gain nothing from every core; other test files share
    the host's cores with this one's scheduler threads."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


#: set while the module's ``served`` fixture holds its recorder and
#: telemetry plane installed across its cases (they run last)
_SERVED: list = []


@pytest.fixture(autouse=True)
def _clean_detectors():
    yield
    rt.uninstall_retrace_sentinel()
    if not _SERVED:
        rt.uninstall_lock_order()
        telemetry.uninstall()


@pytest.fixture()
def fake_build(monkeypatch):
    """``_build.load`` over an empty cache whose "build" is the C runtime:
    each new source name is one real ``ctypes`` load (one compile)."""
    libc = ctypes.util.find_library("c") or "libc.so.6"
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda source: libc)
    return _build.load


# ---------------------------------------------------------------------------
# lock-order recorder
# ---------------------------------------------------------------------------


def test_lock_order_inversion_detected():
    rec = rt.install_lock_order()
    lock_a = threading.Lock()
    lock_b = threading.Lock()

    def ab():
        with lock_a:
            with lock_b:
                pass

    def ba():
        with lock_b:
            with lock_a:
                pass

    for fn in (ab, ba):
        t = threading.Thread(target=fn, name="inv", daemon=True)
        t.start()
        t.join()
    with pytest.raises(rt.LockOrderViolation, match="inversion"):
        rec.check()


def test_lock_order_consistent_is_green():
    with rt.lock_order_guard() as rec:
        lock_a = threading.Lock()
        lock_b = threading.Lock()
        for _ in range(3):
            with lock_a:
                with lock_b:
                    pass
    assert rec.n_locks >= 2
    assert rt.lock_order_active() is None  # the guard uninstalled


def test_surviving_wrappers_go_quiet_after_uninstall():
    rec = rt.install_lock_order()
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    with lock_a:
        pass
    n_before = rec.n_acquires
    assert n_before >= 1
    rt.uninstall_lock_order()
    with lock_a:  # the wrappers still work, recording is off
        with lock_b:
            pass
    assert rec.n_acquires == n_before
    assert not rec.edges()


def test_lock_order_tracks_condition_protocol():
    rec = rt.install_lock_order()
    cond_default = threading.Condition()  # an RLock inside
    with cond_default:
        cond_default.notify_all()
    cond_lock = threading.Condition(threading.Lock())
    with cond_lock:
        cond_lock.wait(timeout=0.01)
    ev = threading.Event()
    ev.set()
    assert rec.n_locks >= 2
    rec.check()  # no inversion


_SCRIPT = (  # (thread, [lock names in acquisition order]) — c->a closes a loop
    ("t0", ["a", "b"]), ("t1", ["b", "c"]), ("t0", ["a", "c"]), ("t2", ["d", "d"]),
    ("t1", ["c", "a"]), ("t2", ["b", "d"]),
)


def _run_script(mod) -> tuple:
    """The scripted acquisitions under one package's recorder: nested
    acquires in order, each thread's list in a thread of its own, the
    locks' allocation sites renamed to their script names."""
    rec = mod.install_lock_order()
    try:
        locks = {n: threading.RLock() if n == "d" else threading.Lock() for n in "abcd"}
        for name, lk in locks.items():
            lk.site = name

        def nest(names, i=0):
            if i < len(names):
                with locks[names[i]]:
                    nest(names, i + 1)

        for _, names in _SCRIPT:
            t = threading.Thread(target=nest, args=(names,), daemon=True)
            t.start()
            t.join()
        with pytest.raises(AssertionError) as err:
            rec.check()
        return rec.edges(), rec.find_cycle(), rec.n_acquires, type(err.value).__name__, \
            str(err.value).split(" — ")[0]
    finally:
        mod.uninstall_lock_order()


def test_lock_order_recorder_matches_jax():
    from photon_tpu.analysis import runtime as jax_rt

    ours, theirs = _run_script(rt), _run_script(jax_rt)
    assert ours == theirs
    edges, cycle, n_acquires, kind, text = ours
    assert edges == {"a": frozenset("bc"), "b": frozenset("cd"), "c": frozenset("a")}
    assert kind == "LockOrderViolation" and set(cycle) >= {"a", "c"}
    assert n_acquires >= 12 and text.startswith("lock-order inversion (potential deadlock): ")


# ---------------------------------------------------------------------------
# retrace sentinel
# ---------------------------------------------------------------------------


def test_retrace_sentinel_catches_steady_state_compile(fake_build):
    s = rt.install_retrace_sentinel()
    fake_build("a.cu")
    assert s.compiles == 1  # warmup observed
    s.mark_steady()
    fake_build("a.cu")  # already loaded: no compile
    rt.steady_point("tick")
    assert s.violations == []
    fake_build("b.cu")  # a library this process did not hold
    rt.steady_point("tick")
    with pytest.raises(rt.RetraceViolation, match="tick: 1 compile"):
        s.check()


def test_retrace_sentinel_steady_after_points(fake_build):
    s = rt.install_retrace_sentinel()
    s.mark_steady_after(2)
    for src in ("a.cu", "b.cu"):  # two warmup iterations, each compiles
        fake_build(src)
        rt.steady_point("warm")
    assert s.steady
    fake_build("a.cu")  # a steady hit
    rt.steady_point("steady")
    s.check()  # green


def test_retrace_sentinel_warmup_check_does_not_consume_point_budget(fake_build):
    s = rt.install_retrace_sentinel()
    s.mark_steady_after(2)
    fake_build("a.cu")
    rt.steady_point("warm")
    s.check()  # a mid-warmup assertion is not the second point
    assert not s.steady
    fake_build("b.cu")  # the second warmup compile, still legitimate
    rt.steady_point("warm")
    assert s.steady
    fake_build("a.cu")
    rt.steady_point("steady")
    s.check()


def test_disabled_detectors_are_none_checks():
    assert rt.lock_order_active() is None
    assert rt.retrace_active() is None
    assert _build.on_load is None  # the loader's listener: one None check
    rt.steady_point("anything")
    assert threading.Lock.__module__ == "_thread"
    rec = rt.install_lock_order()
    assert threading.Lock == rec._make_lock
    rt.uninstall_lock_order()
    assert threading.Lock.__module__ == "_thread"
    s = rt.install_retrace_sentinel()
    assert _build.on_load == s._on_load
    rt.uninstall_retrace_sentinel()
    assert _build.on_load is None


def test_absorb_compiles_forgives_and_records(fake_build):
    with rt.retrace_guard(steady=True) as s:
        with rt.absorb_compiles("reconfigure"):
            fake_build("a.cu")
            fake_build("b.cu")
        rt.steady_point("round")
    assert s.absorbed == [("reconfigure", 2)] and s.violations == []


_EVENTS = (  # ("c": one compile | "p": a steady point | "s": mark_steady | "k": check
           #  | "a": absorb | "n": mark_steady_after(2), label)
    ("n", ""), ("c", ""), ("p", "warm"), ("k", "mid"), ("c", ""), ("p", "warm"),
    ("c", ""), ("a", "gang"), ("p", "tick"), ("c", ""), ("c", ""), ("p", "tick"),
    ("p", "tick"), ("c", ""), ("k", "end"),
)


def _replay(sentinel, compile_one) -> tuple:
    checks = []
    for op, label in _EVENTS:
        if op == "n":
            sentinel.mark_steady_after(2)
        elif op == "c":
            compile_one()
        elif op == "p":
            sentinel.point(label)
        elif op == "a":
            sentinel.absorb(label)
        elif op == "k":
            try:
                sentinel.check(label)
                checks.append(None)
            except AssertionError as e:
                checks.append((type(e).__name__, str(e)))
    return (sentinel.compiles, sentinel.steady, sentinel.violations, sentinel.absorbed, checks)


def test_retrace_sentinel_matches_jax():
    from photon_tpu.analysis import runtime as jax_rt

    ours, theirs = rt.RetraceSentinel(), jax_rt.RetraceSentinel()
    got = _replay(ours, lambda: ours._on_load("ragged_paged_attention.cu"))
    want = _replay(theirs, lambda: theirs._on_event(jax_rt._COMPILE_EVENT, 0.1))
    assert got == want
    assert got[2] == [("tick", 2), ("end", 1)] and got[3] == [("gang", 1)]
    assert got[4][0] is None and got[4][1][0] == "RetraceViolation"


# ---------------------------------------------------------------------------
# the serving hook sites, against the port's engine
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _guarded():
    """``retrace_guard(steady=True)`` that also records every steady point's
    label, so a case shows the scheduler's hook fired in its window."""
    points: list[str] = []
    with rt.retrace_guard(steady=True) as s:
        real = s.point
        s.point = lambda label: (points.append(label), real(label))[1]
        yield s, points


def _serve_cfg(*, n_slots=2, max_seq=32, max_new=8, prefix=False, budget=2048, spec=False,
               accept_floor=0.3):
    from photon_tpu.config.schema import Config as JaxConfig
    from photon_tpu_torch.config.schema import Config

    jcfg = JaxConfig()
    m = jcfg.model
    m.d_model, m.n_layers, m.n_heads, m.vocab_size = 32, 2, 4, 96
    m.attn_impl, m.compute_dtype, m.max_seq_len = "xla", "float32", max_seq
    s = jcfg.photon.serve
    s.n_slots, s.block_size, s.max_new_tokens = n_slots, 4, max_new
    s.prefix_cache, s.prefill_token_budget = prefix, budget
    s.speculative.enabled, s.speculative.accept_floor = spec, accept_floor
    return Config.from_dict(jcfg.validate().to_dict()).validate("cpu")


def _engine(cfg, seed=4, bank=None):
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.serve.engine import PagedEngine

    params = init_params(cfg.model, seed=seed)
    return params, PagedEngine(cfg, params, device="cpu", adapter_bank=bank)


def _offline_greedy(cfg, params, prompt, n):
    import torch

    from photon_tpu_torch.models.decode import make_cached_generate_fn

    buf = torch.zeros((1, len(prompt) + n), dtype=torch.long)
    buf[0, : len(prompt)] = torch.tensor(prompt)
    toks, _ = make_cached_generate_fn(cfg.model, params).many(
        buf, torch.tensor([len(prompt)]), n)
    return [int(x) for x in toks[0, len(prompt):]]


def _ragged_prompts(rng, n, vocab, lo, hi):
    return [list(map(int, rng.integers(1, vocab, int(rng.integers(lo, hi))))) for _ in range(n)]


def _burst(batcher, rng, shared, profile, vocab):
    reqs = [batcher.submit((shared + list(map(int, rng.integers(1, vocab, n)))) if i % 2
                           else list(map(int, rng.integers(1, vocab, n))), new)
            for i, (n, new) in enumerate(profile)]
    for r in reqs:
        r.result(timeout=180)


@pytest.mark.parametrize("chunked", [False, True], ids=["prefix", "chunked"])
def test_retrace_sentinel_green_with_hits_misses_and_swap(chunked):
    """A warm burst mixing prefix-cache hits and misses, with one live
    hot-swap (and, chunked, a budget of 4 that splits every prompt), loads
    no kernel: ``test_serve_prefix.py``'s and
    ``test_ragged_attention.py``'s sentinel cases."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    budget = 4 if chunked else 2048
    cfg = _serve_cfg(prefix=True, budget=budget)
    params, engine = _engine(cfg)
    batcher = ContinuousBatcher(engine, max_queue=32, prefill_token_budget=budget).start()
    rng = np.random.default_rng(17)
    vocab = cfg.model.vocab_size
    shared = list(map(int, rng.integers(1, vocab, 8)))
    profile = [(1, 2), (6 if chunked else 2, 3), (3, 4), (4, 2), (5, 3), (2, 2)]
    try:
        _burst(batcher, rng, shared, profile, vocab)
        assert batcher.request_swap(dict(params), loaded_round=1).wait(60)
        _burst(batcher, rng, shared, profile, vocab)
        with _guarded() as (sentinel, points):
            _burst(batcher, rng, shared, profile, vocab)
            assert batcher.request_swap(dict(params), loaded_round=2).wait(60)
            _burst(batcher, rng, shared, profile, vocab)
        assert sentinel.violations == [] and "serve/tick" in points
        assert engine.loaded_round == 2 and engine.prefix_cache.tokens_cached > 0
        if chunked:
            assert batcher.chunk_split_prompts > 0
    finally:
        batcher.close()


def test_retrace_sentinel_green_spec_bursts_and_idle_reset():
    """Warm speculative bursts, then a guarded burst, a full-idle reset of
    the live width and a re-warmed burst load nothing (driven
    synchronously through the scheduler's phases, each phase's tick and
    steady point called as the loop calls them)."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _serve_cfg(spec=True, accept_floor=0.0, budget=4)
    _, engine = _engine(cfg)
    batcher = ContinuousBatcher(engine, max_queue=8, prefill_token_budget=4,
                                speculative=cfg.photon.serve.speculative)

    def burst():
        reqs = [batcher.submit([7, 3, 7, 3, 7, 3], 10), batcher.submit([2, 8, 2, 8, 2], 8)]
        while not all(r.finished for r in reqs):
            batcher._admit_phase()
            batcher._step_phase()
            batcher._record_tick()
            rt.steady_point("serve/tick")
        return reqs

    burst()
    burst()
    with _guarded() as (sentinel, points):
        burst()
        assert engine.n_active == 0
        assert engine.attn_stats()["ctx_blocks"] == 1.0  # idle: the width reset
        burst()
    assert sentinel.violations == [] and "serve/tick" in points
    assert batcher._spec.drafted > 0
    batcher.close()


def test_mixed_cohort_serving_never_retraces():
    """Cohort churn (page loads, LRU evictions) after one warm burst loads
    no kernel."""
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from tests.test_torch_adapter_serve import _bank, _cfg, _spec

    _, cfg = _cfg(pool_size=2)
    _, engine = _engine(cfg, bank=_bank(_spec(cfg, init_params(cfg.model, seed=4))))
    batcher = ContinuousBatcher(engine, max_queue=16).start()
    rng = np.random.default_rng(3)
    vocab = cfg.model.vocab_size

    def burst(cohorts):
        reqs = [batcher.submit(list(map(int, rng.integers(1, vocab, int(rng.integers(2, 9))))),
                               int(rng.integers(2, 7)), cohort=c) for c in cohorts]
        for r in reqs:
            r.result(timeout=120)

    try:
        burst(["a", "b", None, "a", "c"])
        with _guarded() as (sentinel, points):
            burst(["c", "a", "b", None, "b", "c"])  # churn: evict and reload
        assert sentinel.violations == [] and "serve/tick" in points
        assert engine.adapter_pool.evictions > 0
    finally:
        batcher.close()


def test_server_round_is_a_steady_point(tmp_path, fake_build):
    """Each federated round ends at the ``server/round`` steady point: with
    the first round as warm-up, a later round that loads a kernel library
    is billed to its boundary."""
    from tests.test_torch_telemetry import make_app
    from tests.test_torch_tcp import make_cfg

    cfg = make_cfg(tmp_path, n_rounds=3, local_steps=1)
    app = make_app(cfg)
    s = rt.install_retrace_sentinel()
    s.mark_steady_after(1)
    real = app._one_round

    def one_round(c, rnd):
        real(c, rnd)
        if rnd == 3:
            fake_build("round3.cu")

    app._one_round = one_round
    app.run()
    assert s.steady and s.violations == [("server/round", 1)]


# ---------------------------------------------------------------------------
# the lock-order served fixture (its cases run last: it holds its planes)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """An engine and a running batcher, with telemetry and the autopilot on
    (so the autopilot's tick, its knobs and the hub ride every tick), all
    built and driven under the lock-order recorder: the teardown fails on
    any acquisition-order cycle the cases below produced — between the
    scheduler loop, the submitters, the autopilot and the telemetry plane."""
    from photon_tpu_torch.config.schema import TelemetryConfig
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    recorder = rt.install_lock_order()
    _SERVED.append(recorder)
    tel = TelemetryConfig(enabled=True)
    tel.autopilot.enabled, tel.autopilot.period_s = True, 0.01
    telemetry.install(tel, scope="serve")
    try:
        cfg = _serve_cfg()
        params, engine = _engine(cfg)
        batcher = ContinuousBatcher(engine, max_queue=64).start()
        yield cfg, params, engine, batcher
        batcher.close()
        assert recorder.n_acquires > 0
        recorder.check()  # green: no lock-order inversion anywhere above
    finally:
        _SERVED.clear()
        rt.uninstall_lock_order()
        telemetry.uninstall()


def test_steady_state_serving_never_retraces(served):
    cfg, params, engine, batcher = served
    rng = np.random.default_rng(21)
    prompts = _ragged_prompts(rng, 6, cfg.model.vocab_size, 2, 12)
    budgets = [int(rng.integers(1, 8)) for _ in prompts]
    for r in [batcher.submit(p, n) for p, n in zip(prompts, budgets)]:
        r.result(timeout=120)  # warm, unguarded
    with _guarded() as (sentinel, points):
        outs = [r.result(timeout=120)
                for r in [batcher.submit(p, n) for p, n in zip(prompts, budgets)]]
    assert sentinel.violations == [] and "serve/tick" in points
    batcher.set_prefill_token_budget(3)  # chunked prefill: multi-chunk mixed steps
    try:
        for r in [batcher.submit(p, n) for p, n in zip(prompts, budgets)]:
            r.result(timeout=120)
        with _guarded() as (sentinel, points):
            for r in [batcher.submit(p, n) for p, n in zip(prompts, budgets)]:
                r.result(timeout=120)
        assert sentinel.violations == [] and "serve/tick" in points
        assert batcher.chunk_split_prompts > 0
    finally:
        batcher.set_prefill_token_budget(2048)
    for p, out in zip(prompts, outs):
        assert out == _offline_greedy(cfg, params, p, len(out))
    assert engine.n_active == 0 and engine.free_blocks == engine.n_blocks


def test_planted_load_is_billed_to_the_serve_tick(served, monkeypatch):
    """A kernel library loaded for the first time inside a guarded window
    (a forced fresh ``_build.load``) is billed to the next ``serve/tick``
    and fails the guard."""
    libc = ctypes.util.find_library("c") or "libc.so.6"
    monkeypatch.setattr(_build, "build", lambda source: libc)
    monkeypatch.setattr(_build, "_loaded", {})
    _, _, _, batcher = served
    with pytest.raises(rt.RetraceViolation, match=r"serve/tick: 1 compile\(s\)"):
        with rt.retrace_guard(steady=True) as sentinel:
            _build.load("planted.cu")
            batcher.submit([5, 9, 2], 2).result(timeout=60)
    assert sentinel.violations[0] == ("serve/tick", 1)


def test_concurrent_submitters_and_autopilot_ticks_cross_no_lock_order(served):
    """Four submitting threads against the running scheduler, whose every
    tick runs the autopilot's evaluation and takes the hub's locks: the
    module fixture's recorder checks the acquisition graph at teardown."""
    cfg, _, _, batcher = served
    ap = telemetry.autopilot_active()
    errors = []

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for p in _ragged_prompts(rng, 3, cfg.model.vocab_size, 2, 10):
                batcher.submit(p, 3).result(timeout=120)
                ap.statusz()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors
    assert "serve" in ap._last_eval  # the scheduler's tick reached the autopilot
    rt.lock_order_active().check()
