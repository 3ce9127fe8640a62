"""The adapter plane's serving side in the port
(``photon_tpu_torch.serve.adapter_pool``, the engine's per-slot gather,
the scheduler's and the frontend's ``cohort``, the hot-swap of base and
bank together, the cohort-keyed prefix cache).

All CPU, fp32, tiny configs (d 32, 2 layers, block 4, 3 cohorts on a pool
of 2 pages), one case for each case of ``tests/test_adapter_serve.py``:

1. the pool's refcounts and LRU, and ``install_bank``'s checks;
2. a mixed-cohort batch (slots on ``a``, ``b`` and none) against the
   contiguous oracle (``models/decode.prefill`` / ``decode_step`` with
   per-row adapters) within ``LOGIT_ATOL``, and against the JAX engine on
   the same weights, for mpt-wpe, mpt-alibi and llama-gqa; the no-cohort
   slot equal to an adapter-free engine's; a recycled page's logits;
3. the scheduler's and HTTP's cohort plumbing (400 for an unknown cohort,
   the pool on ``/healthz``);
4. in place of the JAX package's retrace sentinel: cohort churn (loads,
   evictions, pages reused) allocates no new pool page;
5. adapter training → checkpoint → resume → hot-swap into the serving
   batcher with zero dropped requests, the streams after the swap equal
   to the new round's oracle (the port's host adapter round in place of
   the JAX package's collective runner);
6. where the packages part: the port's prefix cache is keyed by cohort,
   so cohort ``b`` after ``a`` on one prompt equals a cold ``b``; the JAX
   engine maps ``a``'s blocks for ``b`` and reads a difference.
"""

import http.client
import json
import time

import numpy as np
import pytest
import torch

from tests.test_adapter_serve import _drive as jax_drive
from tests.test_adapter_serve import _serve_cfg
from tests.test_adapter_serve import _spy_engine as jax_spy_engine
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

#: fp32 on both sides; one computation per side, orders of sums differ
LOGIT_ATOL = 1e-5
KINDS = ["mpt-wpe", "mpt-alibi", "llama-gqa"]


def _cfg(kind="mpt-wpe", *, prefix=False, **kw):
    """(JAX config, the port's config) of one tiny adapter server."""
    from photon_tpu_torch.config.schema import Config

    jcfg = _serve_cfg(alibi=kind == "mpt-alibi", llama=kind == "llama-gqa", **kw)
    jcfg.photon.serve.prefix_cache = prefix
    return jcfg, Config.from_dict(jcfg.to_dict()).validate("cpu")


def _plain(cfg):
    """``cfg`` with the adapters off."""
    import copy

    cfg = copy.deepcopy(cfg)
    cfg.photon.adapters.enabled = False
    return cfg


def _weights(jcfg, seed=4):
    """(JAX params, port params) holding the same numbers."""
    from photon_tpu.codec import params_to_ndarrays
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.codec.params import params_from_numpy
    from photon_tpu_torch.config.schema import Config

    jp = init_params(jcfg.model, seed=seed)
    meta, arrays = params_to_ndarrays(jp)
    return jp, params_from_numpy(meta.names, arrays, Config.from_dict(jcfg.to_dict()).model)


def _spec(cfg, params):
    from photon_tpu_torch.adapters.lora import spec_from_params

    ad = cfg.photon.adapters
    return spec_from_params(params, ad.rank, ad.alpha, tuple(ad.targets))


def _nonzero_adapter(spec, seed):
    """A trained-looking adapter (B non-zero: a fresh identity adapter would
    make every comparison vacuous); the JAX test's recipe."""
    from photon_tpu_torch.adapters.lora import init_adapter_arrays

    am, aa = init_adapter_arrays(spec, seed)
    rng = np.random.default_rng(seed + 1000)
    return [a if n.endswith("_lora_a") else rng.normal(0, 0.05, a.shape).astype(np.float32)
            for n, a in zip(am.names, aa)]


def _bank(spec, cohorts=("a", "b", "c")):
    return {c: _nonzero_adapter(spec, i + 1) for i, c in enumerate(cohorts)}


def _engine(cfg, params, bank=None):
    from photon_tpu_torch.serve.engine import PagedEngine

    return PagedEngine(cfg, params, device="cpu", adapter_bank=bank)


def _drive(engine, prompts, cohorts, gen, slots=None):
    """Admit, prefill each prompt as one chunk, then decode ``gen - 1``
    steps; returns each slot's emission logits (the JAX test's ``_drive``,
    reading the port engine's ``last_logits``)."""
    slots = list(range(len(prompts))) if slots is None else slots
    for s, p, c in zip(slots, prompts, cohorts):
        engine.begin(s, p, gen, cohort=c)
    out = {s: [] for s in slots}
    while engine._pending:
        slot = min(engine._pending)
        _, em = engine.mixed_step((slot, engine.pending_tokens(slot)), include_decode=False)
        if em[slot]:
            out[slot].append(engine.last_logits[slot].numpy().copy())
    for _ in range(gen - 1):
        engine.step()
        for s in slots:
            out[s].append(engine.last_logits[s].numpy().copy())
    return out


def _oracle(cfg, params, prompts, rows, spec, gen):
    """Contiguous base + per-row adapter logits: a batched prefill, then
    greedy decode steps (``models/decode.py``)."""
    from photon_tpu_torch.adapters.lora import adapter_tree, stack_adapter_trees
    from photon_tpu_torch.models.decode import decode_step, prefill

    adapters = stack_adapter_trees([adapter_tree(spec, r) for r in rows])
    toks = torch.zeros((len(prompts), max(map(len, prompts)) + gen + 1), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = torch.tensor(p)
    lg, st = prefill(params, toks, torch.tensor([len(p) for p in prompts]), cfg.model,
                     adapters=adapters, lora_scale=spec.scale)
    out = [lg.numpy().copy()]
    for _ in range(gen - 1):
        lg, st = decode_step(params, st, torch.argmax(lg, -1), cfg.model, adapters=adapters,
                             lora_scale=spec.scale)
        out.append(lg.numpy().copy())
    return out


def _zeros(spec):
    from photon_tpu_torch.adapters.lora import adapter_metadata

    return [np.zeros(s, np.float32) for s in adapter_metadata(spec).shapes]


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, n))) for n in lengths]


# ---------------------------------------------------------------------------
# 1. the pool
# ---------------------------------------------------------------------------

def _pool(pool_size=2, n_cohorts=3):
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.serve.adapter_pool import AdapterPool

    _, cfg = _cfg(pool_size=pool_size)
    spec = _spec(cfg, init_params(cfg.model, seed=4))
    pool = AdapterPool(spec, pool_size)
    bank = _bank(spec, "abcdefg"[:n_cohorts])
    pool.install_bank(bank)
    return pool, bank, spec


def test_pool_refcounts_and_lru_recycling():
    from photon_tpu_torch.serve.cache import BlockLeakError

    pool, bank, _ = _pool(pool_size=2, n_cohorts=3)
    assert pool.cohorts() == ["a", "b", "c"]
    pa, pb = pool.acquire("a"), pool.acquire("b")  # two loads: the pool is full
    assert pool.loads == 2 and pool.allocator.free_blocks == 0
    assert not pool.can_acquire("c")  # both pages pinned
    with pytest.raises(RuntimeError, match="every page is pinned"):
        pool.acquire("c")
    pool.release(pa)  # a stays resident (the index's reference)
    assert pool.can_acquire("c")
    pa2 = pool.acquire("a")
    assert pa2 == pa and pool.hits == 1
    pool.release(pa2)
    pc = pool.acquire("c")  # evicts a, the unpinned least recently used
    assert pc == pa and pool.evictions == 1
    # the page holds c's factors whole, B with alpha/r folded in
    for name, leaf, arr in zip(pool._names, pool._leaves, bank["c"]):
        scale = pool.spec.scale if name.endswith("_lora_b") else 1.0
        np.testing.assert_array_equal(leaf[pc].numpy(), arr * np.float32(scale))
    assert pool.acquire("b") == pb and pool.hits == 2  # pinned throughout
    pool.release(pb)
    pool.release(pb)
    pool.release(pc)
    with pytest.raises(KeyError):
        pool.acquire("zzz")
    with pytest.raises(BlockLeakError):
        pool.release(pc)  # the slot's pin was dropped already
    assert not np.any(torch.stack([leaf[pool.trash_page].abs().sum()
                                   for leaf in pool._leaves]).numpy())


def test_pool_install_bank_validates_and_flushes():
    pool, bank, _ = _pool(pool_size=2, n_cohorts=2)
    pool.release(pool.acquire("a"))
    assert pool.stats()["residents"] == 1.0
    with pytest.raises(ValueError, match="arrays"):
        pool.install_bank({n: a[:-1] for n, a in bank.items()})
    with pytest.raises(ValueError, match="shape"):
        pool.install_bank({"a": [a[..., :1] for a in bank["a"]]})
    pool.install_bank(bank)  # a new bank drops every resident page
    assert pool.stats()["residents"] == 0.0 and pool.allocator.free_blocks == 2


def test_set_params_refuses_a_bad_bank_before_the_swap():
    """A swap whose bank does not fit the pool's spec raises before the old
    base is released: the engine keeps serving the old base, bank and
    round together (factors are never applied to a base they were not
    trained against), and a later good swap lands both."""
    jcfg, cfg = _cfg()
    _, tp = _weights(jcfg)
    _, tp2 = _weights(jcfg, seed=5)
    bank = _bank(_spec(cfg, tp))
    engine = _engine(cfg, tp, bank)
    engine.loaded_round = 1
    prompt = _prompts(0, [7], 96)
    want = _drive(engine, prompt, ["a"], 3)
    engine.evict(0)
    params = engine.params
    with pytest.raises(ValueError, match="shape"):
        engine.set_params(tp2, loaded_round=2,
                          adapter_bank={c: [a[..., :1] for a in arrs] for c, arrs in bank.items()})
    assert engine.params is params and engine.failed is None and engine.loaded_round == 1
    assert engine.adapter_pool.cohorts() == ["a", "b", "c"]
    got = _drive(engine, prompt, ["a"], 3)
    engine.evict(0)
    assert all(np.array_equal(x, y) for x, y in zip(got[0], want[0]))
    engine.set_params(tp2, loaded_round=2, adapter_bank={"a": bank["b"]})
    assert engine.loaded_round == 2 and engine.adapter_pool.cohorts() == ["a"]


# ---------------------------------------------------------------------------
# 2. mixed-cohort serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_mixed_cohort_serving_matches_contiguous_oracle(kind):
    """Slot 0 decodes cohort a, slot 1 cohort b, slot 2 the bare base, in
    one mixed batch: every emission's logits within ``LOGIT_ATOL`` of the
    contiguous oracle and of the JAX engine on the same weights; slot 2's
    equal to an adapter-free engine's."""
    jcfg, cfg = _cfg(kind)
    jp, tp = _weights(jcfg)
    spec = _spec(cfg, tp)
    bank = _bank(spec)
    prompts = _prompts(7, (5, 7, 3), cfg.model.vocab_size)
    cohorts, gen = ["a", "b", None], 5
    engine = _engine(cfg, tp, bank)
    got = _drive(engine, prompts, cohorts, gen)
    want = _oracle(cfg, tp, prompts, [bank["a"], bank["b"], _zeros(spec)], spec, gen)
    jax_got = jax_drive(jax_spy_engine(jcfg, jp, bank), prompts, cohorts, gen)
    for s in range(3):
        for i in range(gen):
            np.testing.assert_allclose(got[s][i], want[i][s], atol=LOGIT_ATOL, rtol=0,
                                       err_msg=f"slot {s} emission {i} ({kind})")
            np.testing.assert_allclose(got[s][i], jax_got[s][i], atol=LOGIT_ATOL, rtol=0,
                                       err_msg=f"slot {s} emission {i} vs JAX ({kind})")
    base = _drive(_engine(_plain(cfg), tp), prompts, [None] * 3, gen)
    for i in range(gen):
        np.testing.assert_array_equal(got[2][i], base[2][i])
    assert float(np.abs(got[0][0] - base[0][0]).max()) > 1e-3  # the adapter moves a's
    for s in range(3):
        engine.evict(s)
    assert engine.adapter_pool.allocator.held_blocks <= 2  # the index's references only


def test_parity_survives_adapter_page_recycling():
    """A one-page pool: serving c recycles a's page, and c's logits equal
    its oracle (the load overwrites the whole page)."""
    jcfg, cfg = _cfg(pool_size=1, n_slots=1)
    _, tp = _weights(jcfg)
    spec = _spec(cfg, tp)
    bank = _bank(spec)
    prompt = _prompts(9, (6,), cfg.model.vocab_size)[0]
    gen = 4
    engine = _engine(cfg, tp, bank)
    got_a = _drive(engine, [prompt], ["a"], gen)
    engine.evict(0)
    pool = engine.adapter_pool
    page_a = pool._pages["a"]
    got_c = _drive(engine, [prompt], ["c"], gen)
    assert pool._pages["c"] == page_a and pool.evictions == 1
    engine.evict(0)
    for cohort, got in (("a", got_a), ("c", got_c)):
        want = _oracle(cfg, tp, [prompt], [bank[cohort]], spec, gen)
        for i in range(gen):
            np.testing.assert_allclose(got[0][i], want[i][0], atol=LOGIT_ATOL, rtol=0,
                                       err_msg=f"cohort {cohort} emission {i}")
    assert not np.array_equal(got_a[0][0], got_c[0][0])
    # a reloaded into the recycled page reads its first load's logits
    again = _drive(engine, [prompt], ["a"], gen)
    for i in range(gen):
        np.testing.assert_array_equal(again[0][i], got_a[0][i])


# ---------------------------------------------------------------------------
# 3. the scheduler and HTTP
# ---------------------------------------------------------------------------

def test_scheduler_cohort_plumbs_and_unknown_cohort_rejects():
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    jcfg, cfg = _cfg()
    _, tp = _weights(jcfg)
    spec = _spec(cfg, tp)
    engine = _engine(cfg, tp, _bank(spec, ("a", "b")))
    batcher = ContinuousBatcher(engine, max_queue=8).start()
    try:
        with pytest.raises(ValueError, match="unknown adapter cohort"):
            batcher.submit([1, 2, 3], 4, cohort="nope")
        reqs = [batcher.submit([1, 2, 3], 4, cohort=c) for c in ("a", "b", None)]
        assert all(len(r.result(timeout=120)) == 4 for r in reqs)
        assert [r.cohort for r in reqs] == ["a", "b", None]
        stats = batcher.stats()
        assert stats["adapter_cohorts"] == 2.0 and stats["adapter_loads_total"] >= 2.0
        assert stats["adapter_residents"] == 2.0
    finally:
        batcher.close()
    assert engine.n_active == 0 and engine.free_blocks == engine.n_blocks
    plain = _engine(_plain(cfg), tp)  # no adapters: a cohort is refused
    with pytest.raises(ValueError, match="no adapter plane"):
        plain.begin(0, [1, 2, 3], 2, cohort="a")
    assert not plain.has_cohort("a") and plain.adapter_stats() is None


def test_http_cohort_roundtrip_and_healthz():
    from photon_tpu_torch.serve.frontend import ServeFrontend
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    jcfg, cfg = _cfg()
    _, tp = _weights(jcfg)
    engine = _engine(cfg, tp, {"a": _nonzero_adapter(_spec(cfg, tp), 1)})
    batcher = ContinuousBatcher(engine, max_queue=8).start()
    fe = ServeFrontend(batcher, max_new_tokens_cap=8)
    port = fe.start()

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/generate", json.dumps(body), {"Content-Type": "application/json"})
        r = conn.getresponse()
        out = (r.status, json.loads(r.read().decode()))
        conn.close()
        return out

    try:
        code, payload = post({"tokens": [5, 9, 2], "max_new_tokens": 4, "cohort": "a"})
        assert code == 200 and payload["cohort"] == "a" and len(payload["tokens"]) == 4
        code, payload = post({"tokens": [5, 9, 2], "max_new_tokens": 4})
        assert code == 200 and "cohort" not in payload
        code, payload = post({"tokens": [5, 9, 2], "cohort": "nope"})
        assert code == 400 and "unknown adapter cohort" in payload["error"]
        assert post({"tokens": [5, 9, 2], "cohort": 7})[0] == 400
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read().decode())
        conn.close()
        assert health["adapters"]["serving"] == ["a"] and health["adapters"]["cohorts"] == 1.0
        assert health["adapters"]["loads"] == 1.0
    finally:
        fe.close()
        batcher.close()


# ---------------------------------------------------------------------------
# 4. churn
# ---------------------------------------------------------------------------

def test_mixed_cohort_churn_allocates_no_pool_pages():
    """Two bursts of mixed cohorts through the batcher on a 2-page pool,
    the second forcing evictions and reloads: the pool's page stacks are
    the same tensors at the same addresses throughout (a load is an
    indexed copy), and every request completes."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    jcfg, cfg = _cfg(pool_size=2)
    _, tp = _weights(jcfg)
    engine = _engine(cfg, tp, _bank(_spec(cfg, tp)))
    pool = engine.adapter_pool
    ptrs = [leaf.data_ptr() for leaf in pool._leaves]
    batcher = ContinuousBatcher(engine, max_queue=16).start()
    rng = np.random.default_rng(3)

    def burst(cohorts):
        reqs = [batcher.submit(list(map(int, rng.integers(1, 96, int(rng.integers(2, 9))))),
                               int(rng.integers(2, 7)), cohort=c) for c in cohorts]
        return [r.result(timeout=120) for r in reqs]

    try:
        burst(["a", "b", None, "a", "c"])
        loads = pool.loads
        outs = burst(["c", "a", "b", None, "b", "c"])
    finally:
        batcher.close()
    assert all(outs) and pool.evictions > 0 and pool.loads > loads
    assert [leaf.data_ptr() for leaf in pool._leaves] == ptrs
    assert pool.allocator.held_blocks == pool.stats()["residents"]


# ---------------------------------------------------------------------------
# 5. train → checkpoint → hot-swap → serve
# ---------------------------------------------------------------------------

def _train_cfg(tmp_path):
    from photon_tpu_torch.config.schema import Config

    cfg = Config()
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 32, 2, 2, 32, 64
    m.attn_impl, m.compute_dtype = "xla", "float32"
    cfg.train.global_batch_size = cfg.train.device_microbatch_size = 2
    cfg.fl.n_total_clients = cfg.fl.n_clients_per_round = 2
    cfg.fl.local_steps, cfg.fl.strategy_name, cfg.fl.server_learning_rate = 2, "fedavg", 1.0
    cfg.optimizer.lr = 1e-2
    cfg.scheduler.t_warmup = 0
    cfg.dataset.synthetic = True
    cfg.photon.adapters.enabled, cfg.photon.adapters.rank = True, 4
    cfg.photon.adapters.cohorts = {"a": [0], "b": [1]}
    cfg.photon.save_path = str(tmp_path / "run")
    cfg.run_uuid = "adapter-hotswap"
    return cfg.validate("cpu")


def test_train_checkpoint_hotswap_serve_e2e(tmp_path):
    """Round 1 of the port's host adapter round lands in a store; a batcher
    starts on it and serves every cohort; round 2 (by a plane resumed from
    round 1) lands mid-traffic and the watcher swaps base and bank
    together with zero dropped requests; each cohort's stream after the
    swap equals round 2's contiguous oracle, greedy tokens exactly."""
    import copy

    from photon_tpu_torch.adapters import AdapterTrainPlane, configure_adapter_training
    from photon_tpu_torch.adapters.lora import adapter_tree, stack_adapter_trees
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.codec.params import params_from_numpy, params_to_ndarrays
    from photon_tpu_torch.federation.client_runtime import ClientRuntime
    from photon_tpu_torch.federation.transport import ParamTransport
    from photon_tpu_torch.models.decode import decode_step, prefill
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.hotswap import CheckpointWatcher
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _train_cfg(tmp_path)
    mgr = ServerCheckpointManager(FileStore(str(tmp_path / "store")), cfg.run_uuid)
    tcfg = configure_adapter_training(copy.deepcopy(cfg)).validate("cpu")
    runtime = ClientRuntime(tcfg, ParamTransport("inline"), device="cpu")
    plane = AdapterTrainPlane(cfg, *params_to_ndarrays(init_params(cfg.model, seed=0)))
    plane.run_round(runtime, 1, [0, 1])
    plane.save_round(mgr, 1)

    scfg = copy.deepcopy(tcfg)  # the training run's resolved config, LoRA knobs and all
    scfg.photon.serve.n_slots, scfg.photon.serve.block_size = 2, 4
    scfg.photon.serve.max_new_tokens = 8
    scfg.validate("cpu")
    engine = PagedEngine.from_checkpoint(scfg, store=mgr.store, resume_round=-1, device="cpu")
    assert engine.loaded_round == 1 and engine.adapter_pool.cohorts() == ["a", "b"]
    assert engine.mc.lora_rank == 0
    batcher = ContinuousBatcher(engine, max_queue=32).start()
    watcher = CheckpointWatcher(batcher, mgr, scfg, poll_s=0.02)
    prompts = _prompts(0, [int(n) for n in np.random.default_rng(1).integers(3, 9, 12)], 64)
    dropped = 0
    try:
        batcher.submit(prompts[0], 2, cohort="a").result(timeout=120)
        watcher.start()
        plane2 = AdapterTrainPlane(cfg, plane.base_meta, plane.base_arrays)
        rnd, control = plane2.resume(mgr, -1)
        assert rnd == 1 and control["server_steps_cumulative"] == cfg.fl.local_steps
        assert plane2.server_steps_cumulative == cfg.fl.local_steps
        assert sorted(plane2.client_states) == [0, 1]
        plane2.run_round(runtime, 2, [0, 1])
        assert plane2.server_steps_cumulative == 2 * cfg.fl.local_steps
        for i, (p, c) in enumerate(zip(prompts, ["a", "b", None] * 4)):
            if i == 4:
                plane2.save_round(mgr, 2)  # the watcher picks it up
            try:
                req = batcher.submit(p, 6, cohort=c)
                if req.error is not None or not req.result(timeout=120):
                    dropped += 1
            except Exception:  # noqa: BLE001 — a refusal is a drop here
                dropped += 1
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and batcher.swaps == 0:
            time.sleep(0.02)
    finally:
        watcher.close()
        batcher.close()
    assert dropped == 0 and batcher.swaps == 1 and engine.loaded_round == 2
    assert watcher.swaps_applied == 1

    base2 = params_from_numpy(plane2.base_meta.names, plane2.base_arrays, engine.mc)
    batcher2 = ContinuousBatcher(engine, max_queue=8).start()
    try:
        for cohort in ("a", "b"):
            p = prompts[0]
            got = batcher2.submit(p, 5, cohort=cohort).result(timeout=120)
            adapters = stack_adapter_trees([adapter_tree(plane2.spec,
                                                         plane2.strategies.params(cohort))])
            buf = torch.zeros((1, len(p) + 6), dtype=torch.long)
            buf[0, : len(p)] = torch.tensor(p)
            lg, st = prefill(base2, buf, torch.tensor([len(p)]), engine.mc, adapters=adapters,
                             lora_scale=plane2.spec.scale)
            want = []
            for _ in range(5):
                want.append(int(torch.argmax(lg[0])))
                lg, st = decode_step(base2, st, torch.tensor([want[-1]]), engine.mc,
                                     adapters=adapters, lora_scale=plane2.spec.scale)
            assert got == want, f"cohort {cohort} after the swap"
    finally:
        batcher2.close()
    for name in ("a", "b"):  # the swapped bank is round 2's
        assert any(not np.array_equal(x, y) for x, y in zip(plane.strategies.params(name),
                                                            plane2.strategies.params(name)))


# ---------------------------------------------------------------------------
# 6. the cohort-keyed prefix cache: where the packages part
# ---------------------------------------------------------------------------

def test_prefix_cache_keys_by_cohort_parts_from_jax():
    """One 13-token prompt (block 4) served under cohort a, then under b:
    in the port, b maps none of a's blocks and reads its cold logits (b
    after b hits and reads them too); the JAX engine on the same weights
    maps a's blocks for b (its chain hashes the tokens alone), and its b
    reads more than 1e-3 off a cold b. Without a cohort, the port's hashes
    are the JAX package's bytes."""
    from photon_tpu.serve.prefix import prefix_hashes as jax_hashes
    from photon_tpu_torch.serve.prefix import prefix_hashes

    prompt = _prompts(11, (13,), 96)[0]
    assert prefix_hashes(prompt, 4) == jax_hashes(prompt, 4)
    ha, hb = prefix_hashes(prompt, 4, cohort="a"), prefix_hashes(prompt, 4, cohort="b")
    assert len(set(ha) | set(hb) | set(jax_hashes(prompt, 4))) == 9

    jcfg, cfg = _cfg(prefix=True, n_slots=1)
    jp, tp = _weights(jcfg)
    bank = _bank(_spec(cfg, tp))
    gen = 3

    def port_run(cohorts):
        eng = _engine(cfg, tp, bank)
        out = []
        for c in cohorts:
            out.append(_drive(eng, [prompt], [c], gen)[0])
            eng.evict(0)
        return out, eng

    (warm_a, b_after_a), eng = port_run(["a", "b"])
    (cold_b,), _ = port_run(["b"])
    assert eng.prefix_cache.tokens_cached == 0  # b hit nothing of a's
    (_, b_after_b), eng_bb = port_run(["b", "b"])
    assert eng_bb.prefix_cache.tokens_cached == 12  # 3 blocks of b's own
    for i in range(gen):
        np.testing.assert_allclose(b_after_a[i], cold_b[i], atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(b_after_b[i], cold_b[i], atol=LOGIT_ATOL, rtol=0)

    def jax_run(cohorts):
        eng = jax_spy_engine(jcfg, jp, bank)
        out = []
        for c in cohorts:
            out.append(jax_drive(eng, [prompt], [c], gen)[0])
            eng.evict(0)
        return out, eng

    (_, jb_after_a), jeng = jax_run(["a", "b"])
    (jcold_b,), _ = jax_run(["b"])
    assert jeng.prefix_cache.tokens_cached == 12  # a's blocks mapped for b
    np.testing.assert_allclose(jcold_b[0], cold_b[0], atol=LOGIT_ATOL, rtol=0)
    assert float(np.abs(np.asarray(jb_after_a[0]) - np.asarray(jcold_b[0])).max()) > 1e-3
