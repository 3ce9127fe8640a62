"""The prefix cache in the port (``photon_tpu_torch.serve.prefix`` and the
engine's prefix path).

All CPU, fp32, tiny configs (d 32, 2 layers, vocab 96, block 4):

1. against the JAX package: ``prefix_hashes`` gives the same bytes, and
   ``PrefixCache`` over a ``BlockAllocator`` gives the same lookups,
   evictions and free counts on one seeded operation stream;
2. port against port, one case for each case of ``tests/test_serve_prefix.py``
   (its telemetry case is in ``tests/test_torch_observatory.py``; its
   retrace-sentinel case waits for the port's tooling): refcounts, atomic retain, chain hashes, LRU
   eviction while pinned, the cap preferring unpinned entries, a cached
   prefix equal to a cold one step by step (logits within
   ``LOGIT_ATOL``: the shared blocks' KV came from another chunk shape,
   which torch's CPU matmuls may sum differently; greedy tokens equal),
   nested depths and block-aligned prompts, no leaks under shared
   traffic, LRU eviction under pool pressure, and a failed admission
   that leaks nothing.
"""

import numpy as np
import pytest
import torch

from photon_tpu.config.schema import Config as JaxConfig
from tests._helpers import tiny_llama_config
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

LOGIT_ATOL = 1e-5
KINDS = ["mpt-wpe", "mpt-alibi", "llama-gqa"]


def _cfg(kind="mpt-wpe", *, n_slots=2, block_size=4, max_seq=32, max_new=8, n_blocks=0,
         cache_blocks=0, prefix=True):
    from photon_tpu_torch.config.schema import Config

    if kind == "llama-gqa":
        jcfg = tiny_llama_config(n_kv_heads=2)
    else:
        jcfg = JaxConfig()
        m = jcfg.model
        m.d_model, m.n_layers, m.n_heads, m.vocab_size = 32, 2, 4, 96
        m.attn_impl, m.compute_dtype = "xla", "float32"
        m.alibi = kind == "mpt-alibi"
        m.learned_pos_emb = not m.alibi
    jcfg.model.max_seq_len = max_seq
    s = jcfg.photon.serve
    s.n_slots, s.block_size, s.max_new_tokens, s.n_blocks = n_slots, block_size, max_new, n_blocks
    s.prefix_cache, s.prefix_cache_blocks = prefix, cache_blocks
    return Config.from_dict(jcfg.validate().to_dict()).validate("cpu")


def _params(cfg, seed=4):
    from photon_tpu_torch.models.mpt import init_params

    return init_params(cfg.model, seed=seed)


def _engine(cfg, params):
    from photon_tpu_torch.serve.engine import PagedEngine

    return PagedEngine(cfg, params, device="cpu")


def _offline_greedy(cfg, params, prompt, n):
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    buf = torch.zeros((1, len(prompt) + n), dtype=torch.long)
    buf[0, : len(prompt)] = torch.tensor(prompt)
    toks, _ = make_cached_generate_fn(cfg.model, params).many(
        buf, torch.tensor([len(prompt)]), n)
    return [int(x) for x in toks[0, len(prompt):]]


# ---------------------------------------------------------------------------
# 1. against the JAX package
# ---------------------------------------------------------------------------

def test_prefix_hashes_match_jax():
    from photon_tpu.serve.prefix import prefix_hashes as jax_hashes
    from photon_tpu_torch.serve.prefix import prefix_hashes

    rng = np.random.default_rng(0)
    for _ in range(50):
        prompt = list(map(int, rng.integers(0, 50368, rng.integers(0, 70))))
        bs = int(rng.choice([1, 4, 16]))
        limit = None if rng.random() < 0.5 else int(rng.integers(0, 6))
        assert prefix_hashes(prompt, bs, limit) == jax_hashes(prompt, bs, limit)


def test_prefix_cache_matches_jax_on_op_stream():
    """Both packages' allocator + cache through one seeded stream of
    alloc, insert, lookup (touching or not), retain, free, ensure_free,
    reclaimable and flush: every answer and counter equal."""
    from photon_tpu.serve.cache import BlockAllocator as JaxAlloc
    from photon_tpu.serve.prefix import PrefixCache as JaxCache
    from photon_tpu_torch.serve.cache import BlockAllocator
    from photon_tpu_torch.serve.prefix import PrefixCache, prefix_hashes

    rng = np.random.default_rng(1)
    ja, ta = JaxAlloc(24), BlockAllocator(24)
    jc, tc = JaxCache(ja, max_blocks=10), PrefixCache(ta, max_blocks=10)
    held: list[list[int]] = []  # blocks held by "requests"
    prompts = [list(map(int, rng.integers(0, 5, 4 * int(rng.integers(1, 5))))) for _ in range(12)]
    for _ in range(600):
        op = int(rng.integers(0, 7))
        hashes = prefix_hashes(prompts[int(rng.integers(0, len(prompts)))], 4)
        if op == 0:  # a request's admission: take fresh blocks
            n = len(hashes)
            ids_j, ids_t = ja.alloc(n), ta.alloc(n)
            assert ids_j == ids_t
            if ids_t is not None:
                held.append(ids_t)
        elif op == 1 and held:  # its prefill ends: index its blocks
            blocks = held[int(rng.integers(0, len(held)))]
            assert tc.insert(hashes, blocks) == jc.insert(hashes, blocks)
        elif op == 2:
            touch = bool(rng.integers(0, 2))
            hit = tc.lookup(hashes, touch=touch)
            assert hit == jc.lookup(hashes, touch=touch)
            if hit and rng.random() < 0.5:  # a hit admitted: pin it
                ja.retain(hit), ta.retain(hit)
                held.append(hit)
        elif op == 3 and held:  # a request evicts
            blocks = held.pop(int(rng.integers(0, len(held))))
            ja.free(blocks), ta.free(blocks)
        elif op == 4:
            n = int(rng.integers(0, 24))
            assert tc.ensure_free(n) == jc.ensure_free(n)
        elif op == 5:
            ex = set(map(int, rng.integers(0, 24, 3)))
            assert tc.reclaimable(ex) == jc.reclaimable(ex)
        elif op == 6 and rng.random() < 0.1:
            assert tc.flush() == jc.flush()
        assert (len(tc), tc.evictions) == (len(jc), jc.evictions)
        assert ta.free_blocks == ja.free_blocks
        assert all(ta.refcount(b) == ja.refcount(b) for b in range(24))


# ---------------------------------------------------------------------------
# 2. port against port
# ---------------------------------------------------------------------------

def test_allocator_refcounts_share_and_free():
    from photon_tpu_torch.serve.cache import BlockAllocator, BlockLeakError

    a = BlockAllocator(4)
    ids = a.alloc(2)
    assert a.free_blocks == 2 and all(a.refcount(b) == 1 for b in ids)
    a.retain(ids)
    assert all(a.refcount(b) == 2 for b in ids)
    a.free(ids)  # the first holder leaves: the blocks stay held
    assert a.free_blocks == 2 and all(a.refcount(b) == 1 for b in ids)
    a.free(ids)
    assert a.free_blocks == 4 and all(a.refcount(b) == 0 for b in ids)
    with pytest.raises(BlockLeakError):
        a.free(ids[:1])
    with pytest.raises(BlockLeakError):
        a.retain([ids[0]])  # retaining a free block would resurrect it
    with pytest.raises(BlockLeakError):
        a.retain([99])


def test_allocator_retain_is_atomic():
    from photon_tpu_torch.serve.cache import BlockAllocator, BlockLeakError

    a = BlockAllocator(4)
    ids = a.alloc(2)
    with pytest.raises(BlockLeakError):
        a.retain([ids[0], 99])
    assert a.refcount(ids[0]) == 1  # not half applied
    a.free(ids)
    assert a.free_blocks == 4


def test_chain_hashes_identify_whole_prefix():
    from photon_tpu_torch.serve.prefix import prefix_hashes

    a = list(range(1, 13))
    b = list(a)
    b[1] = 99
    ha, hb = prefix_hashes(a, 4), prefix_hashes(b, 4)
    assert len(ha) == 3
    assert all(x != y for x, y in zip(ha, hb))  # equal blocks 1, 2: the chain parts them
    assert prefix_hashes(a + [5, 6], 4) == ha  # a partial tail never hashes
    assert prefix_hashes(a, 4, limit=1) == ha[:1]


def test_prefix_cache_lru_evict_while_pinned():
    from photon_tpu_torch.serve.cache import BlockAllocator
    from photon_tpu_torch.serve.prefix import PrefixCache, prefix_hashes

    alloc = BlockAllocator(4)
    pc = PrefixCache(alloc)
    ids = alloc.alloc(2)
    pc.insert(prefix_hashes(list(range(1, 9)), 4), ids)
    assert all(alloc.refcount(b) == 2 for b in ids)
    alloc.free(ids)  # the owner evicts; the cache keeps them
    assert alloc.free_blocks == 2 and len(pc) == 2
    alloc.retain([ids[0]])  # a live request pins block 0
    assert pc.ensure_free(4) is False
    assert len(pc) == 1 and pc.evictions == 1 and alloc.free_blocks == 3
    assert pc.flush() == 1  # a flush un-indexes pinned entries too
    assert len(pc) == 0 and pc.evictions == 2
    assert alloc.free_blocks == 3 and alloc.refcount(ids[0]) == 1
    alloc.free([ids[0]])
    assert alloc.free_blocks == 4


def test_prefix_cache_explicit_cap():
    from photon_tpu_torch.serve.cache import BlockAllocator
    from photon_tpu_torch.serve.prefix import PrefixCache, prefix_hashes

    alloc = BlockAllocator(8)
    pc = PrefixCache(alloc, max_blocks=2)
    ids = alloc.alloc(3)
    pc.insert(prefix_hashes(list(range(1, 13)), 4), ids)
    assert len(pc) == 2 and pc.evictions == 1
    alloc.free(ids)
    assert alloc.free_blocks == 6


def test_prefix_cache_cap_eviction_prefers_unpinned():
    from photon_tpu_torch.serve.cache import BlockAllocator
    from photon_tpu_torch.serve.prefix import PrefixCache, prefix_hashes

    alloc = BlockAllocator(8)
    pc = PrefixCache(alloc, max_blocks=2)
    hot, cold = alloc.alloc(1), alloc.alloc(1)
    pc.insert(prefix_hashes([1, 2, 3, 4], 4), hot)
    pc.insert(prefix_hashes([9, 9, 9, 9], 4), cold)
    alloc.free(cold)
    pc.insert(prefix_hashes([7, 7, 7, 7], 4), alloc.alloc(1))
    assert pc.lookup(prefix_hashes([1, 2, 3, 4], 4)) == hot
    assert pc.lookup(prefix_hashes([9, 9, 9, 9], 4)) == []
    assert pc.evictions == 1


@pytest.mark.parametrize("kind", KINDS)
def test_cached_admission_matches_cold_per_step(kind):
    """A donor prefills cold and evicts; a probe sharing its 3-block
    prefix admits through the cache. Step by step, the probe's logits
    equal a cache-less twin's, from the first sampled token on."""
    from photon_tpu_torch.serve.cache import paged_decode_step

    cfg = _cfg(kind)
    params = _params(cfg)
    mc = cfg.model
    rng = np.random.default_rng(2)
    shared = list(map(int, rng.integers(1, mc.vocab_size, 12)))
    donor = shared + list(map(int, rng.integers(1, mc.vocab_size, 3)))
    probe = shared + list(map(int, rng.integers(1, mc.vocab_size, 5)))
    warm = _engine(cfg, params)
    cold = _engine(_cfg(kind, prefix=False), params)
    assert cold.prefix_cache is None
    warm.admit(0, donor, 4)
    warm.evict(0)  # the shared blocks' first owner is gone
    first_w = warm.admit(0, probe, 8)
    assert warm.prefix_cache.tokens_cached == 12
    assert warm.prefix_stats()["tokens_cached"] == 12
    first_c = cold.admit(0, probe, 8)
    torch.testing.assert_close(warm.last_logits, cold.last_logits, rtol=0, atol=LOGIT_ATOL)
    assert first_w == first_c
    tok = first_w
    active = torch.tensor([True, False])
    for _ in range(6):
        t = torch.tensor([tok, 0])
        lw, _ = paged_decode_step(warm.params, warm._layers, warm.state, t, mc, active)
        lc, _ = paged_decode_step(cold.params, cold._layers, cold.state, t, mc, active)
        torch.testing.assert_close(lw[0], lc[0], rtol=0, atol=LOGIT_ATOL)
        assert int(lw[0].argmax()) == int(lc[0].argmax())
        tok = int(lw[0].argmax())


def test_nested_prefix_depths_and_block_aligned_prompt():
    """Hits at every depth; a prompt that is exactly its cached blocks
    still runs its last token (the source of its first logits)."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _cfg(max_seq=32)
    params = _params(cfg)
    engine = _engine(cfg, params)
    batcher = ContinuousBatcher(engine, max_queue=16).start()
    rng = np.random.default_rng(5)
    base = list(map(int, rng.integers(1, cfg.model.vocab_size, 8)))
    try:
        for p in (base, base + [7, 3], base[:4], base + [7, 3, 9, 9, 1], base):
            assert batcher.submit(p, 4).result(timeout=120) \
                == _offline_greedy(cfg, params, p, 4), p
        assert engine.prefix_cache.tokens_cached > 0
        assert engine.n_active == 0
    finally:
        batcher.close()


def test_no_leak_and_oracle_outputs_under_shared_traffic():
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _cfg(n_slots=2, max_seq=32)
    params = _params(cfg)
    engine = _engine(cfg, params)
    batcher = ContinuousBatcher(engine, max_queue=32).start()
    rng = np.random.default_rng(9)
    shared = list(map(int, rng.integers(1, cfg.model.vocab_size, 8)))
    prompts = []
    for i in range(10):
        suf = list(map(int, rng.integers(1, cfg.model.vocab_size, int(rng.integers(1, 6)))))
        prompts.append((shared + suf) if i % 3 else suf)  # hits and misses
    try:
        reqs = [batcher.submit(p, int(rng.integers(1, 6))) for p in prompts]
        for p, r in zip(prompts, reqs):
            assert r.result(timeout=180) == _offline_greedy(cfg, params, p, r.max_new_tokens), p
        assert engine.n_active == 0 and batcher.queue_depth == 0
        # every block not free is the cache's
        assert engine.n_blocks - engine.free_blocks == len(engine.prefix_cache)
        assert engine.prefix_cache.hit_rate > 0
        engine.prefix_cache.flush()
        assert engine.free_blocks == engine.n_blocks
    finally:
        batcher.close()


def test_lru_eviction_under_pool_pressure():
    """A pool far smaller than the traffic: admission evicts cold entries
    instead of failing; ``ensure_free`` and ``flush`` free what only the
    cache holds."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _cfg(n_slots=1, max_seq=32, n_blocks=8)
    params = _params(cfg)
    engine = _engine(cfg, params)
    batcher = ContinuousBatcher(engine, max_queue=32).start()
    rng = np.random.default_rng(11)
    try:
        for _ in range(6):
            p = list(map(int, rng.integers(1, cfg.model.vocab_size, 14)))
            assert batcher.submit(p, 4).result(timeout=120) == _offline_greedy(cfg, params, p, 4)
        assert engine.prefix_cache.evictions > 0 and engine.n_active == 0
        before = engine.free_blocks
        engine.prefix_cache.ensure_free(8)
        assert engine.free_blocks == 8 >= before
        p = list(map(int, rng.integers(1, cfg.model.vocab_size, 14)))
        batcher.submit(p, 4).result(timeout=120)
        assert len(engine.prefix_cache) > 0
        engine.prefix_cache.flush()
        assert len(engine.prefix_cache) == 0 and engine.free_blocks == engine.n_blocks
        assert batcher.submit(p, 4).result(timeout=120) == _offline_greedy(cfg, params, p, 4)
    finally:
        batcher.close()


def test_failed_admission_leaks_nothing():
    """``begin`` is transactional: an admission that fails after retaining
    its hit blocks and allocating fresh ones gives both back."""
    from photon_tpu_torch.serve import engine as engine_mod

    cfg = _cfg()
    eng = _engine(cfg, _params(cfg))
    p = list(range(1, 14))
    eng.admit(0, p, 4)
    eng.evict(0)
    refs = {b: eng.allocator.refcount(b) for b in range(eng.n_blocks)}
    free = eng.free_blocks

    def boom(*a, **k):
        raise RuntimeError("injected install failure")

    real = engine_mod.install_row
    engine_mod.install_row = boom
    try:
        with pytest.raises(RuntimeError, match="injected"):
            eng.begin(0, p + [5], 4)
    finally:
        engine_mod.install_row = real
    assert eng.free_blocks == free and not eng._active.any()
    assert {b: eng.allocator.refcount(b) for b in range(eng.n_blocks)} == refs
