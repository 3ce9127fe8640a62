"""Speculative decoding in the port (``photon_tpu_torch.serve``): the
drafter, the throttle, the verify grid and the batcher.

All CPU, fp32, tiny configs (d 32, 2 layers, vocab 96, block 4):

1. against the JAX package: ``NGramDrafter`` drafts and ``SpecController``
   depths equal JAX's on one seeded operation stream; greedy streams of
   the port's engine with the prefix cache and speculative decoding on
   equal JAX's ``PagedEngine`` on the same schedule (mpt-wpe, mpt-alibi,
   llama-gqa);
2. port against port, one case for each case of ``tests/test_speculative.py``
   (its telemetry case is in ``tests/test_torch_observatory.py``): a verify step
   equals the same number of sequential steps (logits within
   ``LOGIT_ATOL``: torch's CPU matmuls may sum a row differently when the
   number of rows changes, so a verify is not bit-equal here; greedy
   tokens equal), rejected drafts roll back, EOS and ``max_new`` in the
   middle of a burst, seeded temperature streams reproducible, a row
   without drafts independent of its batch-mates' drafts, the residual
   distribution, the throttle, MoE left off, config validation, and the
   live width resetting when idle.
"""

import numpy as np
import pytest
import torch

from photon_tpu.config.schema import Config as JaxConfig
from tests._helpers import tiny_llama_config
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

#: fp32 logits of a verify column against the sequential step's
LOGIT_ATOL = 1e-5
KINDS = ["mpt-wpe", "mpt-alibi", "llama-gqa"]


def _jax_cfg(kind="mpt-wpe", *, n_slots=3, block_size=4, max_seq=64, max_new=16,
             budget=2048, prefix=False, spec=True, k=4, accept_floor=0.3,
             probe_ticks=64, draft_budget=64) -> JaxConfig:
    if kind == "llama-gqa":
        cfg = tiny_llama_config(n_kv_heads=2)
    else:
        cfg = JaxConfig()
        m = cfg.model
        m.d_model, m.n_layers, m.n_heads, m.vocab_size = 32, 2, 4, 96
        m.attn_impl, m.compute_dtype = "xla", "float32"
        m.alibi = kind == "mpt-alibi"
        m.learned_pos_emb = not m.alibi
        if kind == "mpt-moe":
            m.mlp, m.moe_num_experts, m.moe_top_k = "moe", 4, 2
    cfg.model.max_seq_len = max_seq
    s = cfg.photon.serve
    s.n_slots, s.block_size, s.max_new_tokens = n_slots, block_size, max_new
    s.prefill_token_budget, s.prefix_cache = budget, prefix
    sp = s.speculative
    sp.enabled, sp.k, sp.accept_floor = spec, k, accept_floor
    sp.probe_ticks, sp.draft_budget = probe_ticks, draft_budget
    return cfg.validate()


def _cfg(kind="mpt-wpe", impl="auto", **kw):
    """The port's config (from the JAX one, as a resolved YAML would)."""
    from photon_tpu_torch.config.schema import Config

    cfg = Config.from_dict(_jax_cfg(kind, **kw).to_dict())
    cfg.photon.serve.attention_impl = impl
    return cfg.validate("cpu")


def _params(cfg, seed=4):
    from photon_tpu_torch.models.mpt import init_params

    return init_params(cfg.model, seed=seed)


def _engine(cfg, params):
    from photon_tpu_torch.serve.engine import PagedEngine

    return PagedEngine(cfg, params, device="cpu")


def _offline_greedy(cfg, params, prompt, n):
    """The contiguous KV-cache decoder's greedy continuation."""
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    buf = torch.zeros((1, len(prompt) + n), dtype=torch.long)
    buf[0, : len(prompt)] = torch.tensor(prompt)
    toks, _ = make_cached_generate_fn(cfg.model, params).many(
        buf, torch.tensor([len(prompt)]), n)
    return [int(x) for x in toks[0, len(prompt):]]


def _prefill_all(eng, slots):
    for s in slots:
        while eng.pending_tokens(s):
            eng.mixed_step((s, eng.pending_tokens(s)), include_decode=False)


class _FixedDrafter:
    """Pops pre-scripted drafts per slot (empty once the script runs out)."""

    def __init__(self, script=None):
        self.script = dict(script or {})
        self.observed: dict[int, list[int]] = {}

    def begin(self, slot, prompt):
        self.observed.setdefault(slot, [])

    def observe(self, slot, tokens):
        self.observed[slot].extend(tokens)

    def end(self, slot):
        pass

    def propose(self, slot, k):
        q = self.script.get(slot)
        return list(q.pop(0))[:k] if q else []


# ---------------------------------------------------------------------------
# 1. against the JAX package
# ---------------------------------------------------------------------------

def test_drafter_and_controller_match_jax():
    """One seeded operation stream (begin / observe / propose / end over
    three slots; observe / next_k / k_effective / set_k_max) through both
    packages' drafter and throttle: the same drafts, depths and EWMA."""
    from photon_tpu.serve.draft import NGramDrafter as JaxDrafter
    from photon_tpu.serve.draft import SpecController as JaxController
    from photon_tpu_torch.serve.draft import NGramDrafter, SpecController

    rng = np.random.default_rng(0)
    pairs = [(JaxDrafter(3, 1), NGramDrafter(3, 1)), (JaxDrafter(4, 2), NGramDrafter(4, 2))]
    for _ in range(400):
        op, slot = rng.integers(0, 4), int(rng.integers(0, 3))
        toks = list(map(int, rng.integers(0, 6, rng.integers(1, 9))))  # small vocab: repeats
        k = int(rng.integers(0, 7))
        for jd, td in pairs:
            if op == 0:
                jd.begin(slot, toks), td.begin(slot, toks)
            elif op == 1:
                jd.observe(slot, toks), td.observe(slot, toks)
            elif op == 2:
                assert td.propose(slot, k) == jd.propose(slot, k)
            else:
                jd.end(slot), td.end(slot)
    jc = JaxController(4, accept_floor=0.3, ewma_alpha=0.3, probe_ticks=5)
    tc = SpecController(4, accept_floor=0.3, ewma_alpha=0.3, probe_ticks=5)
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            d = int(rng.integers(0, 6))
            a = int(rng.integers(0, d + 1))
            jc.observe(d, a), tc.observe(d, a)
        elif op == 1:
            assert tc.next_k() == jc.next_k()
        elif op == 2:
            k = int(rng.integers(0, 5))
            jc.set_k_max(k), tc.set_k_max(k)
        assert tc.k_effective() == jc.k_effective()
        assert (tc.ewma, tc.drafted, tc.accepted, tc.spec_steps) == \
            (jc.ewma, jc.drafted, jc.accepted, jc.spec_steps)


def _drive_spec(eng, drafter, prompts, max_new, budget, k):
    """The speculative scheduler's loop, shared by both engines: FIFO
    admission (prefix-aware), one chunk per step, every decoding row
    drafting up to ``min(k, remaining - 1)`` tokens, bursts cut at
    ``max_new``."""
    queue, running = list(enumerate(prompts)), {}
    out = {i: [] for i in range(len(prompts))}
    while queue or running:
        while queue and eng.free_slot() is not None and eng.can_admit(
                len(queue[0][1]), max_new, prompt=queue[0][1]):
            i, prompt = queue.pop(0)
            slot = eng.free_slot()
            eng.begin(slot, prompt, max_new)
            drafter.begin(slot, prompt)
            running[slot] = i
        pre = [s for s in running if eng.pending_tokens(s) > 0]
        chunk = None
        if pre:
            s = min(pre, key=lambda s: running[s])
            chunk = (s, min(eng.pending_tokens(s), budget))
        drafts = {}
        for s, i in running.items():
            depth = min(k, max_new - len(out[i]) - 1)
            if eng.pending_tokens(s) == 0 and depth > 0:
                drafts[s] = drafter.propose(s, depth)
        toks, n_em = eng.spec_step(chunk, drafts)
        for s in sorted(running):
            burst = [int(t) for t in toks[s, : int(n_em[s])]]
            i = running[s]
            out[i].extend(burst[: max_new - len(out[i])])
            if len(out[i]) >= max_new:
                eng.evict(s)
                drafter.end(s)
                del running[s]
            elif burst:
                drafter.observe(s, burst)
    return [out[i] for i in range(len(prompts))]


@pytest.mark.parametrize("kind", KINDS)
def test_spec_prefix_engine_greedy_matches_jax(kind):
    """The port's engine with the prefix cache and speculative decoding
    on emits JAX's ``PagedEngine``'s greedy streams on one schedule
    (budget 3 splits prompts; shared prefixes hit; 6 requests over 2 slots
    recycle blocks), and both engines end with the same cache entries."""
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.models.mpt import init_params as jax_init
    from photon_tpu.serve.draft import NGramDrafter as JaxDrafter
    from photon_tpu.serve.engine import PagedEngine as JaxEngine
    from photon_tpu_torch.codec.params import params_from_numpy
    from photon_tpu_torch.serve.draft import NGramDrafter

    jcfg = _jax_cfg(kind, n_slots=2, max_seq=48, budget=3, prefix=True)
    cfg = _cfg(kind, n_slots=2, max_seq=48, budget=3, prefix=True)
    jp = jax_init(jcfg.model, seed=4)
    meta, arrays = params_to_ndarrays(jp)
    tp = params_from_numpy(meta.names, arrays, cfg.model, "cpu")
    rng = np.random.default_rng(5)
    vocab = cfg.model.vocab_size
    shared = list(map(int, rng.integers(1, vocab, 8)))
    prompts = []
    for i in range(6):
        suf = list(map(int, rng.integers(1, vocab, int(rng.integers(1, 6)))))
        prompts.append((shared + suf) if i % 2 else suf)
    jeng = JaxEngine(jcfg, jp)
    ref = _drive_spec(jeng, JaxDrafter(), prompts, 10, 3, 4)
    eng = _engine(cfg, tp)
    assert _drive_spec(eng, NGramDrafter(), prompts, 10, 3, 4) == ref
    assert eng.prefix_cache.tokens_cached == jeng.prefix_cache.tokens_cached > 0
    assert len(eng.prefix_cache) == len(jeng.prefix_cache)
    eng.prefix_cache.flush()
    assert eng.allocator.free_blocks == eng.n_blocks


# ---------------------------------------------------------------------------
# 2. port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["gather", "ragged"])
@pytest.mark.parametrize("kind", KINDS)
def test_spec_grid_matches_sequential_steps(kind, impl):
    """At the cache layer: two decode rows each carrying 3 tokens through
    one ``mixed_chunk_step(n_spec=4)`` — with a third slot's prompt chunk
    in the same step — give the logits of three sequential single-token
    steps (the chunk riding the first), and the same live KV."""
    from photon_tpu_torch.serve.cache import BlockAllocator, init_paged_state, \
        install_row, mixed_chunk_step

    cfg = _cfg(kind, impl, max_seq=32)
    mc = cfg.model
    eng = _engine(cfg, _params(cfg))  # its compute params, layer views and impl
    bs, m, B = 4, 8, 3
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, mc.vocab_size, 6))) for _ in range(2)]
    chunk1 = list(map(int, rng.integers(1, mc.vocab_size, 3)))

    def fresh():
        alloc = BlockAllocator(B * m)
        st = init_paged_state(mc, B, B * m, bs, m, torch.device("cpu"))
        for slot in range(B):
            install_row(st, slot, torch.tensor(alloc.alloc(m), dtype=torch.int32), 0)
        return st

    def step(st, rows, lengths_after, tq, chunk_slot=2, has_chunk=False, n_spec=1):
        """``rows``: slot -> (tokens, first position)."""
        tk = torch.zeros((B, tq), dtype=torch.long)
        ps = torch.zeros((B, tq), dtype=torch.int32)
        qv = torch.zeros((B, tq), dtype=torch.bool)
        eo = torch.zeros(B, dtype=torch.int32)
        for s, (toks, p0) in rows.items():
            tk[s, : len(toks)] = torch.tensor(toks)
            ps[s, : len(toks)] = torch.arange(p0, p0 + len(toks))
            qv[s, : len(toks)] = True
            eo[s] = len(toks) - 1
        return mixed_chunk_step(eng.params, eng._layers, st, tk, ps, qv,
                                eo, torch.tensor(lengths_after, dtype=torch.int32),
                                chunk_slot, mc, n_ctx=4, has_chunk=has_chunk,
                                impl=eng._impl, n_spec=n_spec)

    def boot():
        st, first, la = fresh(), [], [0, 0, 0]
        for s, p in enumerate(prompts):
            la[s] = len(p)
            lg, st = step(st, {s: (p, 0)}, list(la), 8, chunk_slot=s, has_chunk=True)
            first.append(int(lg[s].argmax()))
        return st, first

    # path A: 3 sequential single-token steps, slot 2's chunk on the first
    stA, first = boot()
    lengths = [len(prompts[0]), len(prompts[1]), 0]
    last = list(first)
    seq, feeds = [], [list(first)]
    for i in range(3):
        rows = {s: ([last[s]], lengths[s]) for s in (0, 1)}
        lengths = [lengths[0] + 1, lengths[1] + 1, len(chunk1) if i == 0 else lengths[2]]
        if i == 0:
            rows[2] = (chunk1, 0)
        lg, stA = step(stA, rows, lengths, 8 if i == 0 else 1, has_chunk=i == 0)
        seq.append(lg.clone())
        last = [int(lg[0].argmax()), int(lg[1].argmax()), 0]
        feeds.append(list(last))
    # path B: one verify step with the same 3 tokens per row
    stB, firstB = boot()
    assert firstB == first
    rows = {s: ([feeds[0][s], feeds[1][s], feeds[2][s]], len(prompts[s])) for s in (0, 1)}
    rows[2] = (chunk1, 0)
    la = [len(prompts[0]) + 3, len(prompts[1]) + 3, len(chunk1)]
    lgB, stB = step(stB, rows, la, 8, has_chunk=True, n_spec=4)  # 4: pow2 of 3, a pad column
    assert lgB.shape == (B, 4, mc.vocab_size)
    for i in range(3):
        for s in (0, 1):
            torch.testing.assert_close(lgB[s, i], seq[i][s], rtol=0, atol=LOGIT_ATOL)
            assert int(lgB[s, i].argmax()) == int(seq[i][s].argmax())
    # the chunk row's emit column, replicated across the verify axis
    torch.testing.assert_close(lgB[2, 0], seq[0][2], rtol=0, atol=LOGIT_ATOL)
    assert torch.equal(lgB[2, 0], lgB[2, 3])
    trash = stA.cache_k.shape[0] - 1
    torch.testing.assert_close(stB.cache_k[:trash], stA.cache_k[:trash], rtol=0, atol=1e-6)
    torch.testing.assert_close(stB.cache_v[:trash], stA.cache_v[:trash], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["mpt-wpe", "llama-gqa"])
def test_engine_spec_step_matches_sequential_engine(kind):
    """At the engine: ``spec_step`` with drafts that are the sequential
    engine's own tokens (and a batch-mate's chunk in the same call) emits
    those tokens, leaves the same cursors, and plain decode then goes on
    alike."""
    cfg = _cfg(kind, budget=3)
    params = _params(cfg)
    rng = np.random.default_rng(7)
    vocab = cfg.model.vocab_size
    p0, p1, p2 = (list(map(int, rng.integers(1, vocab, n))) for n in (5, 7, 6))

    def boot(eng):
        eng.begin(0, p0, 10)
        eng.begin(1, p1, 10)
        _prefill_all(eng, (0, 1))
        eng.begin(2, p2, 8)  # stays mid-prefill during the verify

    ref = _engine(cfg, params)
    boot(ref)
    ref_toks = {0: [], 1: []}
    ref_logits = []
    for chunk in ((2, 3), None, None):
        out, _ = ref.mixed_step(chunk)
        ref_logits.append(ref.last_logits.clone())
        for s in (0, 1):
            ref_toks[s].append(int(out[s]))
    eng = _engine(cfg, params)
    boot(eng)
    out2, n_em = eng.spec_step((2, 3), {s: ref_toks[s][:2] for s in (0, 1)})
    for s in (0, 1):
        assert int(n_em[s]) == 3  # 2 accepted drafts + the bonus
        assert [int(x) for x in out2[s, :3]] == ref_toks[s]
        for i in range(3):
            torch.testing.assert_close(eng.last_logits[s, i], ref_logits[i][s], rtol=0,
                                       atol=LOGIT_ATOL)
    assert eng.pending_tokens(2) == len(p2) - 3  # the chunk advanced too
    np.testing.assert_array_equal(eng._lengths[:2], ref._lengths[:2])
    np.testing.assert_array_equal(eng.state.lengths.numpy()[:2], ref.state.lengths.numpy()[:2])
    for _ in range(3):
        a, _ = ref.mixed_step(None)
        b, _ = eng.mixed_step(None)
        np.testing.assert_array_equal(a[:2], b[:2])


def test_spec_rejection_rolls_back():
    """Drafts that never match cost only wasted verify columns: every step
    emits the bonus token alone, the cursor advances by one, and the
    stream equals the contiguous decoder's."""
    cfg = _cfg(n_slots=2)
    params = _params(cfg)
    p = [5, 9, 2, 7]
    want = _offline_greedy(cfg, params, p, 8)
    eng = _engine(cfg, params)
    eng.begin(0, p, 8)
    _prefill_all(eng, (0,))
    got = [int(eng._last[0])]
    while len(got) < 8:
        bad = [(want[len(got)] + 1) % cfg.model.vocab_size] * 3
        out, n_em = eng.spec_step(None, {0: bad})
        assert int(n_em[0]) == 1
        assert int(eng._lengths[0]) == len(p) + len(got)
        assert int(eng.state.lengths[0]) == len(p) + len(got)
        got.extend(int(x) for x in out[0, : int(n_em[0])])
    assert got == want


@pytest.mark.parametrize("kind", KINDS)
def test_spec_serving_matches_offline(kind):
    """The speculative batcher (n-gram drafter, budget 3, prefix cache on,
    recycled blocks) completes every greedy request as the contiguous
    decoder does, and drafts were accepted on the way."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _cfg(kind, prefix=True, budget=3)
    params = _params(cfg)
    engine = _engine(cfg, params)
    batcher = ContinuousBatcher(engine, max_queue=16, prefill_token_budget=3,
                                speculative=cfg.photon.serve.speculative).start()
    rng = np.random.default_rng(5)
    vocab = cfg.model.vocab_size
    shared = list(map(int, rng.integers(1, vocab, 8)))
    try:
        for i in range(6):
            suf = list(map(int, rng.integers(1, vocab, int(rng.integers(1, 6)))))
            p = (shared + suf) if i % 2 else suf
            assert batcher.submit(p, 12).result(timeout=120) \
                == _offline_greedy(cfg, params, p, 12), p
        assert batcher._spec.drafted > 0 and batcher._spec.accepted > 0
        assert engine.n_active == 0
        assert batcher.spec_stats()["drafted"] == batcher._spec.drafted
    finally:
        batcher.close()


def test_spec_eos_and_max_new_mid_burst():
    """EOS inside a burst cuts the stream there (the rest of the burst is
    dropped), and ``max_new_tokens`` is never exceeded."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _cfg()
    params = _params(cfg)
    p = [3, 3, 8, 1]
    ref = _offline_greedy(cfg, params, p, 12)
    eos = ref[4]
    want = ref[: ref.index(eos) + 1]
    drafter = _FixedDrafter()
    batcher = ContinuousBatcher(_engine(cfg, params), max_queue=4,
                                speculative=cfg.photon.serve.speculative,
                                drafter=drafter).start()
    try:
        # drafts that are the true continuation: whole bursts land at once
        drafter.script = {0: [ref[i + 1: i + 5] for i in range(0, 12, 5)]}
        assert batcher.submit(p, 12, eos_id=eos).result(timeout=120) == want
        drafter.script = {0: [ref[1:5], ref[6:10]]}
        assert batcher.submit(p, 5, eos_id=-1).result(timeout=120) == ref[:5]
        assert batcher._spec.accepted > 0
    finally:
        batcher.close()


def _temp_run(eng, p, spec, seed, n=4, temp=0.8):
    eng.begin(0, p, 8, temperature=temp, seed=seed)
    _prefill_all(eng, (0,))
    toks = [int(eng._last[0])]
    while len(toks) < n:
        if spec:
            out, n_em = eng.spec_step(None, {0: [toks[-1]] * 2})
            toks.extend(int(x) for x in out[0, : int(n_em[0])])
        else:
            out, _ = eng.mixed_step(None)
            toks.append(int(out[0]))
    eng.evict(0)
    return toks[:n]


def test_spec_temperature_reproducible():
    """Seeded temperature streams under speculation repeat exactly, and the
    first emission (drawn before any draft is tested) is the plain
    sampler's token for every seed."""
    cfg = _cfg(n_slots=1, max_new=8)
    eng = _engine(cfg, _params(cfg))
    p = [5, 9, 2, 7]
    assert _temp_run(eng, p, True, 11) == _temp_run(eng, p, True, 11)
    assert _temp_run(eng, p, False, 11) == _temp_run(eng, p, False, 11)
    for s in range(12):
        assert _temp_run(eng, p, True, s, n=1) == _temp_run(eng, p, False, s, n=1)
    streams = {tuple(_temp_run(eng, p, True, s, n=6)) for s in range(6)}
    assert len(streams) > 1  # the seed picks the stream


def test_nondrafting_temp_row_is_batchmate_independent():
    """A seeded temperature row with no drafts emits the same stream
    whether it runs alone through plain steps or beside a greedy mate
    whose drafts make every step a verify."""
    cfg = _cfg(n_slots=2, max_new=16)
    params = _params(cfg)
    p_temp, p_greedy = [5, 9, 2, 7], [3, 3, 8, 1]

    def boot(eng, with_mate):
        eng.begin(0, p_temp, 12, temperature=0.8, seed=17)
        _prefill_all(eng, (0,))
        if with_mate:
            eng.begin(1, p_greedy, 40)  # room for its drafts on every step
            _prefill_all(eng, (1,))

    a = _engine(cfg, params)
    boot(a, False)
    alone = [int(a._last[0])]
    for _ in range(6):
        out, _ = a.mixed_step(None)
        alone.append(int(out[0]))
    b = _engine(cfg, params)
    boot(b, True)
    together = [int(b._last[0])]
    while len(together) < 7:
        out, n_em = b.spec_step(None, {1: [int(b._last[1])] * 3})
        assert out.shape[1] == 4  # every step is a verify
        together.extend(int(x) for x in out[0, : int(n_em[0])])
    assert together[:7] == alone


def test_spec_temperature_rejection_distribution():
    """The rejection identity on ``_verify_rows``: with a point-mass
    proposal at draft ``d``, the first emission is distributed as the
    model's softmax (accept gives ``p(d)`` at ``d``, the residual ``p``
    elsewhere). 4000 rows, each emission its own seed."""
    from photon_tpu_torch.serve.engine import _verify_rows

    n = 4000
    p_true = torch.tensor([0.5, 0.25, 0.15, 0.10])
    logits = p_true.log().expand(n, 2, 4)
    tokens = np.tile(np.array([7, 0], np.int32), (n, 1))  # draft 0 at column 1

    seeds = {s: [s, n + s] for s in range(n)}
    out, n_em = _verify_rows(logits, tokens, np.ones(n, np.float32), np.ones(n, bool),
                             np.full(n, 2, np.int32), seeds)
    freq = np.bincount(out[:, 0], minlength=4)[:4] / n
    np.testing.assert_allclose(freq, p_true.numpy(), atol=0.03)
    assert set(np.unique(n_em)) <= {1, 2}
    assert ((n_em == 2) == (out[:, 0] == 0)).all()  # accepted exactly when d came out


def test_ngram_drafter_prompt_lookup_and_cycles():
    from photon_tpu_torch.serve.draft import NGramDrafter

    d = NGramDrafter(max_ngram=3, min_ngram=1)
    d.begin(0, [1, 2, 3, 4, 1, 2, 3])
    assert d.propose(0, 4) == [4, 1, 2, 3]
    d.observe(0, [9])
    assert d.propose(0, 2) == []
    d.observe(0, [9, 9])
    assert d.propose(0, 4) == [9, 9, 9, 9]  # a period-1 cycle: full depth
    d.end(0)
    assert d.propose(0, 4) == []
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=1, min_ngram=2)


def test_spec_controller_throttle_and_probe():
    from photon_tpu_torch.serve.draft import SpecController

    c = SpecController(k_max=4, accept_floor=0.3, ewma_alpha=0.5, probe_ticks=3)
    assert c.next_k() == 4
    c.observe(4, 4)
    assert c.k_effective() == 4
    c.observe(4, 2)  # ewma 0.75
    assert c.next_k() == 3
    for _ in range(6):
        c.observe(4, 0)
    assert c.ewma < 0.3 and c.k_effective() == 0
    assert [c.next_k() for _ in range(4)] == [0, 0, 1, 0]  # the probe at tick 3
    for _ in range(4):
        c.observe(1, 1)
    assert c.k_effective() >= 1
    c2 = SpecController(k_max=2, accept_floor=0.9, probe_ticks=2)
    c2.observe(10, 0)
    assert all(c2.k_effective() == 0 for _ in range(10))  # a pure read
    assert [c2.next_k(), c2.next_k()] == [0, 1]
    c2.set_k_max(0)
    assert [c2.next_k() for _ in range(4)] == [0] * 4  # off, probes included
    with pytest.raises(ValueError):
        c2.set_k_max(-1)


def test_adversarial_traffic_auto_throttles_to_plain_decode():
    """Drafts rejected every step drive the EWMA under the floor: drafting
    stops, the plain step runs again, completions stay exact."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _cfg(probe_ticks=0)
    params = _params(cfg)
    vocab = cfg.model.vocab_size

    class BadDrafter(_FixedDrafter):
        def __init__(self):
            super().__init__()
            self.last = {}

        def observe(self, slot, tokens):
            self.last[slot] = tokens[-1]

        def propose(self, slot, k):
            t = self.last.get(slot, 1)
            return [(t + 17 + i) % vocab or 1 for i in range(k)]

    batcher = ContinuousBatcher(_engine(cfg, params), max_queue=8,
                                speculative=cfg.photon.serve.speculative,
                                drafter=BadDrafter()).start()
    rng = np.random.default_rng(3)
    try:
        for _ in range(3):
            p = list(map(int, rng.integers(1, vocab, 5)))
            assert batcher.submit(p, 12).result(timeout=120) == _offline_greedy(cfg, params, p, 12)
        assert batcher.spec_stats()["k"] == 0 and batcher._spec.ewma < 0.3
        before = batcher._spec.drafted
        p = list(map(int, rng.integers(1, vocab, 5)))
        assert batcher.submit(p, 8).result(timeout=120) == _offline_greedy(cfg, params, p, 8)
        assert batcher._spec.drafted == before
    finally:
        batcher.close()


def test_spec_moe_silently_ineligible():
    """MoE: batch-global expert capacity breaks per-row verification, so
    the batcher serves plain decode (and the engine keeps no prefix
    cache), with no error."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = _cfg("mpt-moe", prefix=True)
    engine = _engine(cfg, _params(cfg))
    b = ContinuousBatcher(engine, speculative=cfg.photon.serve.speculative)
    assert b._spec is None and b._drafter is None and b.spec_stats() is None
    assert engine.prefix_cache is None and engine.prefix_stats() is None


def test_speculative_config_validation():
    for name, bad in (("k", 0), ("k", 33), ("draft_budget", 0), ("min_ngram", 0),
                      ("max_ngram", 0), ("accept_floor", 1.5), ("ewma_alpha", 0.0),
                      ("probe_ticks", -1)):
        cfg = _cfg()
        setattr(cfg.photon.serve.speculative, name, bad)
        with pytest.raises(ValueError, match="speculative"):
            cfg.validate("cpu")
    cfg = _cfg()
    cfg.photon.serve.speculative.min_ngram = 2
    cfg.photon.serve.speculative.max_ngram = 1
    with pytest.raises(ValueError, match="speculative"):
        cfg.validate("cpu")


def test_ctx_width_resets_when_fully_idle():
    """One long request widens the live walk only while a slot is live: a
    fully idle engine drops the high-water mark back to 1."""
    cfg = _cfg(n_slots=2, max_seq=64, spec=False)
    eng = _engine(cfg, _params(cfg))
    eng.begin(0, list(range(1, 41)), 8)  # 48 tokens → 12 blocks → width 16
    _prefill_all(eng, (0,))
    assert eng.attn_stats()["ctx_blocks"] >= 16
    eng.begin(1, [1, 2, 3], 4)
    _prefill_all(eng, (1,))
    eng.evict(0)
    assert eng.attn_stats()["ctx_blocks"] >= 16  # monotone while live
    eng.evict(1)
    assert eng.attn_stats()["ctx_blocks"] == 1.0
    eng.begin(0, [4, 5, 6], 4)
    _prefill_all(eng, (0,))
    assert eng.attn_stats()["ctx_blocks"] == 2.0
