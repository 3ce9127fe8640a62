"""The port's serving path (``photon_tpu_torch``) against the JAX package's.

All CPU, fp32, tiny configs (mpt-wpe, mpt-alibi, llama-gqa) with weights
from the JAX ``init_params`` carried across as numpy arrays:

1. the parameter bridge round-trips byte for byte;
2. ``mixed_chunk_step`` logits and pool bytes match JAX's gather step
   (decode-only and mixed steps, the port's gather and ragged impls),
   max abs 1e-5 on fp32;
3. ``PagedEngine`` greedy completions equal the JAX engine's, with chunk
   budgets that split prompts and blocks recycled after eviction, an MoE
   model (mpt-moe: 4 experts, top-2) included;
4. port-internal pins: per-step logits equal the ``paged_decode_step``
   oracle, no slot/block leaks, seeded sampling reproducible and
   independent of batch-mates;
5. a round written by the JAX checkpoint manager serves in the port;
6. scheduler + HTTP frontend end to end (blocking, streaming, 429, drain);
7. import hygiene; 8. the CPU is used only when asked for.
"""

import ast
import http.client
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_tpu.config.schema import Config as JaxConfig
from tests._helpers import tiny_llama_config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: fp32 logits: the two frameworks sum matmuls in different orders
LOGIT_ATOL = 1e-5
CONFIGS = ["mpt-wpe", "mpt-alibi", "llama-gqa"]


def _jax_cfg(kind: str, *, n_slots=2, block_size=4, max_seq=32, max_new=8,
             budget=2048) -> JaxConfig:
    if kind == "llama-gqa":
        cfg = tiny_llama_config(n_kv_heads=2)
    else:
        cfg = JaxConfig()
        m = cfg.model
        m.d_model, m.n_layers, m.n_heads, m.vocab_size = 32, 2, 4, 96
        m.attn_impl, m.compute_dtype = "xla", "float32"
        m.alibi = kind == "mpt-alibi"
        m.learned_pos_emb = not m.alibi
        if kind.startswith("mpt-moe"):  # the step routes n_slots · Tq tokens in one pool
            m.mlp, m.moe_num_experts, m.moe_top_k = "moe", 4, 2
            m.moe_mlp_act = "swiglu" if kind.endswith("swiglu") else "gelu"
    cfg.model.max_seq_len = max_seq
    s = cfg.photon.serve
    s.n_slots, s.block_size, s.max_new_tokens = n_slots, block_size, max_new
    s.prefill_token_budget = budget
    return cfg.validate()


def _port_cfg(jcfg: JaxConfig, **serve):
    from photon_tpu_torch.config.schema import Config

    cfg = Config.from_dict(jcfg.to_dict())
    for k, v in serve.items():
        setattr(cfg.photon.serve, k, v)
    return cfg.validate("cpu")


def _weights(jcfg: JaxConfig, seed=0):
    """(JAX params, port params) holding the same numbers."""
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.codec.params import params_from_numpy

    jp = init_params(jcfg.model, seed=seed)
    meta, arrays = params_to_ndarrays(jp)
    return jp, params_from_numpy(meta.names, arrays, _port_cfg(jcfg).model, "cpu")


def _prompts(seed, n, vocab, lo=3, hi=13):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, rng.integers(lo, hi)))) for _ in range(n)]


def _drive(eng, reqs, max_new, budget):
    """The scheduler's loop, shared by both engines: FIFO admission, one
    chunk of at most ``budget`` tokens per step (oldest request first),
    decode rows riding along, eviction at ``max_new``. ``reqs`` holds
    prompts or (prompt, temperature, seed) triples."""
    reqs = [r if isinstance(r, tuple) else (r, 0.0, 0) for r in reqs]
    queue, running = list(enumerate(reqs)), {}
    out = {i: [] for i in range(len(reqs))}
    while queue or running:
        while queue and eng.free_slot() is not None \
                and eng.can_admit(len(queue[0][1][0]), max_new):
            i, (prompt, temp, seed) = queue.pop(0)
            slot = eng.free_slot()
            eng.begin(slot, prompt, max_new, temperature=temp, seed=seed)
            running[slot] = i
        pre = [s for s in running if eng.pending_tokens(s) > 0]
        chunk = None
        if pre:
            s = min(pre, key=lambda s: running[s])
            chunk = (s, min(eng.pending_tokens(s), budget))
        nxt, emitted = eng.mixed_step(chunk)
        for s in sorted(running):
            if emitted[s]:
                out[running[s]].append(int(nxt[s]))
                if len(out[running[s]]) >= max_new:
                    eng.evict(s)
                    del running[s]
    return [out[i] for i in range(len(reqs))]


# ---------------------------------------------------------------------------
# 1. parameter bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", CONFIGS)
def test_params_roundtrip_byte_identical(kind):
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.codec.params import (
        params_from_ndarrays,
        params_from_numpy,
        params_to_numpy,
    )
    from photon_tpu_torch.codec.params import params_to_ndarrays as params_to_ndarrays_port
    from photon_tpu_torch.models.mpt import init_params as port_init
    from photon_tpu_torch.models.mpt import param_shapes

    jcfg = _jax_cfg(kind)
    meta, arrays = params_to_ndarrays(init_params(jcfg.model, seed=3))
    pcfg = _port_cfg(jcfg)
    names, back = params_to_numpy(params_from_numpy(meta.names, arrays, pcfg.model, "cpu"))
    assert tuple(names) == meta.names
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    # the port's own init builds the same tree (names, shapes, dtypes), and
    # the codec fills that template with the JAX arrays byte for byte
    template = port_init(pcfg.model, seed=3)
    pn, pa = params_to_numpy(template)
    assert tuple(pn) == meta.names == tuple(param_shapes(pcfg.model))
    assert [(a.shape, a.dtype) for a in pa] == [(a.shape, a.dtype) for a in arrays]
    _, again = params_to_ndarrays_port(params_from_ndarrays(template, meta, arrays))
    assert all(a.tobytes() == b.tobytes() for a, b in zip(arrays, again))


def test_params_from_numpy_rejects_wrong_tree():
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.codec.params import params_from_numpy

    jcfg = _jax_cfg("mpt-wpe")
    meta, arrays = params_to_ndarrays(init_params(jcfg.model, seed=0))
    with pytest.raises(ValueError):
        params_from_numpy(meta.names, arrays, _port_cfg(_jax_cfg("llama-gqa")).model)


# ---------------------------------------------------------------------------
# 2. one mixed step against JAX's
# ---------------------------------------------------------------------------

def _step_inputs(kind_step, n_slots, bs, max_blocks, n_blocks, seed):
    """A hand-built state and step: slot 0 decodes at position 9; in the
    mixed step slot 1 prefills positions 5..10 of its prompt (a chunk
    padded to 8), otherwise slot 1 decodes at position 6."""
    rng = np.random.default_rng(seed)
    tables = np.full((n_slots, max_blocks), n_blocks, np.int32)
    perm = rng.permutation(n_blocks)
    tables[0, :4] = perm[:4]
    tables[1, :4] = perm[4:8]
    if kind_step == "mixed":
        tq, chunk_pos = 8, np.arange(5, 11)
        lengths = np.array([9, 5], np.int32)
    else:
        tq, chunk_pos = 1, None
        lengths = np.array([9, 6], np.int32)
    tokens = np.zeros((n_slots, tq), np.int32)
    positions = np.zeros((n_slots, tq), np.int32)
    q_valid = np.zeros((n_slots, tq), bool)
    emit_off = np.zeros(n_slots, np.int32)
    lengths_after = lengths.copy()
    tokens[0, 0], positions[0, 0], q_valid[0, 0] = 7, 9, True
    lengths_after[0] = 10
    if chunk_pos is None:
        tokens[1, 0], positions[1, 0], q_valid[1, 0] = 11, 6, True
        lengths_after[1] = 7
    else:
        n = len(chunk_pos)
        tokens[1, :n] = rng.integers(1, 90, n)
        positions[1, :n] = chunk_pos
        q_valid[1, :n] = True
        emit_off[1] = n - 1
        lengths_after[1] = chunk_pos[-1] + 1
    return dict(tables=tables, lengths=lengths, tokens=tokens, positions=positions,
                q_valid=q_valid, emit_off=emit_off, lengths_after=lengths_after)


@pytest.mark.parametrize("impl", ["gather", "ragged"])
@pytest.mark.parametrize("kind_step", ["decode", "mixed"])
@pytest.mark.parametrize("kind", CONFIGS)
def test_mixed_chunk_step_matches_jax(kind, kind_step, impl):
    import jax.numpy as jnp

    from photon_tpu.serve.cache import PagedState as JState
    from photon_tpu.serve.cache import mixed_chunk_step as jax_step
    from photon_tpu_torch.models.decode import compute_params, layer_params
    from photon_tpu_torch.serve.cache import PagedState, mixed_chunk_step

    jcfg = _jax_cfg(kind)
    pcfg = _port_cfg(jcfg)
    jp, tp = _weights(jcfg, seed=1)
    mc = jcfg.model
    bs, max_blocks, n_blocks = 4, 8, 12
    n_kv = mc.n_kv_heads or mc.n_heads
    rng = np.random.default_rng(5)
    pool_shape = (n_blocks + 1, mc.n_layers, bs, n_kv, mc.d_head)
    ck = rng.standard_normal(pool_shape).astype(np.float32)
    cv = rng.standard_normal(pool_shape).astype(np.float32)
    x = _step_inputs(kind_step, 2, bs, max_blocks, n_blocks, seed=2)
    has_chunk = kind_step == "mixed"
    n_ctx = 4

    jlg, jstate = jax_step(
        jp, JState(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(x["tables"]),
                   jnp.asarray(x["lengths"])),
        jnp.asarray(x["tokens"]), jnp.asarray(x["positions"]), jnp.asarray(x["q_valid"]),
        jnp.asarray(x["emit_off"]), jnp.asarray(x["lengths_after"]), jnp.int32(1), mc,
        n_ctx=n_ctx, has_chunk=has_chunk, impl="gather",
    )
    params = compute_params(tp, pcfg.model, torch.device("cpu"))
    layers = [layer_params(params, i) for i in range(mc.n_layers)]
    state = PagedState(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
                       torch.from_numpy(x["tables"]), torch.from_numpy(x["lengths"]))
    lg, state = mixed_chunk_step(
        params, layers, state, torch.from_numpy(x["tokens"]).long(),
        torch.from_numpy(x["positions"]), torch.from_numpy(x["q_valid"]),
        torch.from_numpy(x["emit_off"]), torch.from_numpy(x["lengths_after"]), 1,
        pcfg.model, n_ctx=n_ctx, has_chunk=has_chunk, impl=impl,
    )
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0, atol=LOGIT_ATOL)
    # every live block's bytes (the trash block takes colliding pad writes)
    for mine, ref in ((state.cache_k, jstate.cache_k), (state.cache_v, jstate.cache_v)):
        np.testing.assert_allclose(mine.numpy()[:-1], np.asarray(ref)[:-1], rtol=0,
                                   atol=LOGIT_ATOL)
    np.testing.assert_array_equal(state.lengths.numpy(), np.asarray(jstate.lengths))


# ---------------------------------------------------------------------------
# 3. engine greedy completions against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,budget", [("mpt-wpe", 4), ("mpt-wpe", 2048),
                                         ("mpt-alibi", 5), ("llama-gqa", 4),
                                         ("mpt-moe", 4), ("mpt-moe-swiglu", 5)])
def test_engine_greedy_matches_jax(kind, budget):
    from photon_tpu.serve.engine import PagedEngine as JaxEngine
    from photon_tpu_torch.serve.engine import PagedEngine

    jcfg = _jax_cfg(kind, budget=budget)
    jp, tp = _weights(jcfg)
    prompts = _prompts(4, 5, jcfg.model.vocab_size)  # 5 requests > 2 slots: blocks recycle
    max_new = 6
    ref = _drive(JaxEngine(jcfg, jp), prompts, max_new, budget)
    eng = PagedEngine(_port_cfg(jcfg), tp, device="cpu")
    assert _drive(eng, prompts, max_new, budget) == ref
    assert eng.allocator.free_blocks == eng.n_blocks


# ---------------------------------------------------------------------------
# 4. port-internal pins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", CONFIGS)
def test_paged_logits_match_decode_oracle(kind):
    from photon_tpu_torch.serve.cache import paged_decode_step
    from photon_tpu_torch.serve.engine import PagedEngine

    jcfg = _jax_cfg(kind)
    _, tp = _weights(jcfg)
    eng = PagedEngine(_port_cfg(jcfg), tp, device="cpu")
    for slot, prompt in enumerate(_prompts(8, 2, jcfg.model.vocab_size)):
        eng.admit(slot, prompt, 8)
    for _ in range(5):
        snap = eng.state.clone()
        active = torch.from_numpy(eng._active.copy())
        token = torch.from_numpy(eng._last.astype(np.int64))
        oracle, _ = paged_decode_step(eng.params, eng._layers, snap, token, eng.mc, active)
        eng.step()
        np.testing.assert_allclose(eng.last_logits.numpy(), oracle.numpy(), rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_array_equal(snap.lengths.numpy(), eng.state.lengths.numpy())


def test_block_allocator_refcounts_and_guards():
    from photon_tpu_torch.serve.cache import BlockAllocator, BlockLeakError

    a = BlockAllocator(4)
    ids = a.alloc(3)
    assert ids == [0, 1, 2] and a.free_blocks == 1
    assert a.alloc(2) is None and a.free_blocks == 1  # no partial allocation
    a.retain([ids[0]])
    a.free([ids[0]])
    assert a.held_blocks == 3  # a shared block survives its first free
    a.free(ids)
    assert a.free_blocks == 4 and a.held_blocks == 0
    with pytest.raises(BlockLeakError):
        a.free([0])
    with pytest.raises(BlockLeakError):
        a.retain([1])
    assert a.alloc(1) == [2]  # LIFO: the last block freed is handed out first


def test_no_leaks_across_random_stream():
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    jcfg = _jax_cfg("mpt-wpe", n_slots=3, max_seq=48)
    _, tp = _weights(jcfg)
    pcfg = _port_cfg(jcfg, n_blocks=20)
    eng = PagedEngine(pcfg, tp, device="cpu")
    b = ContinuousBatcher(eng, max_queue=64, prefill_token_budget=6, default_eos_id=5).start()
    try:
        rng = np.random.default_rng(13)
        reqs = [b.submit(p, int(rng.integers(1, 9))) for p in _prompts(17, 14, 96, 1, 30)]
        outs = [r.result(timeout=120) for r in reqs]
    finally:
        b.close()
    for r, out in zip(reqs, outs):
        assert r.error is None and 1 <= len(out) <= r.max_new_tokens
        assert len(out) == r.max_new_tokens or out[-1] == 5  # EOS ends early
    assert list(b.admitted_order) == [r.rid for r in reqs]  # FIFO
    assert eng.n_active == 0 and not eng._pending
    assert eng.allocator.free_blocks == eng.n_blocks and eng.allocator.held_blocks == 0
    assert b.completed == len(reqs) and b.evictions == len(reqs)


def test_seeded_sampling_reproducible_and_batch_independent():
    from photon_tpu_torch.serve.engine import PagedEngine

    jcfg = _jax_cfg("mpt-wpe", n_slots=3, max_seq=40)
    _, tp = _weights(jcfg)
    target = (_prompts(21, 1, 96)[0], 1.0, 1234)

    def run(reqs):
        return _drive(PagedEngine(_port_cfg(jcfg), tp, device="cpu"), reqs, 10, 4)

    alone = run([target])[0]
    assert run([target])[0] == alone
    mates = [(p, t, s) for p, t, s in zip(_prompts(22, 4, 96), [0.0, 0.7, 1.3, 0.0],
                                         [1, 2, 3, 4])]
    assert run([mates[0], target, *mates[1:]])[1] == alone
    assert run([mates[1], mates[2], target])[2] == alone
    other_seed = run([(target[0], 1.0, 99)])[0]
    assert other_seed != alone  # the seed does pick the stream


# ---------------------------------------------------------------------------
# 5. a JAX-written round serves in the port
# ---------------------------------------------------------------------------

def test_jax_checkpoint_serves_in_port(tmp_path):
    from photon_tpu.checkpoint import FileStore as JaxStore
    from photon_tpu.checkpoint.server import ServerCheckpointManager as JaxManager
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.models.mpt import init_params
    from photon_tpu.serve.engine import PagedEngine as JaxEngine
    from photon_tpu_torch.checkpoint import FileStore
    from photon_tpu_torch.serve.engine import PagedEngine

    jcfg = _jax_cfg("llama-gqa", budget=4)
    jcfg.run_uuid = "fedrun"
    mgr = JaxManager(JaxStore(tmp_path / "store"), "fedrun")
    for rnd, seed in ((1, 0), (2, 7)):
        mgr.save_round(rnd, *params_to_ndarrays(init_params(jcfg.model, seed=seed)))
    jcfg.to_yaml(tmp_path / "resolved.yaml")
    from photon_tpu_torch.config.schema import Config

    pcfg = Config.from_yaml(tmp_path / "resolved.yaml").validate("cpu")
    eng = PagedEngine.from_checkpoint(pcfg, store=FileStore(tmp_path / "store"), device="cpu")
    assert eng.loaded_round == 2
    ref_eng = JaxEngine.from_checkpoint(jcfg, store=JaxStore(tmp_path / "store"))
    prompts = _prompts(30, 3, jcfg.model.vocab_size)
    assert _drive(eng, prompts, 5, 4) == _drive(ref_eng, prompts, 5, 4)


def test_port_checkpoint_roundtrip_and_crc(tmp_path):
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models.mpt import init_params

    pcfg = _port_cfg(_jax_cfg("mpt-wpe"))
    store = FileStore(tmp_path)
    mgr = ServerCheckpointManager(store, "r")
    meta, arrays = params_to_ndarrays(init_params(pcfg.model, seed=1))
    mgr.save_round(1, meta, arrays)
    mgr.save_round(2, meta, arrays)
    m2, a2 = mgr.load_round_params(2)
    assert m2 == meta and all(np.array_equal(x, y) for x, y in zip(arrays, a2))
    # a bit-flipped newest round is skipped for the previous good one
    key = "r/server/2/current_server_parameters.npz"
    data = bytearray(store.get(key))
    data[len(data) // 2] ^= 0xFF
    store.put(key, bytes(data))
    with pytest.warns(UserWarning):
        assert ServerCheckpointManager(store, "r").resolve_resume_round(-1) == 1


# ---------------------------------------------------------------------------
# 6. scheduler + HTTP frontend
# ---------------------------------------------------------------------------

def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read().decode()


def test_http_end_to_end(tmp_path):
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.frontend import ServeFrontend
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    jcfg = _jax_cfg("mpt-wpe", budget=4)
    jp, tp = _weights(jcfg)
    eng = PagedEngine(_port_cfg(jcfg), tp, device="cpu")
    batcher = ContinuousBatcher(eng, max_queue=1, prefill_token_budget=4)
    fe = ServeFrontend(batcher, max_new_tokens_cap=6)
    port = fe.start()
    try:
        prompt = _prompts(40, 1, 96)[0]
        # driver not started yet: one queued request fills the queue → 429
        queued = batcher.submit(prompt, 4)
        status, body = _post(port, {"tokens": prompt, "max_new_tokens": 4})
        assert status == 429 and "queue full" in body
        batcher.start()
        assert len(queued.result(timeout=60)) == 4
        status, body = _post(port, {"tokens": prompt, "max_new_tokens": 6})
        assert status == 200
        blocking = json.loads(body)
        assert blocking["n_generated"] == 6 and blocking["n_prompt"] == len(prompt)
        assert blocking["tokens"][:4] == queued.generated
        status, body = _post(port, {"tokens": prompt, "max_new_tokens": 6, "stream": True})
        lines = [json.loads(x) for x in body.strip().splitlines()]
        assert status == 200 and lines[-1]["done"]
        assert [x["token"] for x in lines[:-1]] == blocking["tokens"]
        assert _post(port, {"text": "hi"})[0] == 400
        assert _post(port, {"tokens": [10 ** 6]})[0] == 400
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["attn_impl"] == "ragged-ref"
        assert health["completed"] == 3 and health["rejected"] == 1
        fe.mark_draining()
        assert _post(port, {"tokens": prompt})[0] == 503
        assert batcher.drain(10.0)
    finally:
        fe.close()
        batcher.close()


def test_http_text_prompt_with_tokenizer(tmp_path):
    """With a tokenizer (``--tokenizer byte-fallback``) a ``"text"`` prompt
    is tokenized by the server and the reply carries the completion's
    text; the same prompt as ``"tokens"`` gives the same tokens."""
    from photon_tpu_torch.data.tokenizer import load_tokenizer
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.frontend import ServeFrontend
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    jcfg = _jax_cfg("mpt-wpe", budget=4)
    jcfg.model.vocab_size = 260  # the byte tokenizer's ids fit
    jcfg.validate()
    _, tp = _weights(jcfg)
    eng = PagedEngine(_port_cfg(jcfg), tp, device="cpu")
    batcher = ContinuousBatcher(eng, max_queue=4, prefill_token_budget=4).start()
    tok = load_tokenizer("byte-fallback")
    fe = ServeFrontend(batcher, max_new_tokens_cap=6, tokenizer=tok)
    port = fe.start()
    try:
        status, body = _post(port, {"text": "héllo", "max_new_tokens": 5})
        assert status == 200
        rep = json.loads(body)
        assert rep["n_prompt"] == len("héllo".encode()) and rep["n_generated"] == 5
        assert rep["text"] == tok.decode(rep["tokens"])
        status, body = _post(port, {"tokens": tok.encode("héllo"), "max_new_tokens": 5})
        assert status == 200 and json.loads(body)["tokens"] == rep["tokens"]
        assert _post(port, {"text": 5})[0] == 400
    finally:
        fe.close()
        batcher.close()


# ---------------------------------------------------------------------------
# 7. import hygiene, 8. device rules, config gating
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_or_reference_package():
    files = sorted((ROOT / "photon_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "optax", "photon_tpu"):
                    bad.append(f"{f.relative_to(ROOT)}:{node.lineno} {m}")
    assert len(files) > 15 and not bad, bad
    assert {ROOT / "photon_tpu_torch/serve/router.py", ROOT / "photon_tpu_torch/serve/fleet.py"} \
        <= set(files)


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, photon_tpu_torch.serve.engine, photon_tpu_torch.serve.frontend, "
            "photon_tpu_torch.serve.__main__, photon_tpu_torch.centralized, "
            "photon_tpu_torch.train.trainer, photon_tpu_torch.ops.flash_attention, "
            "photon_tpu_torch.federated, photon_tpu_torch.eval.__main__, "
            "photon_tpu_torch.data.convert, photon_tpu_torch.models.decode, "
            "photon_tpu_torch.ops.moe, photon_tpu_torch.config, "
            "photon_tpu_torch.serve.router, photon_tpu_torch.serve.fleet; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'photon_tpu')))")
    out = subprocess.run([sys.executable, "-S", "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_engine_without_device_raises_without_cuda(monkeypatch):
    from photon_tpu_torch.serve.engine import PagedEngine

    jcfg = _jax_cfg("mpt-wpe")
    _, tp = _weights(jcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedEngine(_port_cfg(jcfg), tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedEngine(_port_cfg(jcfg), tp, device="cuda")
    assert PagedEngine(_port_cfg(jcfg), tp, device="cpu").device.type == "cpu"


#: serving features the port runs: (section path, on-switch, an invalid
#: value and the JAX package's error text for it)
PORTED_FEATURES = {
    "speculative": (("speculative", "enabled"), True, ("speculative", "k"), 0,
                    "serve.speculative.k must be in"),
    "prefix_cache": (("prefix_cache",), True, ("prefix_cache_blocks",), -1,
                     "serve.prefix_cache_blocks must be >= 0"),
    "hotswap": (("hotswap",), True, ("hotswap_poll_s",), 0.0,
                "serve.hotswap_poll_s must be > 0"),
    "fleet": (("fleet", "enabled"), True, ("fleet", "replicas"), 0,
              "serve.fleet.replicas must be >= 1"),
}


def _set(d, path, value):
    for key in path[:-1]:
        d = d[key]
    d[path[-1]] = value


@pytest.mark.parametrize("feature", ["moe", "adapters", "speculative", "prefix_cache",
                                     "hotswap", "fleet"])
def test_unported_features_refused(feature):
    """Features the port does not run are refused with NotImplementedError;
    the features it runs validate when on, and an invalid value raises the
    JAX package's ValueError (the same text as JAX's). Adapters and the
    fleet run; the collective plane (the JAX package's adapter round loop)
    is refused."""
    from photon_tpu_torch.config.schema import Config

    d = _jax_cfg("mpt-wpe").to_dict()
    if feature in PORTED_FEATURES:
        on, value, bad, bad_value, text = PORTED_FEATURES[feature]
        _set(d["photon"]["serve"], on, value)
        JaxConfig.from_dict(d).validate()
        Config.from_dict(d).validate("cpu")
        _set(d["photon"]["serve"], bad, bad_value)
        with pytest.raises(ValueError, match=text):
            JaxConfig.from_dict(d).validate()
        with pytest.raises(ValueError, match=text):
            Config.from_dict(d).validate("cpu")
        return
    if feature == "moe":  # MoE is ported; an expert mesh is not
        d["model"].update(mlp="moe", moe_num_experts=4)
        Config.from_dict(d).validate("cpu")
        d["mesh"]["expert"] = 2
    elif feature == "adapters":  # adapters are ported; their collective round loop is not
        d["photon"]["adapters"].update(enabled=True, cohorts={"a": [0]})
        JaxConfig.from_dict(d).validate()
        Config.from_dict(d).validate("cpu")
        d["photon"]["adapters"]["rank"] = 0
        for cfg in (JaxConfig.from_dict(d), Config.from_dict(d)):
            with pytest.raises(ValueError, match="rank must be >= 1"):
                cfg.validate()
        d["photon"]["adapters"]["rank"] = 8
        d["photon"]["comm_stack"]["collective"] = True
    else:
        d["photon"]["serve"][feature]["enabled"] = True
    with pytest.raises(NotImplementedError):
        Config.from_dict(d).validate("cpu")


def test_param_dtype_other_than_float32_refused():
    """JAX builds every parameter in ``model.param_dtype``; the port keeps
    fp32 parameters, so it refuses any other value (its parameter list
    would part from JAX's). At float32 the two packages' parameter lists
    carry the same dtypes."""
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.models.mpt import init_params as jax_init
    from photon_tpu_torch.codec.params import params_to_ndarrays as port_to_ndarrays
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.models.mpt import init_params

    jcfg = _jax_cfg("mpt-wpe")
    jcfg.model.param_dtype = "bfloat16"
    jmeta, _ = params_to_ndarrays(jax_init(jcfg.validate().model, seed=0))
    assert "bfloat16" in jmeta.dtypes
    for serving in (False, True):
        with pytest.raises(NotImplementedError, match="model.param_dtype='bfloat16'"):
            Config.from_dict(jcfg.to_dict()).validate("cpu", serving=serving)
    jcfg.model.param_dtype = "float32"
    jmeta, _ = params_to_ndarrays(jax_init(jcfg.validate().model, seed=0))
    pmeta, _ = port_to_ndarrays(init_params(_port_cfg(jcfg).model, seed=0))
    assert pmeta.names == jmeta.names and pmeta.dtypes == jmeta.dtypes
    assert set(pmeta.dtypes) == {"float32"}


def test_config_reads_jax_yaml_and_presets(tmp_path):
    from photon_tpu.config import load_preset as jax_preset
    from photon_tpu_torch.config import load_preset
    from photon_tpu_torch.config.schema import Config

    from photon_tpu.config import list_presets

    assert len(list_presets()) == 8
    for name in list_presets():
        assert load_preset(name).model.__dict__ == jax_preset(name).model.__dict__
    jcfg = _jax_cfg("llama-gqa")
    jcfg.to_yaml(tmp_path / "a.yaml")
    pcfg = Config.from_yaml(tmp_path / "a.yaml")
    assert pcfg.model.__dict__ == jcfg.model.__dict__
    pcfg.to_yaml(tmp_path / "b.yaml")
    assert JaxConfig.from_yaml(tmp_path / "b.yaml").model == jcfg.model
    bad = jcfg.to_dict()
    bad["photon"]["serve"]["attention_impl"] = "flash"
    with pytest.raises(ValueError):
        Config.from_dict(bad).validate("cpu")
