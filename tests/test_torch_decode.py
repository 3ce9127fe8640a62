"""The port's KV-cache decoding (``photon_tpu_torch/models/decode.py``)
against the JAX package's, and against itself.

CPU, fp32, the tiny configs of ``tests/test_decode.py`` (mpt-wpe,
mpt-alibi, llama-gqa) with the JAX weights carried across as numpy
arrays. One counterpart per case of ``tests/test_decode.py``:

- ``prefill`` logits equal JAX's and the port's full forward at each
  row's cursor (max abs 2e-5), and its caches equal JAX's;
- cached greedy generation equals JAX's token for token and the port's
  full-forward decoder;
- numpy-loaded params, the one-step call, the overflow check, sampling
  (port against port, seeded), the EOS freeze and early exit;
- bf16: cached greedy equals the full-forward greedy.

Port-internal pins: paged decode equals contiguous decode bit for bit at
every step (mirroring ``tests/test_serve.py:69``), an MoE model included
(both route one batch through ``decode_layers``); with no gradient to
take, the flash attention runs its forward alone.

MoE (``mpt-moe``, gelu and SwiGLU experts): prefill over right-padded
prompts (its mask keeps padding out of the capacity pool) and cached
greedy generation equal JAX's.
"""

import numpy as np
import pytest
import torch

from photon_tpu.config.schema import Config as JaxConfig
from tests._helpers import tiny_llama_config

torch.backends.cuda.matmul.allow_tf32 = False
#: fp32 on the CPU: the frameworks sum matmuls in different orders
LOGIT_ATOL = 2e-5
NAMES = ["mpt-wpe", "mpt-alibi", "llama-gqa"]


def _mpt_cfg(alibi: bool) -> JaxConfig:
    cfg = JaxConfig()
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 32, 2, 4, 24, 96
    m.attn_impl, m.compute_dtype = "xla", "float32"
    m.alibi = alibi
    m.learned_pos_emb = not alibi
    return cfg.validate()


def _jax_cfg(name: str) -> JaxConfig:
    if name == "llama-gqa":
        return tiny_llama_config(n_kv_heads=2)
    cfg = _mpt_cfg(alibi=name == "mpt-alibi")
    if name.startswith("mpt-moe"):  # 4 experts, top-2, tight capacity
        m = cfg.model
        m.mlp, m.moe_num_experts, m.moe_top_k, m.moe_capacity_factor = "moe", 4, 2, 1.0
        m.moe_mlp_act = "swiglu" if name.endswith("swiglu") else "gelu"
    return cfg.validate()


def _port_cfg(jcfg: JaxConfig):
    from photon_tpu_torch.config.schema import Config

    return Config.from_dict(jcfg.to_dict()).validate("cpu")


def _weights(jcfg: JaxConfig, seed: int):
    """(JAX params, the port's tree holding the same numbers)."""
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.codec.params import params_from_numpy

    jp = init_params(jcfg.model, seed=seed)
    meta, arrays = params_to_ndarrays(jp)
    return jp, params_from_numpy(meta.names, arrays, _port_cfg(jcfg).model, "cpu")


def _prompts(vocab: int, lengths, s: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lengths), s), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(1, vocab, n)
    return tokens


def _full_forward_generate(mc, params, tokens, lengths, n):
    """The port's full-forward greedy decoder, ``n`` steps."""
    from photon_tpu_torch.eval.icl import make_generate_fn
    from photon_tpu_torch.models.mpt import MPTModel

    model = MPTModel(mc)
    step = make_generate_fn(lambda p, t: model(p, t), params)
    t, c = torch.from_numpy(tokens), torch.from_numpy(lengths)
    for _ in range(n):
        t, c = step(t, c)
    return t.numpy(), c.numpy()


def test_moe_config_refused():
    """An MoE config validates (``tests/test_torch_moe.py`` decodes one);
    what is still refused is an expert mesh, which needs more than one
    device."""
    cfg = _mpt_cfg(alibi=False)
    cfg.model.mlp, cfg.model.moe_num_experts, cfg.model.moe_top_k = "moe", 4, 2
    assert _port_cfg(cfg.validate()).model.mlp == "moe"
    cfg.mesh.expert = 2
    with pytest.raises(NotImplementedError, match="mesh"):
        _port_cfg(cfg.validate())


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_match_jax_and_full_forward(name):
    import jax.numpy as jnp

    from photon_tpu.models.decode import prefill as jax_prefill
    from photon_tpu_torch.models.decode import prefill
    from photon_tpu_torch.models.mpt import MPTModel

    jcfg = _jax_cfg(name)
    mc = _port_cfg(jcfg).model
    jp, tp = _weights(jcfg, seed=4)
    s = 16
    tokens = np.random.default_rng(0).integers(0, mc.vocab_size, (3, s), dtype=np.int32)
    lengths = np.asarray([5, 16, 9], np.int32)

    want, jst = jax_prefill(jp, jnp.asarray(tokens), jnp.asarray(lengths), jcfg.model)
    logits, st = prefill(tp, torch.from_numpy(tokens), torch.from_numpy(lengths), mc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    full = MPTModel(mc)(tp, torch.from_numpy(tokens).long())
    at_cursor = full[torch.arange(3), torch.from_numpy(lengths).long() - 1]
    np.testing.assert_allclose(logits.numpy(), at_cursor.detach().numpy(), rtol=0,
                               atol=LOGIT_ATOL)
    assert st.cache_k.shape == (2, 3, s, mc.kv_heads, mc.d_head)
    assert st.lengths.dtype == torch.int32 and st.lengths.tolist() == lengths.tolist()
    for got, ref in ((st.cache_k, jst.cache_k), (st.cache_v, jst.cache_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_cached_generate_matches_jax_and_full_forward(name):
    import jax.numpy as jnp

    from photon_tpu.models.decode import make_cached_generate_fn as jax_cached
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    jcfg = _jax_cfg(name)
    mc = _port_cfg(jcfg).model
    jp, tp = _weights(jcfg, seed=4)
    gen = 6
    lengths = np.asarray([4, 7, 10], np.int32)
    tokens = _prompts(mc.vocab_size, lengths, 16, seed=1)

    want, want_len = jax_cached(jcfg.model, jp).many(jnp.asarray(tokens),
                                                     jnp.asarray(lengths), gen)
    got, got_len = make_cached_generate_fn(mc, tp).many(tokens, lengths, gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    oracle, oracle_len = _full_forward_generate(mc, tp, tokens, lengths, gen)
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got_len.numpy(), oracle_len)


@pytest.mark.parametrize("name", ["mpt-moe", "mpt-moe-swiglu"])
def test_moe_prefill_and_generate_match_jax(name):
    """Prefill over right-padded prompts (padding claims no capacity in
    either package), its caches, and cached greedy generation, against
    JAX's; the decode steps route every row of the batch, as JAX's do."""
    import jax.numpy as jnp

    from photon_tpu.models.decode import make_cached_generate_fn as jax_cached
    from photon_tpu.models.decode import prefill as jax_prefill
    from photon_tpu_torch.models.decode import make_cached_generate_fn, prefill

    jcfg = _jax_cfg(name)
    mc = _port_cfg(jcfg).model
    jp, tp = _weights(jcfg, seed=4)
    lengths = np.asarray([5, 16, 9], np.int32)
    tokens = _prompts(mc.vocab_size, lengths, 24, seed=2)
    want, jst = jax_prefill(jp, jnp.asarray(tokens), jnp.asarray(lengths), jcfg.model)
    logits, st = prefill(tp, torch.from_numpy(tokens), torch.from_numpy(lengths), mc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    for got, ref in ((st.cache_k, jst.cache_k), (st.cache_v, jst.cache_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=LOGIT_ATOL)
    gen = 6
    want, want_len = jax_cached(jcfg.model, jp).many(jnp.asarray(tokens), jnp.asarray(lengths),
                                                     gen)
    got, got_len = make_cached_generate_fn(mc, tp).many(tokens, lengths, gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_cached_generate_with_npz_params():
    """Params read from an ``.npz`` the JAX package wrote (the eval CLI's
    ``--params-npz`` path: numpy arrays into the port's tree) decode."""
    from photon_tpu.checkpoint import arrays_to_npz
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.checkpoint.serialization import npz_to_arrays
    from photon_tpu_torch.codec.params import params_from_numpy
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    jcfg = _mpt_cfg(alibi=False)
    meta, arrays = npz_to_arrays(arrays_to_npz(*params_to_ndarrays(
        init_params(jcfg.model, seed=0))))
    mc = _port_cfg(jcfg).model
    fn = make_cached_generate_fn(mc, params_from_numpy(meta.names, arrays, mc, "cpu"))
    tokens = np.zeros((2, 12), np.int32)
    tokens[:, :3] = 5
    t, lens = fn.many(tokens, np.asarray([3, 3], np.int32), 4)
    assert lens.tolist() == [7, 7] and tuple(t.shape) == (2, 12)


def test_cached_one_step_signature_matches_oracle():
    from photon_tpu_torch.models.decode import make_cached_generate_fn
    from photon_tpu_torch.models.mpt import MPTModel

    jcfg = _mpt_cfg(alibi=False)
    mc = _port_cfg(jcfg).model
    _, tp = _weights(jcfg, seed=0)
    model = MPTModel(mc)
    fn = make_cached_generate_fn(mc, tp, lambda p, t: model(p, t))
    tokens = np.zeros((2, 8), np.int32)
    tokens[:, 0] = 3
    lengths = np.asarray([1, 1], np.int32)
    t2, l2 = fn(tokens, lengths)
    assert tuple(t2.shape) == tokens.shape and int(l2[0]) == 2
    many, _ = fn.many(tokens, lengths, 1)
    np.testing.assert_array_equal(t2.numpy(), many.numpy())
    with pytest.raises(ValueError, match="model_apply"):
        make_cached_generate_fn(mc, tp)(tokens, lengths)


def test_many_rejects_buffer_overflow():
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    jcfg = _mpt_cfg(alibi=False)
    mc = _port_cfg(jcfg).model
    fn = make_cached_generate_fn(mc, _weights(jcfg, seed=0)[1])
    with pytest.raises(ValueError, match="decode overflow"):
        fn.many(np.zeros((1, 8), np.int32), np.asarray([6], np.int32), 4)


def test_generate_sampling_modes():
    """Temperature 0 is the greedy cached path; a seed reproduces its
    draws; top_k=1 is greedy at any temperature; a sampled token lies in
    the top-k support (port against port: the draws are not JAX's)."""
    from photon_tpu_torch.models.decode import generate, make_cached_generate_fn, prefill

    jcfg = _mpt_cfg(alibi=False)
    mc = _port_cfg(jcfg).model
    _, tp = _weights(jcfg, seed=0)
    tokens = np.zeros((2, 16), np.int32)
    tokens[:, :3] = [[5, 9, 2], [7, 1, 4]]
    lengths = np.asarray([3, 3], np.int32)
    tt, tl = torch.from_numpy(tokens), torch.from_numpy(lengths)

    greedy, _ = generate(tp, tt, tl, mc, 5, temperature=0.0)
    oracle, _ = make_cached_generate_fn(mc, tp).many(tokens, lengths, 5)
    np.testing.assert_array_equal(greedy.numpy(), oracle.numpy())
    s1, _ = generate(tp, tt, tl, mc, 5, temperature=1.0, seed=7)
    s2, _ = generate(tp, tt, tl, mc, 5, temperature=1.0, seed=7)
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())
    k1, _ = generate(tp, tt, tl, mc, 5, temperature=2.0, top_k=1, seed=3)
    np.testing.assert_array_equal(k1.numpy(), greedy.numpy())
    k = 4
    logits, _ = prefill(tp, tt, tl, mc)
    topk_ids = torch.topk(logits, k).indices.numpy()
    for seed in range(5):
        sk, _ = generate(tp, tt, tl, mc, 1, temperature=1.5, top_k=k, seed=seed)
        first = sk.numpy()[np.arange(2), lengths]
        assert all(first[b] in topk_ids[b] for b in range(2)), (first, topk_ids)


def test_many_eos_early_exit():
    """A row that emits ``eos_id`` freezes (the EOS is written, nothing
    after it), its length stops, and the prefix equals the unfrozen run."""
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    jcfg = _mpt_cfg(alibi=False)
    mc = _port_cfg(jcfg).model
    fn = make_cached_generate_fn(mc, _weights(jcfg, seed=4)[1])
    lengths = np.asarray([4, 6, 9], np.int32)
    tokens = _prompts(mc.vocab_size, lengths, 20, seed=2)
    gen = 8
    full, _ = fn.many(tokens, lengths, gen)
    full = full.numpy()
    streams = [list(full[i, lengths[i]: lengths[i] + gen]) for i in range(3)]
    eos = int(streams[0][0])
    got, got_len = fn.many(tokens, lengths, gen, eos_id=eos)
    got = got.numpy()
    for i in range(3):
        cut = streams[i].index(eos) + 1 if eos in streams[i] else gen
        np.testing.assert_array_equal(got[i, lengths[i]: lengths[i] + cut], streams[i][:cut])
        np.testing.assert_array_equal(got[i, lengths[i] + cut:], 0)
        assert int(got_len[i]) == int(lengths[i]) + cut


def test_many_eos_all_done_first_step(monkeypatch):
    """Every row ends at its first token: lengths +1, the buffer's rest
    untouched, and no decode step runs."""
    from photon_tpu_torch.models import decode

    jcfg = _mpt_cfg(alibi=False)
    mc = _port_cfg(jcfg).model
    fn = decode.make_cached_generate_fn(mc, _weights(jcfg, seed=4)[1])
    tokens = np.zeros((2, 64), np.int32)
    tokens[:, :3] = 5
    lengths = np.asarray([3, 3], np.int32)
    probe, _ = fn.many(tokens, lengths, 1)
    eos = int(probe[0, 3])
    steps = []
    sound = decode._decode_step
    monkeypatch.setattr(decode, "_decode_step", lambda *a: steps.append(1) or sound(*a))
    got, got_len = fn.many(tokens, lengths, 60, eos_id=eos)
    assert got_len.tolist() == [4, 4] and steps == []
    np.testing.assert_array_equal(got.numpy()[:, 4:], 0)


def test_cached_generate_matches_full_forward_bf16():
    """The production compute dtype: bf16 end to end, cached == full."""
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    jcfg = _mpt_cfg(alibi=True)
    jcfg.model.compute_dtype = "bfloat16"
    jcfg.validate()
    mc = _port_cfg(jcfg).model
    _, tp = _weights(jcfg, seed=6)
    tokens = np.zeros((2, 12), np.int32)
    tokens[0, :4] = [5, 9, 2, 7]
    tokens[1, :6] = [3, 3, 8, 1, 4, 2]
    lengths = np.asarray([4, 6], np.int32)
    oracle, _ = _full_forward_generate(mc, tp, tokens, lengths, 5)
    got, _ = make_cached_generate_fn(mc, tp).many(tokens, lengths, 5)
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("name", NAMES + ["mpt-moe"])
def test_paged_decode_bitexact_with_contiguous(name):
    """The paged pool, filled with the contiguous prefill's caches, decodes
    to the same logits as the contiguous cache, bit for bit, at every step
    (the paged view has the contiguous width: ``max_blocks · bs == S``)."""
    from photon_tpu_torch.models.decode import compute_params, decode_step, layer_params, prefill
    from photon_tpu_torch.serve.cache import BlockAllocator, init_paged_state, paged_decode_step

    jcfg = _jax_cfg(name)
    mc = _port_cfg(jcfg).model
    _, tp = _weights(jcfg, seed=4)
    b, s, gen, bs = 3, 16, 6, 4
    max_blocks = s // bs
    lengths = np.asarray([4, 7, 10], np.int32)
    tokens = _prompts(mc.vocab_size, lengths, s, seed=1)
    logits_c, st = prefill(tp, torch.from_numpy(tokens), torch.from_numpy(lengths), mc)

    alloc = BlockAllocator(b * max_blocks)
    pst = init_paged_state(mc, b, b * max_blocks, bs, max_blocks, torch.device("cpu"))
    for i in range(b):
        ids = alloc.alloc(max_blocks)
        pst.block_tables[i] = torch.tensor(ids, dtype=torch.int32)
        for j, blk in enumerate(ids):
            pst.cache_k[blk] = st.cache_k[:, i, j * bs:(j + 1) * bs]
            pst.cache_v[blk] = st.cache_v[:, i, j * bs:(j + 1) * bs]
        pst.lengths[i] = int(lengths[i])
    cp = compute_params(tp, mc, torch.device("cpu"))
    layers = [layer_params(cp, li) for li in range(mc.n_layers)]
    active = torch.ones(b, dtype=torch.bool)
    logits_p = logits_c  # the prefill's logits are the contiguous ones by construction
    for _ in range(gen):
        nxt = torch.argmax(logits_c, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(logits_p.numpy(), logits_c.numpy())
        logits_c, st = decode_step(tp, st, nxt, mc)
        logits_p, pst = paged_decode_step(cp, layers, pst, nxt, mc, active)
    np.testing.assert_array_equal(logits_p.numpy(), logits_c.numpy())
    np.testing.assert_array_equal(pst.lengths.numpy(), st.lengths.numpy())


def test_prefill_runs_the_configured_attention(monkeypatch):
    """``attn_impl: pallas`` sends prefill through the flash forward (its
    plain version for CPU tensors, K1 on the card), with no autograd
    node under ``inference_mode``; the numbers equal the dense path's."""
    from photon_tpu_torch.models.decode import prefill
    from photon_tpu_torch.ops import flash_attention as fa

    jcfg = _mpt_cfg(alibi=True)
    mc = _port_cfg(jcfg).model
    _, tp = _weights(jcfg, seed=2)
    tokens = torch.from_numpy(_prompts(mc.vocab_size, [5, 9], 12, seed=3))
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    dense, _ = prefill(tp, tokens, lengths, mc)
    calls = []
    sound = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd", lambda *a, **k: calls.append(1) or sound(*a, **k))
    monkeypatch.setattr(fa.FlashAttention, "apply",
                        lambda *a: pytest.fail("autograd node built without a gradient"))
    mc.attn_impl = "pallas"
    with torch.inference_mode():
        flash, st = prefill(tp, tokens, lengths, mc)
    assert len(calls) == mc.n_layers and not st.cache_k.requires_grad
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=0, atol=LOGIT_ATOL)
