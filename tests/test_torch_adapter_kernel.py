"""The adapter paths on the card: a LoRA fit step through K1–K3 and a
mixed-cohort serving step through K4, each against the plain version.

Every case needs the card (marker ``cuda``; skips without one). This file
imports no JAX, so it runs on a machine without it; ``tests/conftest.py``
does import JAX, hence ``--noconftest`` there::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adapter_kernel.py

fp32 throughout, small widths (d 128, 2 heads of 64, 2 layers). Gates:
the A/B gradients of a frozen-base step within 1e-4 relative L2 of the
plain attention's (the flash backward's gate), the base requiring no
gradient; a mixed-cohort engine's logits within 1e-4 of contiguous decode
with per-row adapters, and its no-cohort slot equal to an adapter-free
engine's.
"""

import copy

import numpy as np
import pytest
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GATE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cfg():
    from photon_tpu_torch.config.schema import Config

    cfg = Config()
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.vocab_size, m.max_seq_len = 128, 2, 2, 256, 256
    m.compute_dtype = "float32"
    ad = cfg.photon.adapters
    ad.enabled, ad.rank, ad.pool_size = True, 4, 2
    ad.cohorts = {"a": [0], "b": [1], "c": []}
    s = cfg.photon.serve
    s.n_slots, s.block_size, s.prefill_token_budget = 4, 16, 64
    cfg.train.global_batch_size = cfg.train.device_microbatch_size = 2
    return cfg


def _rel(a, ref) -> float:
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm().clamp_min(1e-12))


def _bank(spec, seed=1):
    from photon_tpu_torch.adapters.lora import adapter_metadata

    rng = np.random.default_rng(seed)
    meta = adapter_metadata(spec)
    return {c: [rng.normal(0, 0.05, s).astype(np.float32) for s in meta.shapes]
            for c in ("a", "b", "c")}


@pytest.mark.cuda
def test_lora_fit_step_kernels_match_plain(cuda):
    from photon_tpu_torch.adapters import configure_adapter_training
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.models.mpt import MPTModel, init_params
    from photon_tpu_torch.ops import flash_attention as fa
    from photon_tpu_torch.train.train_step import make_loss_fn

    cfg = configure_adapter_training(_cfg()).validate()
    params = init_params(cfg.model, seed=0, device=cuda)
    with torch.no_grad():  # a trained-looking B: a zero B gives A no gradient
        for n, p in flatten(params).items():
            if n.endswith("_lora_b"):
                p.normal_(0, 0.05)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 256))).to(cuda)
    grads = {}
    for impl in ("pallas", "xla"):
        c = copy.deepcopy(cfg)
        c.model.attn_impl = impl
        flat = flatten(params)
        names = [n for n in flat if "_lora_" in n]
        for n, p in flat.items():
            p.requires_grad_(n in names)
        before = dict(fa.launches)
        loss = make_loss_fn(MPTModel(c.model), 64)(params, tokens)
        g = torch.autograd.grad(loss, [flat[n] for n in names])
        grew = {k: fa.launches[k] - before[k] for k in before}
        assert grew == ({k: 2 for k in grew} if impl == "pallas" else {k: 0 for k in grew})
        grads[impl] = (float(loss.detach()), dict(zip(names, g)))
    assert abs(grads["pallas"][0] - grads["xla"][0]) <= GATE * abs(grads["xla"][0])
    for n, g in grads["xla"][1].items():
        assert _rel(grads["pallas"][1][n], g) <= GATE, n


@pytest.mark.cuda
def test_mixed_cohort_engine_matches_contiguous_oracle(cuda):
    from photon_tpu_torch.adapters.lora import adapter_tree, stack_adapter_trees
    from photon_tpu_torch.models.decode import decode_step, prefill
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.ops import ragged_paged_attention as rpa
    from photon_tpu_torch.serve.engine import PagedEngine

    cfg = _cfg().validate(cuda, serving=True)
    params = init_params(cfg.model, seed=0, device=cuda)
    eng = PagedEngine(cfg, params, device=cuda)
    bank = _bank(eng.adapter_pool.spec)
    eng.adapter_pool.install_bank(bank)
    free_cfg = copy.deepcopy(cfg)
    free_cfg.photon.adapters.enabled = False
    free = PagedEngine(free_cfg, params, device=cuda)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, 256, n))) for n in (40, 90, 17, 130)]
    cohorts = ["a", "b", None, "a"]
    gen = 6
    got, base = {s: [] for s in range(4)}, {s: [] for s in range(4)}
    before = rpa.launches
    for e, out, cs in ((eng, got, cohorts), (free, base, [None] * 4)):
        for s, (p, c) in enumerate(zip(prompts, cs)):
            e.admit(s, p, gen, cohort=c)
            out[s].append(e.last_logits[s].clone())
        for _ in range(gen - 1):
            e.step()
            for s in range(4):
                out[s].append(e.last_logits[s].clone())
    assert rpa.launches > before  # the kernel ran
    spec = eng.adapter_pool.spec
    zeros = [np.zeros_like(a) for a in bank["a"]]
    for s, (p, c) in enumerate(zip(prompts, cohorts)):
        adapters = stack_adapter_trees([adapter_tree(spec, bank[c] if c else zeros)])
        toks = torch.zeros((1, len(p) + gen + 1), dtype=torch.long, device=cuda)
        toks[0, : len(p)] = torch.tensor(p, device=cuda)
        lg, st = prefill(params, toks, torch.tensor([len(p)], device=cuda), cfg.model,
                         adapters=adapters, lora_scale=spec.scale)
        for i in range(gen):
            assert _rel(got[s][i], lg[0]) <= GATE, (s, i)
            lg, st = decode_step(params, st, got[s][i].argmax()[None], cfg.model,
                                 adapters=adapters, lora_scale=spec.scale)
        if c is None:
            assert all(torch.equal(x, y) for x, y in zip(got[s], base[s]))
