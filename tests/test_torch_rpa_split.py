"""The split-K arithmetic of the port's ragged paged attention, on the CPU.

The decode regime of the CUDA kernel cuts each slot's key walk into splits,
keeps per-split partials ``(m, l, acc)`` and merges them in a second
kernel. ``split_partials`` and ``combine_partials`` write that arithmetic
out plainly; here the merged partials are held to the unsplit plain version
and to the JAX package's kernel in interpret mode, at the JAX package's
fp32 pin ``RAGGED_KERNEL_EPS`` (inputs from a numpy seed, tiny shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops.attention import alibi_slopes as jax_alibi_slopes
from photon_tpu.ops.ragged_paged_attention import ragged_paged_attention as jax_rpa
from photon_tpu_torch.ops import ragged_paged_attention as rpa
from photon_tpu_torch.ops.attention import alibi_slopes
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

#: the JAX package's pin for its fused kernel vs the dense reference, fp32
RAGGED_KERNEL_EPS = 2e-6


def _rel(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / (np.linalg.norm(ref) + 1e-12))


def _case(seed, *, b, t, h, n_kv, dh=8, bs=4, nb=17, n_ctx=8):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.standard_normal((b, t, h, dh)).astype(np.float32),
        kp=rng.standard_normal((nb, 1, bs, n_kv, dh)).astype(np.float32),
        vp=rng.standard_normal((nb, 1, bs, n_kv, dh)).astype(np.float32),
        rows=rng.integers(0, nb, (b, n_ctx)).astype(np.int32),
        pos=np.sort(rng.integers(0, n_ctx * bs, (b, t)), axis=1).astype(np.int32),
    )


def _jax_kernel(c, alibi):
    jslopes = jax_alibi_slopes(c["q"].shape[2]) if alibi else None
    return np.asarray(jax_rpa(jnp.asarray(c["q"]), jnp.asarray(c["kp"][:, 0]),
                              jnp.asarray(c["vp"][:, 0]), jnp.asarray(c["rows"]),
                              jnp.asarray(c["pos"]), slopes=jslopes, interpret=True))


def _split_vs_unsplit(c, split_keys, alibi):
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    rows, pos = torch.from_numpy(c["rows"]), torch.from_numpy(c["pos"])
    slopes = alibi_slopes(q.shape[2]) if alibi else None
    kb, vb = rpa.live_view(kp, vp, 0, rows)
    m, l, acc = rpa.split_partials(q, kb, vb, pos, split_keys, slopes=slopes)
    merged = rpa.combine_partials(m, l, acc).numpy()
    plain = rpa.ragged_reference_attention(q, kb, vb, pos, slopes=slopes).numpy()
    return merged, plain, _jax_kernel(c, alibi), m


@pytest.mark.parametrize("split_keys", [4, 8, 12, 32])
@pytest.mark.parametrize("kind", ["mha", "alibi", "gqa"])
def test_merged_partials_match_unsplit_and_jax(split_keys, kind):
    c = _case(13, b=3, t=2, h=4, n_kv=2 if kind == "gqa" else 4)
    merged, plain, kern, m = _split_vs_unsplit(c, split_keys, kind == "alibi")
    assert m.shape[-1] == -(-32 // split_keys)
    assert _rel(merged, plain) < RAGGED_KERNEL_EPS
    assert _rel(merged, kern) < RAGGED_KERNEL_EPS


def test_empty_trailing_split_and_unseeing_row():
    """Splits past a slot's largest position are empty (m = NEG_INF,
    l = 0) and change nothing; a row at position -1 sees no key and
    merges to 0."""
    c = _case(17, b=2, t=2, h=4, n_kv=2)
    c["pos"] = np.array([[-1, 5], [9, 10]], np.int32)
    merged, plain, kern, m = _split_vs_unsplit(c, 8, alibi=False)
    m = m.numpy()
    assert (m[:, :, :, 2:] == rpa.NEG_INF).all()  # keys 16..31: past every position
    assert (m[0, 0] == rpa.NEG_INF).all()
    assert np.all(merged[0, 0] == 0.0) and np.all(np.isfinite(merged))
    assert _rel(merged, plain) < RAGGED_KERNEL_EPS
    assert _rel(merged, kern) < RAGGED_KERNEL_EPS


def test_empty_partials_merge_to_zero():
    m = torch.full((2, 3), rpa.NEG_INF)
    out = rpa.combine_partials(m, torch.zeros(2, 3), torch.zeros(2, 3, 4))
    assert torch.equal(out, torch.zeros(2, 4))


@pytest.mark.parametrize("n_ctx,bs,want", [
    (128, 16, 8),   # the engine's full width: 8 slots x 2048 tokens, block 16
    (64, 16, 4),
    (8, 16, 1),     # a short walk stays one split
    (1, 16, 1),
    (33, 8, 2),     # 264 keys: a ragged last split
    (2048, 1, 8),
])
def test_split_plan(n_ctx, bs, want):
    n_split, split_keys = rpa.split_plan(n_ctx * bs)
    assert split_keys == rpa.SPLIT_KEYS and split_keys % 64 == 0  # whole 64-key tiles
    assert n_split == want
    assert (n_split - 1) * split_keys < max(1, n_ctx * bs) <= n_split * split_keys


@pytest.mark.parametrize("t,group,dtype,want", [
    (1, 1, torch.bfloat16, "split"),    # mpt-125m decode
    (1, 4, torch.bfloat16, "split"),    # llama-1b decode (GQA 16/4)
    (4, 4, torch.bfloat16, "verify"),   # llama-1b verify: 16 rows a (slot, kv head)
    (512, 1, torch.bfloat16, "chunk"),  # a prompt chunk
    (512, 1, torch.float32, "split"),   # fp32 stays on CUDA cores
    (8, 1, torch.bfloat16, "verify"),   # mpt-125m verify at n_spec 8
    (64, 1, torch.bfloat16, "verify"),  # the most rows the verify regime takes
    (65, 1, torch.bfloat16, "chunk"),
    (17, 4, torch.bfloat16, "chunk"),
    (8, 1, torch.float32, "split"),
])
def test_regime_is_chosen_from_shapes(t, group, dtype, want):
    assert rpa.regime(t, group, dtype) == want


def _verify_case(seed, *, t, group, n_kv=2, b=2, n_ctx=24):
    """A verify grid at the engine's block size: each row's ``t`` queries
    at consecutive positions from its own depth (keys past a query's own
    position hold data, a later draft's), 16-token blocks, 384 keys."""
    c = _case(seed, b=b, t=t, h=n_kv * group, n_kv=n_kv, bs=16, nb=2 * n_ctx + 1, n_ctx=n_ctx)
    depth = np.random.default_rng(seed + 1).integers(0, n_ctx * 16 - t, b)
    c["pos"] = (depth[:, None] + np.arange(t)).astype(np.int32)
    return c


def _verify_vs_plain(c, split_keys, alibi):
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    rows, pos = torch.from_numpy(c["rows"]), torch.from_numpy(c["pos"])
    slopes = alibi_slopes(q.shape[2]) if alibi else None
    kb, vb = rpa.live_view(kp, vp, 0, rows)
    m, l, acc = rpa.verify_partials(q, kb, vb, pos, split_keys, slopes=slopes)
    merged = rpa.combine_partials(m, l, acc).numpy()
    plain = rpa.ragged_reference_attention(q, kb, vb, pos, slopes=slopes).numpy()
    return merged, plain, _jax_kernel(c, alibi), m


@pytest.mark.parametrize("split_keys", [64, 128, rpa.SPLIT_KEYS])
@pytest.mark.parametrize("kind", [
    "t8_group1",    # mpt-125m verify (n_spec 8)
    "t4_group4",    # llama-1b verify (GQA 16/4, n_spec 4)
    "t16_group4",   # T * group = 64: four 16-row tiles
    "alibi",
])
def test_verify_partials_match_unsplit_and_jax(split_keys, kind):
    t, group = {"t8_group1": (8, 1), "t4_group4": (4, 4), "t16_group4": (16, 4),
                "alibi": (8, 2)}[kind]
    c = _verify_case(61, t=t, group=group)
    assert rpa.regime(t, group, torch.bfloat16) == "verify"
    merged, plain, kern, m = _verify_vs_plain(c, split_keys, kind == "alibi")
    assert m.shape[-1] == -(-24 * 16 // split_keys)
    assert _rel(merged, plain) < RAGGED_KERNEL_EPS
    assert _rel(merged, kern) < RAGGED_KERNEL_EPS


def test_verify_partials_padding_columns_and_unseeing_row():
    """Padding columns at position 0 (a row with fewer drafts than the
    bucket) see key 0 alone; a row at position -1 sees no key and merges
    to 0; splits past a slot's largest position are empty."""
    c = _verify_case(67, t=8, group=2, b=3)
    c["pos"][0, 5:] = 0
    c["pos"][1, :] = -1
    c["pos"][2] = np.arange(100, 108)
    merged, plain, kern, m = _verify_vs_plain(c, 128, alibi=False)
    m = m.numpy()
    assert (m[1] == rpa.NEG_INF).all()
    assert (m[2, :, :, 1:] == rpa.NEG_INF).all()  # keys 128 on: past every position
    assert np.all(merged[1] == 0.0) and np.all(np.isfinite(merged))
    assert _rel(merged, plain) < RAGGED_KERNEL_EPS
    assert _rel(merged, kern) < RAGGED_KERNEL_EPS


def test_verify_warp_states_merge_in_warp_order():
    """One split, one tile: each warp's 16 keys give that warp's softmax
    alone, and the merged partial equals the split-K partial of the same
    keys (the two regimes' partials merge alike)."""
    c = _verify_case(71, t=4, group=1, n_ctx=4)
    c["pos"][:] = 63
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    rows, pos = torch.from_numpy(c["rows"]), torch.from_numpy(c["pos"])
    kb, vb = rpa.live_view(kp, vp, 0, rows)
    mv, lv, av = rpa.verify_partials(q, kb, vb, pos, 64)
    ms, ls, as_ = rpa.split_partials(q, kb, vb, pos, 64)
    assert mv.shape == ms.shape == (2, 4, 2, 1)
    assert torch.equal(mv, ms)  # the largest logit is one value either way
    assert _rel(lv, ls) < RAGGED_KERNEL_EPS and _rel(av, as_) < RAGGED_KERNEL_EPS
