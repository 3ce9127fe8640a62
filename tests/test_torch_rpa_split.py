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


def _split_vs_unsplit(c, split_keys, alibi):
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    rows, pos = torch.from_numpy(c["rows"]), torch.from_numpy(c["pos"])
    slopes = alibi_slopes(q.shape[2]) if alibi else None
    kb, vb = rpa.live_view(kp, vp, 0, rows)
    m, l, acc = rpa.split_partials(q, kb, vb, pos, split_keys, slopes=slopes)
    merged = rpa.combine_partials(m, l, acc).numpy()
    plain = rpa.ragged_reference_attention(q, kb, vb, pos, slopes=slopes).numpy()
    jslopes = jax_alibi_slopes(q.shape[2]) if alibi else None
    kern = np.asarray(jax_rpa(jnp.asarray(c["q"]), jnp.asarray(c["kp"][:, 0]),
                              jnp.asarray(c["vp"][:, 0]), jnp.asarray(c["rows"]),
                              jnp.asarray(c["pos"]), slopes=jslopes, interpret=True))
    return merged, plain, kern, m


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
    (4, 4, torch.bfloat16, "chunk"),
    (512, 1, torch.bfloat16, "chunk"),  # a prompt chunk
    (512, 1, torch.float32, "split"),   # fp32 stays on CUDA cores
])
def test_regime_is_chosen_from_shapes(t, group, dtype, want):
    assert rpa.regime(t, group, dtype) == want
