"""The batch- and head-sharded flash dispatch of the port against its dense
path and the JAX package's sharded output (the counterparts of
``tests/test_attention_shard_map.py``).

Under an ambient mesh whose batch or ``tensor`` axis is larger than 1,
``multihead_attention(impl="pallas")`` runs K1–K3 (their plain versions on
the CPU) on each position's batch rows and heads. Each case holds it to
the port's ``xla`` path on the same global inputs (fp32 on both sides:
1e-5 for outputs, 1e-4 for gradients), and to JAX's ``shard_map``-ed
Pallas kernel in interpret mode on the conftest's fake CPU devices at the
JAX test's own tolerance (2e-2; 5e-2 for gradients). Under ``tensor > 1``
ALiBi must take each head's slope from the global table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.config.schema import MeshConfig as JaxMeshConfig
from photon_tpu.ops.attention import multihead_attention as jax_mha
from photon_tpu.parallel.context import use_mesh as jax_use_mesh
from photon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from photon_tpu_torch.config.schema import MeshConfig
from photon_tpu_torch.ops import attention as attn_mod
from photon_tpu_torch.ops.attention import multihead_attention
from photon_tpu_torch.parallel.context import use_mesh
from photon_tpu_torch.parallel.mesh import make_mesh
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

B, S, H, D = 4, 256, 4, 64
BLOCK = 128  # the JAX kernel's tiles (interpret mode), as the JAX test's
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
JAX_TOL, JAX_GRAD_TOL = 2e-2, 5e-2  # the JAX test's (interpret-mode kernel vs XLA)


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshConfig(**axes), devices=["cpu"] * n)


def _dense(q, k, v, alibi):
    """The port's xla path on global inputs (kv repeated up to q's heads)."""
    return multihead_attention(q, k, v, impl="xla", causal=True, alibi=alibi)


@functools.lru_cache(maxsize=None)
def _jax_out(axes: tuple, alibi: bool, q_seed, kv_heads: int):
    """JAX's sharded flash output (interpret mode) for inputs made from
    ``q_seed`` (``None``: seed 0)."""
    q, k, v = _inputs(q_seed, kv_heads)
    with jax_use_mesh(jax_make_mesh(JaxMeshConfig(**dict(axes)))):
        return np.asarray(jax_mha(q, k, v, impl="pallas", causal=True, alibi=alibi,
                                  block_q=BLOCK, block_k=BLOCK, interpret=True))


def _inputs(seed, kv_heads):
    rng = np.random.default_rng(0 if seed is None else seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, kv_heads, D)).astype(np.float32)
    v = rng.normal(size=(B, S, kv_heads, D)).astype(np.float32)
    return q, k, v


def _check(axes, alibi, kv_heads=H, seed=None, impl="pallas"):
    q, k, v = (torch.tensor(a) for a in _inputs(seed, kv_heads))
    ref = _dense(q, k, v, alibi)
    with use_mesh(_mesh(**axes)):
        out = multihead_attention(q, k, v, impl=impl, causal=True, alibi=alibi)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=OUT_TOL, atol=OUT_TOL)
    want = _jax_out(tuple(sorted(axes.items())), alibi, seed, kv_heads)
    np.testing.assert_allclose(out.numpy(), want, rtol=JAX_TOL, atol=JAX_TOL)
    return out


@pytest.mark.parametrize("axes", [{"data": 2, "fsdp": 2}, {"data": 2, "fsdp": 2, "tensor": 2}],
                         ids=["batch", "batch+heads"])
def test_sharded_flash_matches_xla(axes, monkeypatch):
    calls = []
    real = attn_mod.sharded_flash_attention
    monkeypatch.setattr(attn_mod, "sharded_flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _check(axes, alibi=False)
    assert calls == [1]


def test_sharded_flash_alibi_batch_axes_only():
    _check({"data": 2, "fsdp": 2}, alibi=True)


def test_alibi_with_tensor_sharding_uses_global_slopes(monkeypatch):
    """Each head shard slices its rows of the global slope table; slopes
    restarted per shard (``alibi_slopes(h_local)``) must part from the
    global reference."""
    _check({"data": 2, "tensor": 2}, alibi=True)
    from photon_tpu_torch.ops import ring_attention as ra

    real = ra.flash_attention_with_lse
    monkeypatch.setattr(ra, "flash_attention_with_lse", lambda q, k, v, *, slopes=None, **kw:
                        real(q, k, v, slopes=None if slopes is None
                             else attn_mod.alibi_slopes(q.shape[2]), **kw))
    q, k, v = (torch.tensor(a) for a in _inputs(None, H))
    with use_mesh(_mesh(data=2, tensor=2)):
        restarted = multihead_attention(q, k, v, impl="pallas", causal=True, alibi=True)
    assert float((restarted - _dense(q, k, v, True)).abs().max()) > 1e-2


def test_sharded_gqa_flash_matches_xla():
    """kv at 2 heads splits over tensor=2: one kv head per shard, its q
    group beside it."""
    _check({"data": 2, "tensor": 2}, alibi=False, kv_heads=2, seed=3)


def _grads(fn, q, k, v):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = fn(*ts)
    (o * o).sum().backward()
    return [t.grad for t in ts]


def _jax_grads(axes, alibi, q, k, v):
    def loss(a, b, c):
        with jax_use_mesh(jax_make_mesh(JaxMeshConfig(**axes))):
            o = jax_mha(a, b, c, impl="pallas", causal=True, alibi=alibi, block_q=BLOCK,
                        block_k=BLOCK, interpret=True)
        return jnp.sum(o * o)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("case", ["gqa_alibi_tensor", "batch"])
def test_sharded_flash_gradients_match_xla(case):
    """The riskiest composition (GQA dK/dV, global ALiBi slopes, heads
    split over tensor) and the batch-only split, against the dense
    gradients and JAX's."""
    if case == "batch":
        axes, alibi, (q, k, v) = {"data": 2, "fsdp": 2}, False, _inputs(None, H)
    else:
        axes, alibi, (q, k, v) = {"data": 2, "tensor": 2}, True, _inputs(5, 2)

    def sharded(a, b, c):
        with use_mesh(_mesh(**axes)):
            return multihead_attention(a, b, c, impl="pallas", causal=True, alibi=alibi)

    got = _grads(sharded, q, k, v)
    ref = _grads(lambda a, b, c: _dense(a, b, c, alibi), q, k, v)
    want = _jax_grads(axes, alibi, q, k, v)
    for g, r, w in zip(got, ref, want):
        assert g.shape == r.shape == w.shape
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=JAX_GRAD_TOL,
                                   atol=JAX_GRAD_TOL)


def test_ring_dispatch_mqa_kv_indivisible_by_tensor(monkeypatch):
    """One kv head, tensor=2 and a sequence axis: the ring dispatch repeats
    kv up to the q heads first, so the heads stay split over tensor."""
    seen = []
    real = attn_mod.ring_attention
    monkeypatch.setattr(attn_mod, "ring_attention",
                        lambda q, k, v, mesh, **kw: seen.append(k.shape[2]) or real(
                            q, k, v, mesh, **kw))
    q, k, v = (torch.tensor(a) for a in _inputs(11, 1))
    with use_mesh(_mesh(tensor=2, sequence=2)):
        out = multihead_attention(q, k, v, impl="ring", causal=True, alibi=False)
    assert seen == [H]
    np.testing.assert_allclose(out.numpy(), _dense(q, k, v, False).numpy(), rtol=OUT_TOL,
                               atol=OUT_TOL)
    jq, jk, jv = _inputs(11, 1)
    with jax_use_mesh(jax_make_mesh(JaxMeshConfig(tensor=2, sequence=2))):
        want = jax_mha(jq, jk, jv, impl="ring", causal=True, alibi=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=JAX_TOL, atol=JAX_TOL)
