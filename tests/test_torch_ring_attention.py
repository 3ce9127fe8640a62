"""Ring attention in the port against the JAX package's, on the same numpy
inputs (the counterparts of ``tests/test_ring_attention.py``).

``photon_tpu_torch.ops.ring_attention`` runs over a mesh that repeats the
CPU; ``photon_tpu.ops.ring_attention`` over the conftest's 8 fake CPU
devices. Every ring case runs both port routes, the dense chunk oracle
(``impl="xla"``) and the flash route (``impl="pallas"``: the plain K1–K3
on the CPU, at the chunk's causal offset), against JAX's result at its
tolerances: outputs 1e-5, gradients 1e-4. ``flash_attention_with_lse``'s
backward, LSE cotangent included, is held to JAX's VJP of its own
``flash_attention_with_lse`` (kernel in interpret mode, backward its dense
recompute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.config.schema import MeshConfig as JaxMeshConfig
from photon_tpu.ops import ring_attention as jring
from photon_tpu.ops.attention import xla_attention as jax_xla_attention
from photon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from photon_tpu_torch.config.schema import MeshConfig
from photon_tpu_torch.ops.attention import xla_attention
from photon_tpu_torch.ops.ring_attention import (
    _merge_partials,
    ring_attention,
    xla_chunk_attention,
)
from photon_tpu_torch.parallel.mesh import make_mesh
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

B, S, H, D = 2, 64, 2, 16
OUT_TOL = 1e-5
GRAD_TOL = 1e-4
IMPLS = ["xla", "pallas"]


def _np(seed, shape=(B, S, H, D)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(*arrays, grad=False):
    out = [torch.tensor(a, requires_grad=grad) for a in arrays]
    return out if len(out) > 1 else out[0]


def _meshes(**axes):
    n = int(np.prod(list(axes.values())))
    return (make_mesh(MeshConfig(**axes), devices=["cpu"] * n),
            jax_make_mesh(JaxMeshConfig(**axes)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_chunk_attention_matches_full():
    q, k, v = _np(0), _np(1), _np(2)
    o, lse = xla_chunk_attention(*_t(q, k, v), q_start=0, k_start=0, causal=True)
    jo, jlse = jring.xla_chunk_attention(q, k, v, q_start=0, k_start=0, causal=True)
    _close(o, jo, OUT_TOL)
    _close(lse, jlse, OUT_TOL)
    _close(o, xla_attention(*_t(q, k, v), causal=True).numpy(), OUT_TOL)
    assert lse.shape == (B, S, H)


def test_merge_partials_reconstructs_softmax():
    q, k, v = _np(3), _np(4), _np(5)
    half = S // 2
    tq, tk, tv = _t(q, k, v)
    o1, l1 = xla_chunk_attention(tq, tk[:, :half], tv[:, :half], q_start=0, k_start=0,
                                 causal=True)
    o2, l2 = xla_chunk_attention(tq, tk[:, half:], tv[:, half:], q_start=0, k_start=half,
                                 causal=True)
    o, lse = _merge_partials(o1, l1, o2, l2)
    jo, jl = jring._merge_partials(*(jnp.asarray(x.numpy()) for x in (o1, l1, o2, l2)))
    _close(o, jo, OUT_TOL)
    _close(lse, jl, OUT_TOL)
    _close(o, jax_xla_attention(q, k, v, causal=True), OUT_TOL)


def test_fully_masked_chunk_is_neutral():
    q, k, v = _np(6), _np(7), _np(8)
    tq, tk, tv = _t(q, k, v)
    o1, l1 = xla_chunk_attention(tq, tk, tv, q_start=0, k_start=0, causal=True)
    o2, l2 = xla_chunk_attention(tq, tk, tv, q_start=0, k_start=S + 100, causal=True)
    assert torch.all(o2 == 0) and torch.all(l2 < -1e29)
    o, _ = _merge_partials(o1, l1, o2, l2)
    np.testing.assert_allclose(o.numpy(), o1.numpy(), rtol=1e-6)


_JAX: dict = {}


def _jax_once(key, fn):
    """JAX's result for ``key``, computed once for both port routes."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _jax_ring(mesh, q, k, v, **kw):
    return np.asarray(jax.jit(lambda a, b, c: jring.ring_attention(
        a, b, c, mesh, causal=True, impl="xla", **kw))(q, k, v))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("ring", [2, 4])
def test_ring_attention_matches_full(ring, impl):
    mesh, jmesh = _meshes(data=2, sequence=ring)
    q, k, v = _np(9), _np(10), _np(11)
    o = ring_attention(*_t(q, k, v), mesh, causal=True, impl=impl)
    _close(o, _jax_once(("full", ring), lambda: _jax_ring(jmesh, q, k, v)), OUT_TOL)
    _close(o, jax_xla_attention(q, k, v, causal=True), OUT_TOL)


def _jax_ring_grads(mesh, q, k, v):
    return [np.asarray(g) for g in jax.jit(jax.grad(lambda a, b, c: jnp.sum(jnp.square(
        jring.ring_attention(a, b, c, mesh, causal=True, impl="xla"))),
        argnums=(0, 1, 2)))(q, k, v)]


def _grads(fn, *arrays):
    ts = _t(*arrays, grad=True)
    fn(*ts).float().square().sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_attention_grads_match_full(impl):
    mesh, jmesh = _meshes(sequence=4)
    q, k, v = _np(12), _np(13), _np(14)
    got = _grads(lambda a, b, c: ring_attention(a, b, c, mesh, causal=True, impl=impl), q, k, v)
    want = _jax_once("grads", lambda: _jax_ring_grads(jmesh, q, k, v))
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_size_one_is_plain_attention(impl):
    mesh, jmesh = _meshes(sequence=1)
    q, k, v = _np(15), _np(16), _np(17)
    o = ring_attention(*_t(q, k, v), mesh, causal=True, impl=impl)
    _close(o, _jax_once("one", lambda: np.asarray(jring.ring_attention(
        q, k, v, jmesh, causal=True, impl="xla"))), OUT_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("alibi", [False, True])
def test_ring_gqa_matches_full(alibi, impl):
    """kv at one head rides the ring at its own width; ALiBi at global
    positions with the global slopes."""
    mesh, jmesh = _meshes(sequence=4)
    q, k, v = _np(18), _np(19, (B, S, 1, D)), _np(20, (B, S, 1, D))
    o = ring_attention(*_t(q, k, v), mesh, causal=True, impl=impl, alibi=alibi)
    _close(o, _jax_once(("gqa", alibi), lambda: _jax_ring(jmesh, q, k, v, alibi=alibi)), OUT_TOL)
    rep = lambda x: np.repeat(x, H, axis=2)  # noqa: E731
    _close(o, jax_xla_attention(q, rep(k), rep(v), causal=True, alibi=alibi), OUT_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_gqa_grads_match_full(impl):
    mesh, jmesh = _meshes(sequence=4)
    q, k, v = _np(21), _np(22, (B, S, 1, D)), _np(23, (B, S, 1, D))
    got = _grads(lambda a, b, c: ring_attention(a, b, c, mesh, causal=True, impl=impl), q, k, v)
    want = _jax_once("gqa_grads", lambda: _jax_ring_grads(jmesh, q, k, v))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_gqa_with_tensor_sharded_heads(impl):
    """tensor=2 divides both head counts (4 q, 2 kv): heads stay split over
    tensor and kv rides each head shard's ring at grouped width."""
    mesh, jmesh = _meshes(tensor=2, sequence=2)
    q2 = _np(24)
    q = np.concatenate([q2, q2 * 0.5], axis=2)
    k, v = _np(25), _np(26)
    o = ring_attention(*_t(q, k, v), mesh, causal=True, impl=impl)
    _close(o, _jax_once("tensor", lambda: _jax_ring(jmesh, q, k, v)), OUT_TOL)
    rep = lambda x: np.repeat(x, 2, axis=2)  # noqa: E731
    _close(o, jax_xla_attention(q, rep(k), rep(v), causal=True), OUT_TOL)


@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (32, 0)], ids=["diagonal", "below"])
def test_flash_attention_with_lse_vjp_matches_jax(offsets, gqa):
    """The LSE-returning chunk attention at a global offset: (o, lse)
    against JAX's, and its VJP with cotangents on BOTH outputs (the LSE's
    reaches the kernels as Δ − dLSE) against JAX's VJP."""
    from photon_tpu.ops.flash_attention import flash_attention_with_lse as jax_fa_lse
    from photon_tpu_torch.ops.flash_attention import flash_attention_with_lse

    s = 32
    q_start, k_start = offsets
    q, do, dl = _np(27, (B, s, 4, D)), _np(28, (B, s, 4, D)), _np(29, (B, s, 4))
    k, v = (_np(30 + i, (B, s, 2 if gqa else 4, D)) for i in range(2))
    ts = _t(q, k, v, grad=True)
    o, lse = flash_attention_with_lse(*ts, causal=True, q_start=q_start, k_start=k_start)
    torch.autograd.backward([o, lse], [torch.tensor(do), torch.tensor(dl)])

    def jfn(a, b, c):
        return jax_fa_lse(a, b, c, causal=True, q_start=q_start, k_start=k_start,
                          block_q=s, block_k=s, interpret=True)

    (jo, jlse), vjp = jax.vjp(jfn, q, k, v)
    _close(o, jo, OUT_TOL)
    _close(lse, jlse, OUT_TOL)
    for g, w in zip((t.grad for t in ts), vjp((jnp.asarray(do), jnp.asarray(dl)))):
        _close(g, w, GRAD_TOL)
