"""The port's flash attention (``photon_tpu_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

The same inputs, made from a seed with numpy, go through:

1. the plain K1 (o and LSE) and ``flash_attention`` / ``flash_attention_
   with_lse(interpret=True)`` and ``xla_attention``, fp32, relative L2
   within 2e-5 (as ``tests/test_flash_kernel_interpret.py``): causal and
   not, ALiBi, GQA 4:1, D 64 and 128, q shorter than k, a ring offset;
2. the plain K2/K3 (dq, dk, dv) and ``jax.vjp`` of the interpret-mode
   kernel, within 5e-5;
3. the ``autograd.Function`` on the CPU and torch autograd through the
   dense oracle;
4. the wrappers' shape, dtype, stride and head-dim checks.

Sizes stay tiny (S <= 128, B*H <= 8): interpret mode is slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops.attention import xla_attention as jax_xla_attention
from photon_tpu.ops.flash_attention import flash_attention as jax_flash
from photon_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse
from photon_tpu_torch.ops import flash_attention as fa
from photon_tpu_torch.ops.attention import alibi_slopes, multihead_attention, xla_attention
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

FWD_TOL = 2e-5
BWD_TOL = 5e-5
BLOCK = 32


def _rel(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / (np.linalg.norm(ref) + 1e-12))


def _inputs(*, b, s_q, s_k, h, n_kv, d, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, s_q, h, d), f(b, s_k, n_kv, d), f(b, s_k, n_kv, d), f(b, s_q, h, d)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


FWD_CASES = [
    # name, b, s_q, s_k, h, n_kv, d, causal, alibi
    ("causal", 2, 64, 64, 4, 4, 64, True, False),
    ("non_causal", 2, 64, 64, 4, 4, 64, False, False),
    ("alibi", 2, 64, 64, 4, 4, 64, True, True),
    ("gqa_4to1", 2, 64, 64, 4, 1, 64, True, False),
    ("d128", 1, 64, 64, 4, 2, 128, True, False),
    ("q_shorter", 1, 64, 128, 4, 4, 64, True, True),
]


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_plain_forward_matches_interpret_kernel(case):
    _, b, s_q, s_k, h, n_kv, d, causal, alibi = case
    q, k, v, _ = _inputs(b=b, s_q=s_q, s_k=s_k, h=h, n_kv=n_kv, d=d)
    slopes = alibi_slopes(h) if alibi else None
    o, lse = fa.flash_fwd_reference(*_t(q, k, v), causal=causal, slopes=slopes)
    o_k = jax_flash(q, k, v, causal=causal, alibi=alibi, block_q=BLOCK, block_k=BLOCK,
                    interpret=True)
    assert _rel(o, o_k) < FWD_TOL
    rep = h // n_kv
    o_x = jax_xla_attention(q, np.repeat(k, rep, 2), np.repeat(v, rep, 2), causal=causal,
                            alibi=alibi)
    assert _rel(o, o_x) < FWD_TOL
    # the wrapper takes the plain version on the CPU and counts no launch
    before = dict(fa.launches)
    o_w, lse_w = fa.flash_fwd(*_t(q, k, v), causal=causal, slopes=slopes)
    assert torch.equal(o_w, o) and torch.equal(lse_w, lse) and fa.launches == before


@pytest.mark.parametrize("q_start,k_start,causal", [(64, 0, True), (0, 0, True), (32, 0, False)])
def test_plain_forward_lse_matches_ring_kernel(q_start, k_start, causal):
    q, k, v, _ = _inputs(b=2, s_q=64, s_k=64, h=4, n_kv=2, d=64, seed=1)
    o, lse = fa.flash_fwd_reference(*_t(q, k, v), causal=causal, offset=q_start - k_start)
    o_k, lse_k = jax_flash_lse(q, k, v, causal=causal, q_start=q_start, k_start=k_start,
                               block_q=BLOCK, block_k=BLOCK, interpret=True)
    assert _rel(o, o_k) < FWD_TOL
    assert _rel(lse.permute(0, 2, 1), lse_k) < FWD_TOL


BWD_CASES = [
    ("causal", 2, 64, 4, 4, 64, True, False),
    ("alibi", 2, 64, 4, 4, 64, True, True),
    ("gqa_4to1", 2, 64, 4, 1, 64, True, False),
    ("d128_gqa", 1, 64, 4, 2, 128, True, False),
    ("non_causal", 1, 128, 4, 4, 64, False, False),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_plain_backward_matches_interpret_kernel_vjp(case):
    _, b, s, h, n_kv, d, causal, alibi = case
    q, k, v, do = _inputs(b=b, s_q=s, s_k=s, h=h, n_kv=n_kv, d=d, seed=2)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=causal, alibi=alibi,
                                               block_q=BLOCK, block_k=BLOCK, interpret=True),
                     q, k, v)
    dq_k, dk_k, dv_k = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, k, v, do)
    slopes = alibi_slopes(h) if alibi else None
    o, lse = fa.flash_fwd_reference(tq, tk, tv, causal=causal, slopes=slopes)
    delta = fa.attention_delta(o, tdo)
    dq = fa.flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, causal=causal, slopes=slopes)
    dk, dv = fa.flash_bwd_dkv_reference(tq, tk, tv, tdo, lse, delta, causal=causal,
                                        slopes=slopes)
    for got, ref in ((dq, dq_k), (dk, dk_k), (dv, dv_k)):
        assert _rel(got, ref) < BWD_TOL


@pytest.mark.parametrize("alibi,n_kv", [(False, 4), (True, 4), (False, 2)])
def test_autograd_function_matches_dense_autograd(alibi, n_kv):
    q, k, v, do = _t(*_inputs(b=2, s_q=48, s_k=48, h=4, n_kv=n_kv, d=64, seed=3))
    outs = []
    for impl in ("pallas", "xla"):
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        o = multihead_attention(qq, kk, vv, impl=impl, causal=True, alibi=alibi)
        o.backward(do)
        outs.append((o.detach(), qq.grad, kk.grad, vv.grad))
    for got, ref in zip(*outs):
        assert _rel(got, ref) < BWD_TOL


def test_masked_rows_stay_finite():
    """A row that sees no key (causal with a negative offset) outputs 0 and
    an LSE of NEG_INF, and its gradients are 0: the TPU kernels' guards."""
    q, k, v, do = _t(*_inputs(b=1, s_q=16, s_k=16, h=2, n_kv=2, d=64, seed=4))
    o, lse = fa.flash_fwd(q, k, v, causal=True, offset=-4)
    assert torch.isfinite(o).all() and (o[:, :4] == 0).all()
    assert (lse[:, :, :4] == fa.NEG_INF).all() and (lse[:, :, 4:] > fa.NEG_INF / 2).all()
    delta = fa.attention_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, offset=-4)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, offset=-4)
    assert torch.isfinite(dq).all() and (dq[:, :4] == 0).all()
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    assert (dk[:, 12:] == 0).all() and (dv[:, 12:] == 0).all()  # keys no query sees


def test_wrapper_checks_raise():
    q, k, v, do = _t(*_inputs(b=1, s_q=16, s_k=16, h=4, n_kv=2, d=64))
    with pytest.raises(ValueError, match="does not fit"):
        fa.flash_fwd(q, k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="does not fit"):
        fa.flash_fwd(q[:, :, :3], k, v)  # 3 q heads over 2 kv heads
    with pytest.raises(ValueError, match="dtypes differ"):
        fa.flash_fwd(q, k.double(), v.double())
    with pytest.raises(ValueError, match="slopes"):
        fa.flash_fwd(q, k, v, slopes=torch.ones(3))
    with pytest.raises(ValueError, match="\\[B, S, H, D\\]"):
        fa.flash_fwd(q[0], k, v)
    o, lse = fa.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_bwd_dq(q, k, v, do, lse.transpose(1, 2), lse)
    with pytest.raises(ValueError, match="do must be"):
        fa.flash_bwd_dkv(q, k, v, do.double(), lse, lse)
    # the launcher's own checks (reached only for CUDA tensors on the card)
    kw = dict(causal=True, offset=0, slopes=None, scale=1.0)
    with pytest.raises(ValueError, match="head dims"):
        fa._launch("flash_fwd", q[..., :32], k[..., :32], v[..., :32], **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._launch("flash_fwd", q.half(), k.half(), v.half(), **kw)
    qs = torch.zeros(1, 16, 4, 128)[..., ::2]  # a strided head-dim axis
    with pytest.raises(ValueError, match="dense head-dim"):
        fa._launch("flash_fwd", qs, qs[:, :, :2], qs[:, :, :2], **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        odd = torch.zeros(1, 16 * 4 * 64 + 1)[:, 1:].reshape(1, 16, 4, 64)
        fa._launch("flash_fwd", odd, odd[:, :, :2], odd[:, :, :2], **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_check_takes_fused_views_and_refuses_what_tma_cannot_read(dtype):
    """The bf16 kernels read q/k/v by TMA over their own strides, and dO:
    the views of a fused QKV projection pass as they are; a head stride or
    a base that is not a multiple of 16 bytes raises (the kernels never
    copy)."""
    b, s, h, d = 2, 8, 4, 64
    qkv = torch.zeros(b, s, 3 * h * d, dtype=dtype)
    q, k, v = (x.reshape(b, s, h, d) for x in qkv.chunk(3, dim=-1))
    fa._check_layout(q, k, v, torch.zeros(b, s, h, d, dtype=dtype))
    padded = torch.zeros(b, s, h, d + 2, dtype=dtype)[..., :d]  # head stride d + 2
    with pytest.raises(ValueError, match="TMA"):
        fa._check_layout(padded, k, v)
    off = torch.zeros(b * s * h * d + 2, dtype=dtype)[2:].view(b, s, h, d)  # base 4 or 8 bytes off
    with pytest.raises(ValueError, match="TMA"):
        fa._check_layout(q, off, v)
    with pytest.raises(ValueError, match="do must be 16-byte"):
        fa._check_layout(q, k, v, off)  # a contiguous dO off its 16-byte boundary


def test_unsupported_attention_impls_refused():
    """An unknown impl raises. ``ring`` is ported: without a sequence mesh
    it is the flash path, and over a ring of 2 positions it equals full
    attention."""
    from photon_tpu_torch.config.schema import MeshConfig
    from photon_tpu_torch.parallel.context import use_mesh
    from photon_tpu_torch.parallel.mesh import make_mesh

    q, k, v, _ = _t(*_inputs(b=1, s_q=8, s_k=8, h=2, n_kv=2, d=64))
    with pytest.raises(ValueError):
        multihead_attention(q, k, v, impl="flash")
    assert torch.equal(multihead_attention(q, k, v, impl="ring"),
                       multihead_attention(q, k, v, impl="pallas"))
    with use_mesh(make_mesh(MeshConfig(sequence=2), devices=["cpu"] * 2)):
        ring = multihead_attention(q, k, v, impl="ring")
    torch.testing.assert_close(ring, xla_attention(q, k, v), rtol=1e-5, atol=1e-5)
    assert torch.allclose(xla_attention(q, k, v), multihead_attention(q, k, v, impl="xla"))
