"""The CUDA flash-attention kernels (K1 forward, K2 dQ, K3 dK/dV) against
their plain versions.

Every case needs the card (marker ``cuda``; skips without one). This file
imports no JAX, so it runs on a machine without it; ``tests/conftest.py``
does import JAX, hence ``--noconftest`` there::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_kernel.py

Gates (relative L2 against the plain version on the same inputs): fp32
forward 1e-5 and backward 1e-4 (the two sum in different orders; the
backward's dS and dK sums run over up to S_q terms); bf16 forward 2e-2 and
backward 4e-2 (the reference harness's gates, ``bench.py``).
"""

import numpy as np
import pytest
import torch

from photon_tpu_torch.ops import flash_attention as fa
from photon_tpu_torch.ops.attention import alibi_slopes
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FWD_GATE = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_GATE = {torch.float32: 1e-4, torch.bfloat16: 4e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, ref) -> float:
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm().clamp_min(1e-12))


def _inputs(dev, dtype, *, b, s_q, s_k, h, n_kv, d, seed=0, fused=False):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    if fused:  # q/k/v as strided views of one [B, S, 3 * H * D] projection
        qkv = t(b, s_q, 3 * h * d)
        q, k, v = (x.reshape(b, s_q, h, d) for x in qkv.chunk(3, dim=-1))
    else:
        q, k, v = t(b, s_q, h, d), t(b, s_k, n_kv, d), t(b, s_k, n_kv, d)
    return q, k, v, t(b, s_q, h, d)


CASES = [
    # name, b, s_q, s_k, h, n_kv, d, causal, alibi, offset, fused
    ("mha_fused", 2, 256, 256, 4, 4, 64, True, False, None, True),
    ("gqa_d128", 1, 192, 192, 8, 2, 128, True, False, None, False),
    ("alibi", 2, 128, 128, 4, 4, 64, True, True, None, False),
    ("ragged_edge", 1, 200, 200, 2, 2, 64, True, False, None, False),
    ("non_causal", 1, 100, 160, 4, 2, 64, False, False, None, False),
    ("q_shorter", 1, 96, 224, 4, 4, 128, True, True, None, False),
    ("ring_offset", 1, 128, 128, 2, 2, 64, True, False, -64, False),
    # more work items than SMs: every persistent CTA of K2 and K3 takes several
    ("many_items", 4, 1024, 1024, 8, 8, 64, True, False, None, False),
    ("gqa4_ragged_d128", 1, 1000, 1000, 8, 2, 128, True, False, None, False),
    # LSE/Delta rows that do not start on a 16-byte boundary
    ("s97", 2, 97, 97, 2, 2, 64, True, False, None, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernels_match_plain_versions(cuda, dtype, case):
    _, b, s_q, s_k, h, n_kv, d, causal, alibi, offset, fused = case
    q, k, v, do = _inputs(cuda, dtype, b=b, s_q=s_q, s_k=s_k, h=h, n_kv=n_kv, d=d, fused=fused)
    kw = dict(causal=causal, offset=offset, slopes=alibi_slopes(h, cuda) if alibi else None)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, **kw)
    assert torch.isfinite(o).all() and _rel(o, o_ref) <= FWD_GATE[dtype]
    live = lse_ref > fa.NEG_INF / 2
    assert torch.equal(lse > fa.NEG_INF / 2, live)
    assert _rel(lse[live], lse_ref[live]) <= FWD_GATE[dtype]

    delta = fa.attention_delta(o_ref, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, do, lse_ref, delta, **kw)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert torch.isfinite(got).all() and _rel(got, ref) <= BWD_GATE[dtype]
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_dkv_kernel_gives_the_same_bits_twice(cuda, kernel):
    """K2 and K3 each own their outputs' rows in one CTA (no atomics)."""
    q, k, v, do = _inputs(cuda, torch.bfloat16, b=2, s_q=256, s_k=256, h=8, n_kv=2, d=64)
    o, lse = fa.flash_fwd(q, k, v)
    delta = fa.attention_delta(o, do)

    def grads():
        out = getattr(fa, kernel)(q, k, v, do, lse, delta)
        return out if isinstance(out, tuple) else (out,)

    first, second = grads(), grads()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_autograd_function_matches_dense_autograd(cuda):
    from photon_tpu_torch.ops.attention import xla_attention

    q, k, v, do = _inputs(cuda, torch.float32, b=2, s_q=192, s_k=192, h=4, n_kv=4, d=64)
    grads = []
    for fn in (fa.flash_attention, xla_attention):
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = fn(qq, kk, vv, causal=True, alibi=True)
        out.backward(do)
        grads.append((out.detach(), qq.grad, kk.grad, vv.grad))
    for got, ref in zip(*grads):
        assert _rel(got, ref) <= BWD_GATE[torch.float32]


@pytest.mark.cuda
def test_kernel_refuses_an_unsupported_head_dim(cuda):
    q, k, v, _ = _inputs(cuda, torch.bfloat16, b=1, s_q=64, s_k=64, h=2, n_kv=2, d=64)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(q[..., :32], k[..., :32], v[..., :32])


@pytest.mark.cuda
def test_forward_at_training_length_on_fused_views(cuda):
    """bf16 K1 at S = 2048, D = 64 on the strided q/k/v views of one fused
    projection (as training feeds it): 16 q tiles of 128 rows, 16 key tiles."""
    q, k, v, _ = _inputs(cuda, torch.bfloat16, b=2, s_q=2048, s_k=2048, h=4, n_kv=4, d=64,
                         fused=True)
    assert q.stride(1) == 3 * 4 * 64
    o, lse = fa.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
    assert torch.isfinite(o).all() and _rel(o, o_ref) <= FWD_GATE[torch.bfloat16]
    assert _rel(lse, lse_ref) <= FWD_GATE[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["row_stride", "base"])
def test_forward_refuses_views_that_break_tma(cuda, bad):
    q, k, v, _ = _inputs(cuda, torch.bfloat16, b=1, s_q=128, s_k=128, h=2, n_kv=2, d=64)
    if bad == "row_stride":  # a head stride of 68 elements: 136 bytes
        q = torch.zeros((1, 128, 2, 68), dtype=torch.bfloat16, device=cuda)[..., :64]
    else:  # a base 8 bytes off a 16-byte boundary
        flat = torch.zeros(128 * 2 * 64 + 4, dtype=torch.bfloat16, device=cuda)
        q = flat[4:].view(1, 128, 2, 64)
    before = fa.launches["flash_fwd"]
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_fwd(q, k, v)
    assert fa.launches["flash_fwd"] == before


@pytest.mark.cuda
def test_inference_mode_launches_the_forward_alone(cuda):
    """Without a gradient to take (the eval forward, ``inference_mode``),
    ``flash_attention`` launches K1 once a call and no backward kernel,
    with the bits of a direct K1 launch, at the eval shape's S = 512."""
    q, k, v, _ = _inputs(cuda, torch.bfloat16, b=2, s_q=512, s_k=512, h=4, n_kv=4, d=64,
                         fused=True)
    before = dict(fa.launches)
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == \
        {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert not out.requires_grad and torch.equal(out, fa.flash_fwd(q, k, v)[0])
    o_ref, _ = fa.flash_fwd_reference(q, k, v)
    assert _rel(out, o_ref) <= FWD_GATE[torch.bfloat16]
