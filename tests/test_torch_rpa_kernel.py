"""The CUDA ragged-paged-attention kernel against its plain version.

Every case needs the card (marker ``cuda``; skips without one). This file
imports no JAX, so it runs on a machine without it; ``tests/conftest.py``
does import JAX, hence ``--noconftest`` there::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rpa_kernel.py

Gates: fp32 relative L2 <= 1e-5 (the two sum in different orders); bf16
<= 2e-2 (the reference harness's forward gate, ``bench.py``).
"""

import numpy as np
import pytest
import torch

from photon_tpu_torch.ops import ragged_paged_attention as rpa
from photon_tpu_torch.ops.attention import alibi_slopes

# fp32 matmuls stay full fp32 (the fp32 gate compares against them)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rel(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / (np.linalg.norm(ref) + 1e-12))


def _case(seed, *, b, t, h, n_kv, dh, bs, nb, n_ctx, n_layers=1):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.standard_normal((b, t, h, dh)).astype(np.float32),
        kp=rng.standard_normal((nb, n_layers, bs, n_kv, dh)).astype(np.float32),
        vp=rng.standard_normal((nb, n_layers, bs, n_kv, dh)).astype(np.float32),
        rows=rng.integers(0, nb, (b, n_ctx)).astype(np.int32),
        pos=rng.integers(0, n_ctx * bs, (b, t)).astype(np.int32),
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


KERNEL_GATES = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    dict(b=8, t=1, h=12, n_kv=12, dh=64, alibi=False),   # mpt-125m decode
    dict(b=1, t=512, h=12, n_kv=12, dh=64, alibi=False),  # mpt-125m chunk
    dict(b=8, t=1, h=16, n_kv=4, dh=128, alibi=False),   # llama-1b decode
    dict(b=1, t=64, h=12, n_kv=12, dh=64, alibi=True),   # ALiBi chunk
])
def test_kernel_matches_plain(cuda, dtype, shape):
    c = _case(21, b=shape["b"], t=shape["t"], h=shape["h"], n_kv=shape["n_kv"],
              dh=shape["dh"], bs=16, nb=65, n_ctx=32, n_layers=3)
    c["pos"] = np.sort(c["pos"], axis=1)
    q, kp, vp = (torch.from_numpy(c[k]).to(cuda, dtype) for k in ("q", "kp", "vp"))
    rows, pos = torch.from_numpy(c["rows"]).to(cuda), torch.from_numpy(c["pos"]).to(cuda)
    slopes = alibi_slopes(shape["h"], cuda) if shape["alibi"] else None
    before = rpa.launches
    out = rpa.ragged_paged_attention(q, kp, vp, 2, rows, pos, slopes=slopes)
    torch.cuda.synchronize()
    assert rpa.launches == before + 1
    kb, vb = rpa.live_view(kp, vp, 2, rows)
    ref = rpa.ragged_reference_attention(q, kb, vb, pos, slopes=slopes)
    assert _rel(out.float().cpu(), ref.float().cpu()) <= KERNEL_GATES[dtype]


@pytest.mark.cuda
def test_kernel_rejects_unsupported_head_dim(cuda):
    c = _case(2, b=1, t=1, h=2, n_kv=2, dh=32, bs=4, nb=3, n_ctx=2)
    args = [torch.from_numpy(c[k]).to(cuda) for k in ("q", "kp", "vp")]
    with pytest.raises(ValueError):
        rpa.ragged_paged_attention(*args, 0, torch.from_numpy(c["rows"]).to(cuda),
                                   torch.from_numpy(c["pos"]).to(cuda))


@pytest.mark.cuda
def test_kernel_row_that_sees_no_key_is_zero(cuda):
    c = _case(9, b=2, t=3, h=4, n_kv=4, dh=64, bs=16, nb=5, n_ctx=2)
    c["pos"][0, 1] = -1
    args = [torch.from_numpy(c[k]).to(cuda) for k in ("q", "kp", "vp")]
    out = rpa.ragged_paged_attention(*args, 0, torch.from_numpy(c["rows"]).to(cuda),
                                     torch.from_numpy(c["pos"]).to(cuda))
    assert torch.isfinite(out).all() and bool((out[0, 1] == 0).all())
