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
    # speculative verify: each row's [last, drafts] at consecutive
    # positions, rows at different depths; every key past a query's own
    # position holds data (a later draft's), which only a per-query mask hides
    dict(b=8, t=8, h=12, n_kv=12, dh=64, alibi=False, verify=True),  # mpt-125m, split
    dict(b=8, t=4, h=16, n_kv=4, dh=128, alibi=False, verify=True),  # llama-1b, bf16 chunk
])
def test_kernel_matches_plain(cuda, dtype, shape):
    c = _case(21, b=shape["b"], t=shape["t"], h=shape["h"], n_kv=shape["n_kv"],
              dh=shape["dh"], bs=16, nb=65, n_ctx=32, n_layers=3)
    c["pos"] = np.sort(c["pos"], axis=1)
    if shape.get("verify"):
        depth = np.random.default_rng(22).integers(0, 32 * 16 - shape["t"], shape["b"])
        c["pos"] = (depth[:, None] + np.arange(shape["t"])).astype(np.int32)
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


def _engine_decode(seed, dtype, dev, positions, *, h=12, n_kv=12, dh=64, n_layers=2):
    """Decode at the engine's full width: n_ctx = 128 blocks of 16 tokens,
    slots of very different lengths, distinct blocks per slot and the trash
    block past each slot's end (as the allocator leaves them)."""
    rng = np.random.default_rng(seed)
    b, bs, n_ctx = len(positions), 16, 128
    nb = b * n_ctx + 1
    rows = np.full((b, n_ctx), nb - 1, np.int32)
    perm = rng.permutation(nb - 1)
    for i, p in enumerate(positions):
        need = min(n_ctx, max(p, 0) // bs + 1)
        rows[i, :need] = perm[i * n_ctx: i * n_ctx + need]

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    q = t(b, 1, h, dh)
    kp, vp = t(nb, n_layers, bs, n_kv, dh), t(nb, n_layers, bs, n_kv, dh)
    pos = torch.tensor(np.array(positions, np.int32)[:, None], device=dev)
    return q, kp, vp, torch.from_numpy(rows).to(dev), pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(12, 12, 64), (16, 4, 128)], ids=["mha_d64", "gqa_d128"])
def test_split_decode_spans_many_splits(cuda, dtype, heads):
    h, n_kv, dh = heads
    positions = [2047, 1999, 1024, 700, 255, 256, 17, 0]
    q, kp, vp, rows, pos = _engine_decode(31, dtype, cuda, positions, h=h, n_kv=n_kv, dh=dh)
    assert rpa.regime(1, h // n_kv, dtype) == "split" and rpa.split_plan(128 * 16)[0] == 8
    before = rpa.launches
    out = rpa.ragged_paged_attention(q, kp, vp, 1, rows, pos)
    torch.cuda.synchronize()
    assert rpa.launches == before + 1  # the split and its merge count once
    ref = rpa.ragged_reference_attention(q, *rpa.live_view(kp, vp, 1, rows), pos)
    assert _rel(out.float().cpu(), ref.float().cpu()) <= KERNEL_GATES[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_slot_with_no_visible_key(cuda, dtype):
    q, kp, vp, rows, pos = _engine_decode(37, dtype, cuda, [1500, -1, 40, 2047])
    out = rpa.ragged_paged_attention(q, kp, vp, 0, rows, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and bool((out[1] == 0).all())
    ref = rpa.ragged_reference_attention(q, *rpa.live_view(kp, vp, 0, rows), pos)
    assert _rel(out.float().cpu(), ref.float().cpu()) <= KERNEL_GATES[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 512], ids=["split_decode", "chunk"])
def test_kernel_gives_the_same_bits_twice(cuda, t):
    if t == 1:
        q, kp, vp, rows, pos = _engine_decode(41, torch.bfloat16, cuda, [2047, 900, 300, 1])
    else:
        c = _case(43, b=1, t=t, h=12, n_kv=12, dh=64, bs=16, nb=129, n_ctx=128)
        c["pos"] = np.arange(1024, 1024 + t, dtype=np.int32)[None]
        q, kp, vp = (torch.from_numpy(c[k]).to(cuda, torch.bfloat16) for k in ("q", "kp", "vp"))
        rows, pos = torch.from_numpy(c["rows"]).to(cuda), torch.from_numpy(c["pos"]).to(cuda)
    first = rpa.ragged_paged_attention(q, kp, vp, 0, rows, pos)
    second = rpa.ragged_paged_attention(q, kp, vp, 0, rows, pos)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alibi", [False, True])
def test_chunk_of_512_tokens(cuda, dtype, alibi):
    c = _case(47, b=1, t=512, h=12, n_kv=12, dh=64, bs=16, nb=129, n_ctx=128, n_layers=2)
    c["pos"] = np.arange(1024, 1536, dtype=np.int32)[None]
    q, kp, vp = (torch.from_numpy(c[k]).to(cuda, dtype) for k in ("q", "kp", "vp"))
    rows, pos = torch.from_numpy(c["rows"]).to(cuda), torch.from_numpy(c["pos"]).to(cuda)
    slopes = alibi_slopes(12, cuda) if alibi else None
    out = rpa.ragged_paged_attention(q, kp, vp, 1, rows, pos, slopes=slopes)
    torch.cuda.synchronize()
    ref = rpa.ragged_reference_attention(q, *rpa.live_view(kp, vp, 1, rows), pos, slopes=slopes)
    assert _rel(out.float().cpu(), ref.float().cpu()) <= KERNEL_GATES[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_hit_chunk_shares_blocks(cuda, dtype):
    """A prefix hit: row 0's chunk starts at depth 3 blocks, and its table
    maps the same first 3 physical blocks as row 1's (the donor's), whose
    own chunk runs further on."""
    c = _case(53, b=2, t=64, h=12, n_kv=12, dh=64, bs=16, nb=65, n_ctx=16, n_layers=2)
    perm = np.random.default_rng(54).permutation(64).astype(np.int32)
    c["rows"] = np.stack([perm[:16], np.concatenate([perm[:3], perm[16:29]])])
    c["pos"] = np.stack([np.arange(48, 112), np.arange(100, 164)]).astype(np.int32)
    q, kp, vp = (torch.from_numpy(c[k]).to(cuda, dtype) for k in ("q", "kp", "vp"))
    rows, pos = torch.from_numpy(c["rows"]).to(cuda), torch.from_numpy(c["pos"]).to(cuda)
    out = rpa.ragged_paged_attention(q, kp, vp, 1, rows, pos)
    torch.cuda.synchronize()
    ref = rpa.ragged_reference_attention(q, *rpa.live_view(kp, vp, 1, rows), pos)
    assert _rel(out.float().cpu(), ref.float().cpu()) <= KERNEL_GATES[dtype]
