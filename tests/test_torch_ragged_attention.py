"""The port's ragged paged attention against the JAX package's.

CPU cases (fp32, tiny shapes, inputs from a numpy seed):

1. the port's plain version (the wrapper on CPU tensors) against JAX's
   fused kernel in interpret mode and JAX's dense reference, over token
   buckets × {MHA, ALiBi, GQA} and a recycled table with trash entries,
   at the JAX package's own pin ``RAGGED_KERNEL_EPS``;
2. a layer of a strided ``[NB, L, bs, H_kv, Dh]`` pool gives exactly what
   the same layer copied out contiguous gives;
3. CPU calls never touch the launch counter; bad inputs raise.

The CUDA kernel's own cases are in ``test_torch_rpa_kernel.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops.attention import alibi_slopes as jax_alibi_slopes
from photon_tpu.ops.ragged_paged_attention import (
    live_view as jax_live_view,
)
from photon_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from photon_tpu.ops.ragged_paged_attention import (
    ragged_reference_attention as jax_reference,
)
from photon_tpu_torch.ops import ragged_paged_attention as rpa
from photon_tpu_torch.ops.attention import alibi_slopes
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

#: the JAX package's pin for its fused kernel vs the dense reference,
#: fp32 (tests/test_ragged_attention.py RAGGED_KERNEL_EPS)
RAGGED_KERNEL_EPS = 2e-6


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


def _port(c, layer=0, slopes=None):
    return rpa.ragged_paged_attention(
        torch.from_numpy(c["q"]), torch.from_numpy(c["kp"]), torch.from_numpy(c["vp"]),
        layer, torch.from_numpy(c["rows"]), torch.from_numpy(c["pos"]), slopes=slopes,
    ).numpy()


def _jax_both(c, layer=0, alibi=False):
    kp, vp = jnp.asarray(c["kp"][:, layer]), jnp.asarray(c["vp"][:, layer])
    q, rows, pos = jnp.asarray(c["q"]), jnp.asarray(c["rows"]), jnp.asarray(c["pos"])
    slopes = jax_alibi_slopes(c["q"].shape[2]) if alibi else None
    kern = jax_rpa(q, kp, vp, rows, pos, slopes=slopes, interpret=True)
    kb, vb = jax_live_view(kp, vp, rows)
    ref = jax_reference(q, kb, vb, pos, slopes=slopes)
    return np.asarray(kern), np.asarray(ref)


@pytest.mark.parametrize("t", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["mha", "alibi", "gqa"])
def test_plain_matches_jax_kernel(t, kind):
    h = 4
    c = _case(7, b=3, t=t, h=h, n_kv=2 if kind == "gqa" else h, dh=8, bs=4, nb=17, n_ctx=4)
    alibi = kind == "alibi"
    out = _port(c, slopes=alibi_slopes(h) if alibi else None)
    kern, ref = _jax_both(c, alibi=alibi)
    assert _rel(out, kern) < RAGGED_KERNEL_EPS, (t, kind)
    assert _rel(out, ref) < RAGGED_KERNEL_EPS, (t, kind)


def test_plain_matches_jax_on_recycled_table():
    """Shuffled, shared physical blocks with trash-id tails (the
    post-eviction pool): only positions <= each query's own count."""
    c = _case(11, b=2, t=2, h=2, n_kv=2, dh=8, bs=4, nb=6, n_ctx=8)
    c["rows"] = np.array([[0, 3, 3, 1, 5, 5, 5, 5],
                          [3, 0, 2, 4, 5, 5, 5, 5]], np.int32)
    c["pos"] = np.array([[6, 13], [0, 30]], np.int32)
    out = _port(c)
    kern, ref = _jax_both(c)
    assert _rel(out, kern) < RAGGED_KERNEL_EPS
    assert _rel(out, ref) < RAGGED_KERNEL_EPS


def test_alibi_slopes_match_jax():
    for h in (4, 12, 16):
        np.testing.assert_array_equal(alibi_slopes(h).numpy(), np.asarray(jax_alibi_slopes(h)))


def test_strided_layer_view_equals_contiguous_pool():
    c = _case(3, b=2, t=3, h=4, n_kv=2, dh=8, bs=4, nb=9, n_ctx=4, n_layers=3)
    strided = _port(c, layer=1)
    flat = dict(c, kp=np.ascontiguousarray(c["kp"][:, 1:2]),
                vp=np.ascontiguousarray(c["vp"][:, 1:2]))
    np.testing.assert_array_equal(strided, _port(flat, layer=0))


def test_cpu_calls_leave_launch_counter_at_zero():
    c = _case(5, b=2, t=1, h=4, n_kv=4, dh=8, bs=4, nb=5, n_ctx=2)
    _port(c)
    assert rpa.launches == 0


def test_row_that_sees_no_key_is_zero():
    c = _case(9, b=1, t=2, h=2, n_kv=2, dh=8, bs=4, nb=3, n_ctx=2)
    c["pos"] = np.array([[-1, 3]], np.int32)
    out = _port(c)
    assert np.all(out[0, 0] == 0.0) and np.all(np.isfinite(out))


@pytest.mark.parametrize("bad", ["rows_dtype", "pos_shape", "dtype_mix", "layer", "heads"])
def test_wrapper_rejects_bad_inputs(bad):
    c = _case(1, b=2, t=2, h=4, n_kv=2, dh=8, bs=4, nb=5, n_ctx=2, n_layers=2)
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    rows, pos, layer = torch.from_numpy(c["rows"]), torch.from_numpy(c["pos"]), 0
    if bad == "rows_dtype":
        rows = rows.long()
    elif bad == "pos_shape":
        pos = pos[:, :1]
    elif bad == "dtype_mix":
        q = q.double()
    elif bad == "layer":
        layer = 2
    else:
        q = q[:, :, :3]
    with pytest.raises(ValueError):
        rpa.ragged_paged_attention(q, kp, vp, layer, rows, pos)
