"""Flash attention, forward and backward: the training path's attention.

Replaces the three TPU kernels of ``photon_tpu/ops/flash_attention.py``
with hand-written CUDA kernels in ``csrc/flash_attention.cu`` (built for
``sm_90a`` on first use, bound through ``ctypes``):

- K1 ``_fwd_kernel`` (:93) → :func:`flash_fwd`: ``O`` and the row
  log-sum-exp ``LSE`` as an online softmax over key tiles;
- K2 ``_bwd_dq_kernel`` (:231) → :func:`flash_bwd_dq`;
- K3 ``_bwd_dkv_kernel`` (:280) → :func:`flash_bwd_dkv`, one CTA per kv
  storage row sweeping the group's q heads (no atomics).

bf16 inputs run on tensor cores with fp32 accumulation, all three kernels
on ``wgmma`` with TMA loads, a producer warpgroup and two consumer
warpgroups taking turns, in persistent CTAs; fp32 inputs run on CUDA cores
in fp32 throughout. The TMA tensor maps are encoded over q/k/v's own
strides and over dO, so their bases and strides must be 16-byte aligned
(:func:`_check_layout` raises otherwise; nothing is copied). LSE and Delta
rows may start anywhere: K2 reads them per thread and K3 copies them 4
bytes at a time, so any ``S_q`` goes.

Shape contract: ``q [B, S_q, H, D]``, ``k/v [B, S_k, H_kv, D]`` with
``H % H_kv == 0`` (grouped-query attention is native: q head ``h`` reads kv
head ``h // (H / H_kv)``, and repeated kv never exists in memory). The
kernels read q/k/v through their strides, so the views of a fused QKV
projection go in without a copy; the dim axis must be dense. ``O`` and
the gradients are dense ``[B, S, H, D]`` in the inputs' dtype; ``LSE`` and
``Delta`` are fp32 ``[B, H, S_q]``. A key at ``kp`` is visible to a query
at ``qp`` iff ``kp <= qp + offset`` (causal; ``offset = S_k - S_q`` by
default); ALiBi adds ``-slopes[h] * (qp + offset - kp)``. Any sequence
length goes: the kernels mask the ragged edge themselves (the TPU wrapper
demands ``S % block == 0`` and pads ``D`` to 128; neither applies here).

Beside each kernel is its plain version (:func:`flash_fwd_reference`,
:func:`flash_bwd_dq_reference`, :func:`flash_bwd_dkv_reference`): the
FlashAttention-2 formulas written out densely, with the TPU kernels' casts
and guards. Each wrapper takes the plain version for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of each CUDA kernel (the plain versions do not count)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

NEG_INF = -1.0e30  # finite: masked scores never make inf - inf
HEAD_DIMS = (64, 128)
_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WHICH = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, *, causal, offset, slopes, scale):
    """fp32 scores ``[B, H_kv, G, S_q, S_k]`` (scaled, biased, masked to
    NEG_INF); GQA by grouping q heads, never by repeating kv."""
    b, s_q, h, d = q.shape
    s_k, n_kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s_q, n_kv, h // n_kv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    q_pos = torch.arange(s_q, device=q.device)[:, None] + offset
    k_pos = torch.arange(s_k, device=q.device)[None, :]
    if slopes is not None:
        sl = slopes.float().reshape(n_kv, h // n_kv)[None, :, :, None, None]
        s = s - sl * (q_pos - k_pos).float()
    if causal:
        s = s.masked_fill(k_pos > q_pos, NEG_INF)
    return s


def _grouped(x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """``[B, H, S]`` → ``[B, H_kv, G, S, 1]``."""
    b, h, s = x.shape
    return x.reshape(b, n_kv, h // n_kv, s)[..., None]


def flash_fwd_reference(q, k, v, *, causal=True, offset=None, slopes=None, scale=None):
    """The plain K1: ``(o [B, S_q, H, D], lse [B, H, S_q] fp32)``. P is cast
    to V's dtype before the second product, as in the TPU kernel."""
    b, s_q, h, d = q.shape
    s_k, n_kv = k.shape[1], k.shape[2]
    offset = s_k - s_q if offset is None else offset
    scale = d ** -0.5 if scale is None else scale
    s = _scores(q, k, causal=causal, offset=offset, slopes=slopes, scale=scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m > NEG_INF / 2, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float()) / l_safe
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d).to(q.dtype)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b, h, s_q)
    return o, lse


def _bwd_probs(q, k, v, do, lse, delta, causal, offset, slopes, scale):
    b, s_q, h, d = q.shape
    s_k, n_kv = k.shape[1], k.shape[2]
    offset = s_k - s_q if offset is None else offset
    scale = d ** -0.5 if scale is None else scale
    s = _scores(q, k, causal=causal, offset=offset, slopes=slopes, scale=scale)
    lse_g = _grouped(lse.float(), n_kv)
    p = torch.where(lse_g > NEG_INF / 2, torch.exp(s - lse_g), torch.zeros_like(s))
    do_g = do.float().reshape(b, s_q, n_kv, h // n_kv, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do_g, v.float())
    ds = p * (dp - _grouped(delta.float(), n_kv)) * scale
    return p, ds, do_g


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal=True, offset=None,
                           slopes=None, scale=None):
    """The plain K2: ``dq [B, S_q, H, D]``; dS is cast to K's dtype before
    ``dS K``, as in the TPU kernel."""
    _, ds, _ = _bwd_probs(q, k, v, do, lse, delta, causal, offset, slopes, scale)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, causal=True, offset=None,
                            slopes=None, scale=None):
    """The plain K3: ``(dk, dv)``, each ``[B, S_k, H_kv, D]``, summed over
    the group's q heads, in fp32 throughout (as the TPU kernel)."""
    b, s_q, h, d = q.shape
    n_kv = k.shape[2]
    p, ds, do_g = _bwd_probs(q, k, v, do, lse, delta, causal, offset, slopes, scale)
    qg = q.float().reshape(b, s_q, n_kv, h // n_kv, d)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do_g)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, slopes) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"want q/k/v as [B, S, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if slopes is not None and (tuple(slopes.shape) != (h,) or slopes.dtype != torch.float32):
        raise ValueError(f"slopes must be fp32 [{h}]")
    devs = {x.device for x in (q, k, v) + (() if slopes is None else (slopes,))}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _check_bwd(q, do, lse, delta) -> None:
    b, s_q, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {q.dtype} {tuple(q.shape)}, got {do.dtype} {tuple(do.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (b, h, s_q) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 [{b}, {h}, {s_q}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _check_layout(q, k, v, do=None) -> None:
    """The kernels' layout rules: a dense head-dim axis, and a 16-byte
    aligned base and batch/sequence/head strides that are multiples of 16
    bytes. The kernels load 16 bytes at a time, and the bf16 kernels read
    q/k/v (and dO, which is contiguous) by TMA, whose tensor maps take
    nothing else. Raises; never copies."""
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if x is None:
            continue
        if x.stride(3) != 1:
            raise ValueError(f"{name} needs a dense head-dim axis")
        strides = [st * x.element_size() for st in x.stride()[:3]]
        if x.data_ptr() % 16 or any(st % 16 for st in strides):
            raise ValueError(f"{name} must be 16-byte aligned on every strided axis (TMA's "
                             f"rule): base {x.data_ptr() % 16} bytes off, strides {strides} "
                             f"bytes")


def _lib() -> ctypes.CDLL:
    from photon_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    if lib.photon_flash_launch.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.photon_flash_launch.argtypes = [
            i32, i32, i32, p, p, p, ctypes.POINTER(ctypes.c_int64),
            p, p, p, p, p, p, p, p, ctypes.POINTER(i32), ctypes.c_float, p,
        ]
        lib.photon_flash_launch.restype = ctypes.c_int
        lib.photon_flash_error_string.argtypes = [i32]
        lib.photon_flash_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _launch(name, q, k, v, *, causal, offset, slopes, scale, do=None, lse=None,
            delta=None, o=None, dq=None, dk=None, dv=None) -> None:
    """Launch kernel ``name`` on q's stream; raise on a refused launch."""
    b, s_q, h, d = q.shape
    s_k, n_kv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {d}")
    for x in (do, lse, delta):
        if x is not None and not x.is_contiguous():
            raise ValueError("do, lse and delta must be contiguous")
    _check_layout(q, k, v, do)
    if q.numel() == 0 or k.numel() == 0:
        return
    lib = _lib()
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    dims = (ctypes.c_int * 7)(b, h, n_kv, s_q, s_k, int(causal), int(offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.photon_flash_launch(
            _WHICH[name], _DTYPES[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), strides,
            _ptr(do), _ptr(slopes), _ptr(delta), _ptr(lse), _ptr(o), _ptr(dq),
            _ptr(dk), _ptr(dv), dims, scale, stream,
        )
    if err:
        msg = lib.photon_flash_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    launches[name] += 1


def _defaults(q, k, offset, scale):
    offset = k.shape[1] - q.shape[1] if offset is None else int(offset)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return offset, scale


def flash_fwd(q, k, v, *, causal=True, offset=None, slopes=None, scale=None):
    """K1: ``(o, lse)``. CPU tensors → the plain version; CUDA → the kernel."""
    _check(q, k, v, slopes)
    offset, scale = _defaults(q, k, offset, scale)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, offset=offset, slopes=slopes,
                                   scale=scale)
    b, s_q, h, d = q.shape
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    slopes = None if slopes is None else slopes.contiguous()
    _launch("flash_fwd", q, k, v, causal=causal, offset=offset, slopes=slopes, scale=scale,
            o=o, lse=lse)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=True, offset=None, slopes=None,
                 scale=None):
    """K2: ``dq``. CPU tensors → the plain version; CUDA → the kernel."""
    _check(q, k, v, slopes)
    _check_bwd(q, do, lse, delta)
    offset, scale = _defaults(q, k, offset, scale)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal, offset=offset,
                                      slopes=slopes, scale=scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    slopes = None if slopes is None else slopes.contiguous()
    _launch("flash_bwd_dq", q, k, v, causal=causal, offset=offset, slopes=slopes, scale=scale,
            do=do, lse=lse, delta=delta, dq=dq)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, offset=None, slopes=None,
                  scale=None):
    """K3: ``(dk, dv)``. CPU tensors → the plain version; CUDA → the kernel."""
    _check(q, k, v, slopes)
    _check_bwd(q, do, lse, delta)
    offset, scale = _defaults(q, k, offset, scale)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=causal, offset=offset,
                                       slopes=slopes, scale=scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    slopes = None if slopes is None else slopes.contiguous()
    _launch("flash_bwd_dkv", q, k, v, causal=causal, offset=offset, slopes=slopes, scale=scale,
            do=do, lse=lse, delta=delta, dk=dk, dv=dv)
    return dk, dv


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``Delta = rowsum(dO * O)`` as fp32 ``[B, H, S_q]`` (the JAX package
    computes it outside the kernels too, ``flash_attention.py:354``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """``(o, lse) = attention(q, k, v)`` at a causal ``offset``, with K1
    forward and K2 + K3 backward. It saves q, k, v, o and LSE; the slopes
    get no gradient. A cotangent of the LSE folds into Delta (``∂lse/∂s =
    P``, so ``dS = P ∘ (dP − (Δ − dLSE))``); gradients are not
    materialized, so a caller that drops the LSE passes None for it."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, causal, offset, scale):
        o, lse = flash_fwd(q, k, v, causal=causal, offset=offset, slopes=slopes, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse, slopes)
        ctx.opts = dict(causal=causal, offset=offset, scale=scale)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, slopes = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        delta = attention_delta(o, do)
        if dlse is not None:
            delta = (delta - dlse.float()).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, slopes=slopes, **ctx.opts)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, slopes=slopes, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, alibi=False):
    """Differentiable attention over ``[B, S, H, D]`` inputs through K1–K3
    (the counterpart of ``photon_tpu``'s ``flash_attention``), with query
    positions aligned to the end of the keys and ALiBi slopes
    ``alibi_slopes(H)``. Without a gradient to take (``inference_mode``,
    ``no_grad``, or inputs that need none) it is K1 alone, and nothing is
    kept for a backward."""
    slopes = None
    if alibi:
        from photon_tpu_torch.ops.attention import alibi_slopes

        slopes = alibi_slopes(q.shape[2], q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, slopes, causal, None, None)[0]
    return flash_fwd(q, k, v, causal=causal, slopes=slopes)[0]


def flash_attention_with_lse(q, k, v, *, causal=True, q_start=0, k_start=0, slopes=None):
    """Attention of a query chunk over a key chunk at global positions
    (``q_start``/``k_start`` are the chunks' sequence offsets), returning
    ``(o [B, S_q, H, D], lse [B, S_q, H])`` in JAX's layout for the
    online-softmax merge of ring attention (the counterpart of
    ``photon_tpu``'s ``flash_attention_with_lse``). K1 runs at ``offset =
    q_start − k_start``; ``slopes`` (fp32 ``[H]``, these heads' slice of
    the global table) add ALiBi at global distances. Rows that see no key
    come back as ``(0, NEG_INF)``. Its backward takes the gradient of both
    outputs: the JAX package recomputes the chunk densely in XLA for it;
    here K2 and K3 compute the same function with ``Δ − dLSE`` in Delta's
    place (:class:`FlashAttention`, the Function :func:`flash_attention`
    runs too). Grouped-query k/v go in at their own width. CPU tensors run the
    plain K1–K3."""
    offset = int(q_start) - int(k_start)
    if slopes is not None:
        slopes = slopes.to(device=q.device, dtype=torch.float32)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = FlashAttention.apply(q, k, v, slopes, causal, offset, None)
    else:
        o, lse = flash_fwd(q, k, v, causal=causal, offset=offset, slopes=slopes)
    return o, lse.transpose(1, 2)
