"""Ragged paged attention: the serving step's attention over the KV pool.

Replaces the TPU kernel ``photon_tpu/ops/ragged_paged_attention.py::
_rpa_kernel`` (launched by ``ragged_paged_attention`` there) with the
hand-written CUDA kernel ``csrc/ragged_paged_attention.cu``, built for
``sm_90a`` on first use and bound through ``ctypes``.

Shape contract (one transformer layer):

- ``q``          ``[B, T, H, Dh]`` — ``B`` slots × ``T`` query tokens.
- ``k_pool/v_pool`` ``[NB, L, bs, H_kv, Dh]`` — the whole paged pool; the
  call reads layer ``layer`` of it through its strides (a per-layer view
  is never copied).
- ``rows``       ``[B, n_ctx]`` int32 — each slot's block-table slice; dead
  entries point at the trash block and are masked.
- ``positions``  ``[B, T]`` int32 — each query's absolute position. Key
  position ``p`` is visible to a query at ``pos`` iff ``p <= pos``.

Returns ``[B, T, H, Dh]`` in ``q``'s dtype; fp32 scores and accumulators.

Decode is bound by memory: per slot and layer it reads ``n_ctx · bs ·
H_kv · Dh · 2`` bytes of K and V (plus q and out) for 4 flops per (query,
key, head, dim); a long prompt chunk is bound by operations. Both regimes
(see the source) read only the blocks a tile's queries can see, straight
from the pool through the table. The wrapper picks the regime from shapes
the host knows, never from device data: ``T · group < 16`` rows per
(slot, kv head), and every fp32 call, go to the split-K kernel on CUDA
cores, whose per-split partials (:func:`split_plan` sets the splits from
``n_ctx · bs``) a second kernel merges in split order; bf16 calls with
``T · group >= 16`` go to the chunk kernel on tensor cores. A split and
its merge count as one launch.

:func:`ragged_reference_attention` over :func:`live_view` is the plain
version: one dense masked softmax over the gathered live blocks. The
wrapper takes it for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. :func:`split_partials` and :func:`combine_partials` write
the split-K arithmetic out plainly, for the tests.
"""

from __future__ import annotations

import ctypes

import torch

#: wrapper calls that launched the CUDA kernels (a split and its merge count
#: once; the plain version does not count)
launches = 0

NEG_INF = -1.0e30  # finite: masked scores never make inf - inf
LOG2E = 1.4426950408889634
#: keys of one split of the split-K regime (four 64-key tiles)
SPLIT_KEYS = 256
#: rows per (slot, kv head) from which bf16 calls take the tensor-core kernel
CHUNK_MIN_ROWS = 16
_SOURCE = "ragged_paged_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MODES = {"split": 0, "chunk": 1}


def split_plan(n_keys: int) -> tuple[int, int]:
    """``(n_split, split_keys)`` of the split-K regime for a walk of
    ``n_keys = n_ctx · bs`` keys: splits of ``SPLIT_KEYS`` keys, the last
    one ragged. Known on the host, so no step reads device data to plan."""
    return max(1, -(-n_keys // SPLIT_KEYS)), SPLIT_KEYS


def regime(t: int, group: int, dtype: torch.dtype) -> str:
    """Which kernel a call takes: ``"chunk"`` (tensor cores) for bf16 with
    at least ``CHUNK_MIN_ROWS`` rows per (slot, kv head), else ``"split"``."""
    return "chunk" if dtype == torch.bfloat16 and t * group >= CHUNK_MIN_ROWS else "split"


def live_view(k_pool: torch.Tensor, v_pool: torch.Tensor, layer: int,
              rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather layer ``layer``'s live blocks behind ``rows [B, n_ctx]``
    into contiguous per-slot views ``[B, n_ctx * bs, H_kv, Dh]``."""
    kl, vl = k_pool[:, layer], v_pool[:, layer]
    b, n_ctx = rows.shape
    bs = kl.shape[1]
    rows = rows.long()
    kb = kl[rows].reshape(b, n_ctx * bs, *kl.shape[2:])
    vb = vl[rows].reshape(b, n_ctx * bs, *vl.shape[2:])
    return kb, vb


def ragged_reference_attention(q: torch.Tensor, kb: torch.Tensor,
                               vb: torch.Tensor, positions: torch.Tensor, *,
                               scale: float | None = None,
                               slopes: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version, over an already-gathered live view: the grouped
    einsum of ``photon_tpu``'s ``ragged_reference_attention`` (fp32
    scores, probabilities cast to V's dtype for the second product). A
    row that sees no key returns 0, as the kernel does.

    ``q [B, T, H, Dh]``, ``kb/vb [B, S, H_kv, Dh]``, ``positions [B, T]``;
    ``slopes [H]`` arms the ALiBi distance bias."""
    b, t, h, d = q.shape
    s, n_kv = kb.shape[1], kb.shape[2]
    group = h // n_kv
    scale = (1.0 / d ** 0.5) if scale is None else scale
    k_pos = torch.arange(s, device=q.device)
    valid = k_pos[None, None, :] <= positions[:, :, None]  # [B, T, S]
    qg = q.reshape(b, t, n_kv, group, d)
    scores = torch.einsum("btkgd,bskd->btkgs", qg.float(), kb.float()) * scale
    if slopes is not None:
        dist = (positions[:, :, None] - k_pos).float()  # [B, T, S]
        sl = slopes.float().reshape(n_kv, group)
        scores = scores - sl[None, None, :, :, None] * dist[:, :, None, None, :]
    scores = scores.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = probs.masked_fill(~valid.any(-1)[:, :, None, None, None], 0.0)
    out = torch.einsum("btkgs,bskd->btkgd", probs.to(vb.dtype), vb)
    return out.reshape(b, t, h, d)


def split_partials(q: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor,
                   positions: torch.Tensor, split_keys: int, *,
                   scale: float | None = None,
                   slopes: torch.Tensor | None = None):
    """The split-K kernel's partials, plainly: for each split ``s`` of the
    key axis (keys ``s · split_keys`` onward), ``m`` (the split's largest
    visible logit, in log2 units; NEG_INF if it sees none), ``l`` (the sum
    of ``exp2(x - m)``) and ``acc`` (those probabilities in V's dtype times
    V). ``m, l [B, T, H, n_split]``, ``acc [B, T, H, n_split, Dh]``, fp32."""
    b, t, h, d = q.shape
    s, n_kv = kb.shape[1], kb.shape[2]
    group = h // n_kv
    scale = (1.0 / d ** 0.5) if scale is None else scale
    k_pos = torch.arange(s, device=q.device)
    valid = k_pos[None, None, :] <= positions[:, :, None]  # [B, T, S]
    qg = q.reshape(b, t, n_kv, group, d)
    x = torch.einsum("btkgd,bskd->btkgs", qg.float(), kb.float()) * (scale * LOG2E)
    if slopes is not None:
        dist = (positions[:, :, None] - k_pos).float()
        sl = slopes.float().reshape(n_kv, group) * LOG2E
        x = x - sl[None, None, :, :, None] * dist[:, :, None, None, :]
    x = x.masked_fill(~valid[:, :, None, None, :], NEG_INF).reshape(b, t, h, s)
    ms, ls, accs = [], [], []
    for lo in range(0, s, split_keys):
        xs = x[..., lo:lo + split_keys]
        m = xs.amax(-1, keepdim=True)
        p = torch.where(m > NEG_INF / 2, torch.exp2(xs - m), torch.zeros_like(xs))
        vs = vb[:, lo:lo + split_keys].float().repeat_interleave(group, dim=2)
        ms.append(m[..., 0])
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bths,bshd->bthd", p.to(vb.dtype).float(), vs))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The combine kernel, plainly: merge ``(m, l, acc)`` over the split
    axis (m in log2 units); a row that saw no key gives 0. ``m, l [..., n]``,
    ``acc [..., n, Dh]`` → ``[..., Dh]`` fp32."""
    mm = m.amax(-1, keepdim=True)
    live = mm > NEG_INF / 2
    f = torch.where(live, torch.exp2(m - mm), torch.zeros_like(m))
    ll = (l * f).sum(-1, keepdim=True)
    aa = (acc * f[..., None]).sum(-2)
    return torch.where(ll == 0, torch.zeros_like(aa), aa / torch.where(ll == 0, 1.0, ll))


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, layer: int,
                           rows: torch.Tensor, positions: torch.Tensor, *,
                           scale: float | None = None,
                           slopes: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of ``q`` over layer ``layer`` of the paged pool (module
    docstring has the contract). CPU tensors → the plain version; CUDA
    tensors → the kernel."""
    _check(q, k_pool, v_pool, layer, rows, positions, slopes)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        kb, vb = live_view(k_pool, v_pool, layer, rows)
        return ragged_reference_attention(q, kb, vb, positions, scale=scale, slopes=slopes)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, layer, rows, positions, scale, slopes)


def _check(q, k_pool, v_pool, layer, rows, positions, slopes) -> None:
    if q.dim() != 4 or k_pool.dim() != 5:
        raise ValueError(f"want q [B,T,H,Dh] and pool [NB,L,bs,H_kv,Dh], got "
                         f"{tuple(q.shape)} / {tuple(k_pool.shape)}")
    b, t, h, d = q.shape
    _, n_layers, _, n_kv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or v_pool.stride() != k_pool.stride():
        raise ValueError("k and v pools must share shape and strides")
    if dk != d or h % n_kv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool {tuple(k_pool.shape)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside the pool's {n_layers} layers")
    if rows.dim() != 2 or rows.shape[0] != b or rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32 [{b}, n_ctx], got {rows.dtype} {tuple(rows.shape)}")
    if tuple(positions.shape) != (b, t) or positions.dtype != torch.int32:
        raise ValueError(f"positions must be int32 [{b}, {t}], got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"q is {q.dtype} but the pool is {k_pool.dtype}")
    if slopes is not None and (tuple(slopes.shape) != (h,) or slopes.dtype != torch.float32):
        raise ValueError(f"slopes must be fp32 [{h}]")
    devs = {x.device for x in (q, k_pool, v_pool, rows, positions)}
    if slopes is not None:
        devs.add(slopes.device)
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def _lib() -> ctypes.CDLL:
    from photon_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    if lib.photon_rpa_launch.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.photon_rpa_launch.argtypes = [
            i32, i32, i32, p, i64, i64, p, p, i64, i64, i64, i64, i32,
            p, i64, p, i64, i64, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, p,
        ]
        lib.photon_rpa_launch.restype = ctypes.c_int
        lib.photon_rpa_error_string.argtypes = [i32]
        lib.photon_rpa_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k_pool, v_pool, layer, rows, positions, scale, slopes):
    global launches
    b, t, h, d = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {_HEAD_DIMS}, not {d}")
    if q.stride(3) != 1 or q.stride(2) != d:
        raise ValueError("q's head and dim axes must be dense")
    if k_pool.stride(4) != 1:
        raise ValueError("the pool's dim axis must be dense")
    if any(x.shape[1] > 1 and x.stride(1) != 1 for x in (rows, positions)):
        raise ValueError("rows and positions must be dense along their last axis")
    vec = 16 // q.element_size()  # the kernel's 16-byte loads
    strides = (q.stride(0), q.stride(1), *k_pool.stride()[:4])
    ptrs = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr())
    if any(s % vec for s in strides) or any(p % 16 for p in ptrs):
        raise ValueError("q and pool must be 16-byte aligned on every strided axis")
    if slopes is not None:
        slopes = slopes.contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    n_ctx, bs, n_kv = rows.shape[1], k_pool.shape[2], k_pool.shape[3]
    mode = regime(t, h // n_kv, q.dtype)
    n_split, split_keys = split_plan(n_ctx * bs)
    part_m = part_l = part_acc = None
    if mode == "split":  # fp32 scratch for the partials, merged by the second kernel
        rows_all = t * (h // n_kv)
        part_m = torch.empty((b, n_kv, rows_all, n_split), dtype=torch.float32, device=q.device)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((b, n_kv, rows_all, n_split, d), dtype=torch.float32,
                               device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.photon_rpa_launch(
            _MODES[mode], _DTYPES[q.dtype], d,
            q.data_ptr(), q.stride(0), q.stride(1),
            k_pool.data_ptr(), v_pool.data_ptr(),
            k_pool.stride(0), k_pool.stride(1), k_pool.stride(2), k_pool.stride(3),
            layer,
            rows.data_ptr(), rows.stride(0),
            positions.data_ptr(), positions.stride(0), positions.stride(1),
            None if slopes is None else slopes.data_ptr(), out.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (part_m, part_l, part_acc)),
            b, t, h, n_kv, n_ctx, bs, n_split, split_keys, scale, stream,
        )
    if err:
        msg = lib.photon_rpa_error_string(err).decode()
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: {msg} ({err})")
    launches += 1
    return out
