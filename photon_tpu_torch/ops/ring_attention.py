"""Ring attention: exact context parallelism over the ``sequence`` mesh axis
(the port of ``photon_tpu/ops/ring_attention.py``).

Each position of the ring holds a contiguous sequence chunk of q/k/v. The
k/v chunks move one position along the ring a step (to the next
position's device), and each step's partial attention is merged with the
running result by its log-sum-exp (:func:`_merge_partials`): the same
function as full attention, with O(seq/n) keys live per position.

Ring step ``t`` on position ``my`` attends to chunk ``src = (my − t) % n``
at the global offsets ``q_start = my · s_local`` and ``k_start = src ·
s_local``. Under a causal mask a chunk with ``src > my`` lies wholly in
the query chunk's future, and its kernel is skipped, as JAX skips it: the
ring runs ``n(n+1)/2`` chunk kernels, not ``n²``. The inner chunk
attention is K1 at ``offset = q_start − k_start``
(:func:`~photon_tpu_torch.ops.flash_attention.flash_attention_with_lse`,
whose backward runs K2 and K3), or the dense :func:`xla_chunk_attention`
for ``impl="xla"``. ALiBi uses global positions and each head's slope
from the global table, on both routes (the JAX package's ring takes the
dense route under ALiBi; K1 takes the slopes at any offset).

:func:`ring_chunks` is the ring over one group of positions (lists of
per-position chunks, each on its position's device); the train step
(``parallel/spmd.py``) calls it per (batch, head) group. :func:`ring_attention`
takes global ``[b, s, h, d]`` tensors and a mesh, as JAX's does: it splits
them over the mesh, runs the ring in each group and concatenates; with no
ring axis it is the batch- and head-sharded flash path of
``ops/attention.py``.
"""

from __future__ import annotations

import torch

from photon_tpu_torch.ops.flash_attention import flash_attention_with_lse

NEG_INF = -1.0e30


def _merge_partials(o1, lse1, o2, lse2):
    """Combine two partial attention results (online-softmax merge).
    ``o_i [b, s, h, d]`` (each normalized within its own chunk), ``lse_i
    [b, s, h]`` fp32; fully-masked partials (lse ``NEG_INF``) weigh 0."""
    m = torch.maximum(lse1, lse2)
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    w1 = torch.where(lse1 > NEG_INF / 2, torch.exp(lse1 - m), zero)
    w2 = torch.where(lse2 > NEG_INF / 2, torch.exp(lse2 - m), zero)
    denom = w1 + w2
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / safe[..., None]
    lse = torch.where(denom == 0.0, torch.full_like(m, NEG_INF), m + torch.log(safe))
    return o.to(o1.dtype), lse


def xla_chunk_attention(q, k, v, *, q_start: int, k_start: int, causal: bool,
                        scale: float | None = None, alibi=False):
    """Per-chunk attention with a global-position causal mask; returns
    ``(o, lse)`` with fully-masked rows as ``(0, NEG_INF)``. q ``[b, sq, h,
    d]``, k/v ``[b, sk, h_kv, d]`` (grouped-query: q heads share kv rows);
    ``alibi`` is these heads' fp32 slopes ``[h]`` (the global table's
    slice), or True for all heads of a model of ``h`` heads: the bias uses
    global positions, so the merged ring equals full ALiBi attention."""
    from photon_tpu_torch.ops.attention import alibi_slopes

    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    g = h // h_kv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, sq, h_kv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_start
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :] + k_start
    if alibi is not None and alibi is not False:
        slopes = alibi_slopes(h, q.device) if alibi is True else alibi.to(q.device).float()
        dist = (q_pos - k_pos).float()
        s = s - slopes.reshape(h_kv, g)[None, :, :, None, None] * dist
    if causal:
        s = s.masked_fill(~(q_pos >= k_pos), NEG_INF)
    m = s.amax(-1, keepdim=True)
    masked_all = m <= NEG_INF / 2
    p = torch.where(masked_all, torch.zeros_like(s), torch.exp(s - torch.where(
        masked_all, torch.zeros_like(m), m)))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", (p / l_safe).to(v.dtype), v).reshape(b, sq, h, d)
    lse = torch.where(masked_all[..., 0], torch.full_like(m[..., 0], NEG_INF),
                      m[..., 0] + torch.log(l_safe[..., 0]))
    # lse: [b, h_kv, g, sq] → [b, sq, h]
    return o, lse.permute(0, 3, 1, 2).reshape(b, sq, h)


def _chunk_attn(q, k, v, *, q_start, k_start, causal, impl, slopes=None):
    if impl == "pallas":
        return flash_attention_with_lse(q, k, v, causal=causal, q_start=q_start,
                                        k_start=k_start, slopes=slopes)
    return xla_chunk_attention(q, k, v, q_start=q_start, k_start=k_start, causal=causal,
                               alibi=slopes if slopes is not None else False)


def ring_chunks(qs: list, ks: list, vs: list, *, causal: bool = True, impl: str = "pallas",
                slopes: torch.Tensor | None = None) -> list:
    """The ring over one group of ``n`` positions: ``qs[r]``, ``ks[r]``,
    ``vs[r]`` are position ``r``'s chunks ``[b, s_local, h, d]`` (k/v at
    their grouped width), each on its position's device; returns each
    position's output chunk on its device. ``slopes``: these heads' ALiBi
    slopes (global table), or None."""
    n = len(qs)
    s_local = qs[0].shape[1]
    devs = [q.device for q in qs]
    outs, lses = [None] * n, [None] * n
    k_held, v_held = list(ks), list(vs)
    for t in range(n):
        for my in range(n):
            src = (my - t) % n
            if causal and src > my:
                continue  # the whole chunk is in this query chunk's future
            o_c, lse_c = _chunk_attn(qs[my], k_held[my], v_held[my], q_start=my * s_local,
                                     k_start=src * s_local, causal=causal, impl=impl,
                                     slopes=None if slopes is None else slopes.to(devs[my]))
            if outs[my] is None:
                outs[my], lses[my] = o_c, lse_c
            else:
                outs[my], lses[my] = _merge_partials(outs[my], lses[my], o_c, lse_c)
        if t + 1 < n:  # each position hands its k/v to the next one
            k_held = [k_held[(r - 1) % n].to(devs[r]) for r in range(n)]
            v_held = [v_held[(r - 1) % n].to(devs[r]) for r in range(n)]
    return outs


def ring_attention(q, k, v, mesh, *, causal: bool = True, impl: str = "pallas",
                   axis_name: str | None = "sequence", batch_axes: tuple = ("data", "fsdp"),
                   head_axis: str = "tensor", alibi: bool = False) -> torch.Tensor:
    """Exact attention over global ``[b, s, h, d]`` inputs, sequence-split
    over ``mesh``'s ``axis_name``: the batch splits over ``batch_axes``,
    the heads over ``head_axis`` when it divides both head counts (else
    they stay whole), and each group of positions runs :func:`ring_chunks`
    on its positions' devices. k/v may carry fewer heads than q (they ride
    the ring at that width). ``alibi``: global positions, global slopes.
    ``axis_name=None`` splits no sequence: each group is one chunk on its
    first position's device (the batch- and head-sharded flash path of
    ``ops/attention.py``). Returns the output on q's device."""
    from photon_tpu_torch.ops.attention import alibi_slopes
    from photon_tpu_torch.parallel.sharding import position_coords

    n_ring = mesh.shape[axis_name] if axis_name else 1
    b, s_global, h, _ = q.shape
    h_kv = k.shape[2]
    if h % h_kv or v.shape[2] != h_kv:
        raise ValueError(f"bad GQA head split: q {h}, k {h_kv}, v {v.shape[2]}")
    slopes_full = alibi_slopes(h, q.device) if alibi else None
    if s_global % n_ring:
        raise ValueError(f"seq {s_global} not divisible by ring size {n_ring}")
    n_t = mesh.shape.get(head_axis, 1)
    n_t = n_t if h % n_t == 0 and h_kv % n_t == 0 else 1
    n_b = 1
    for a in batch_axes:
        n_b *= mesh.shape.get(a, 1)
    if b % n_b:
        raise ValueError(f"batch {b} not divisible by the batch axes' {n_b} positions")
    s_loc, b_loc, h_loc, hkv_loc = s_global // n_ring, b // n_b, h // n_t, h_kv // n_t
    groups: dict[tuple, list] = {}  # (batch index, head index) → devices by ring index
    for c, dev in zip(position_coords(mesh), mesh.devices.flat):
        bi = 0
        for a in batch_axes:
            bi = bi * mesh.shape.get(a, 1) + c.get(a, 0)
        ti = c[head_axis] if n_t > 1 else 0
        ring = groups.setdefault((bi, ti), [None] * n_ring)
        r = c[axis_name] if axis_name else 0
        if ring[r] is None:
            ring[r] = torch.device(dev)
    pieces: dict[tuple, torch.Tensor] = {}
    for (bi, ti), devs in sorted(groups.items()):
        bs, hs = slice(bi * b_loc, (bi + 1) * b_loc), slice(ti * h_loc, (ti + 1) * h_loc)
        kvs = slice(ti * hkv_loc, (ti + 1) * hkv_loc)
        chunk = [slice(r * s_loc, (r + 1) * s_loc) for r in range(n_ring)]
        outs = ring_chunks(
            [q[bs, sl, hs].to(d) for sl, d in zip(chunk, devs)],
            [k[bs, sl, kvs].to(d) for sl, d in zip(chunk, devs)],
            [v[bs, sl, kvs].to(d) for sl, d in zip(chunk, devs)],
            causal=causal, impl=impl,
            slopes=None if slopes_full is None else slopes_full[hs])
        pieces[bi, ti] = torch.cat([x.to(q.device) for x in outs], dim=1)
    return torch.cat([torch.cat([pieces[bi, ti] for ti in range(n_t)], dim=2)
                      for bi in range(n_b)], dim=0)
