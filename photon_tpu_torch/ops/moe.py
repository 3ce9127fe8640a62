"""Mixture-of-Experts routing and the expert MLP, in torch.

The port of ``photon_tpu/ops/moe.py``, with the same semantics:

- router logits and softmax in fp32 (the router weight is read in fp32);
- top-k experts per token;
- a static capacity ``C = ceil(k·N·cf / E)`` slots per expert
  (:func:`expert_capacity`);
- capacity claimed **slot-major**: every token's first choice before any
  second choice, tokens in order within a slot, by the same cumsum over
  the ``[k·N, E]`` one-hot; an assignment at position ``>= C`` overflows
  and its token falls through the residual;
- gates renormalised over the kept slots (floor ``1e-9``);
- ``token_mask`` tokens claim nothing and leave the aux statistics;
- the Switch aux loss ``E · Σ_e f_e · P_e``, ``f`` from the top-1 choice
  (not differentiated), ``P`` the mean router probability;
- gelu (tanh) or SwiGLU experts.

Routing is batch-global: every token of one call competes for one
capacity pool, so a token's output depends on its batch-mates (the JAX
package's MoE caveat; serving MoE is best-effort there and here).

The JAX package dispatches densely: a ``[k, N, E, C]`` one-hot and the
``nec,nd->ecd`` / ``nec,ecd->nd`` einsums, the TPU formulation. At the
``mpt-125m-moe8`` microbatch (N = 16,384, E = 8, C = 5,120) that one-hot
alone is 1.34 G elements a layer, and the two einsums cost ~5× the
experts' own FLOPs. :func:`moe_mlp` computes the same function by index:
it builds the same positions and kept set, copies the kept tokens into an
``[E, C, D]`` buffer, runs the experts as batched matmuls over ``E`` and
gathers each token's ``<= k`` gated outputs back. Dispatch is an exact
selection, so only the order of the ``<= k``-term combine sum differs.
:func:`moe_mlp_plain` is the dense formulation itself, kept for the tests
and the card's dispatch gate; no model path calls it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Static per-expert slot count (>= 1), as the JAX package computes it."""
    return max(1, int(-(-top_k * n_tokens * capacity_factor // n_experts)))


def claim_positions(oh: torch.Tensor) -> torch.Tensor:
    """Each assignment's position in its expert's buffer, slot-major: the
    cumsum over ``oh [k, N, E]`` flattened to ``[k·N, E]`` (slot 0 of every
    token first), minus the assignment itself. The scan runs along each
    expert's contiguous ``[k·N]`` row: scanning the ``k·N`` axis of
    ``[k·N, E]`` in place leaves a GPU scan only ``E`` columns to spread."""
    k, n, e = oh.shape
    rows = oh.permute(2, 0, 1).reshape(e, k * n)
    return (torch.cumsum(rows, dim=1) - rows).reshape(e, k, n).permute(1, 2, 0)


@dataclass
class Routing:
    """Where each (slot, token) assignment goes: ``[k, N]`` each."""

    expert: torch.Tensor  # int64 chosen expert
    position: torch.Tensor  # int64 position in that expert's buffer
    kept: torch.Tensor  # bool: a slot below capacity (masked tokens: never)
    gates: torch.Tensor  # fp32, renormalised over the token's kept slots
    aux: torch.Tensor  # fp32 scalar, the Switch load-balance loss


def _aux_loss(probs: torch.Tensor, top1: torch.Tensor,
              token_mask: torch.Tensor | None) -> torch.Tensor:
    """``E · Σ_e f_e · P_e`` over the valid tokens; ``top1 [N, E]`` is the
    (masked) one-hot of each token's first choice."""
    n, e = probs.shape
    if token_mask is None:
        n_valid = float(n)
        p_sum = probs.sum(dim=0)
    else:
        m = token_mask.to(probs.dtype)
        n_valid = torch.clamp(m.sum(), min=1.0)
        p_sum = (probs * m[:, None]).sum(dim=0)
    f = top1.to(probs.dtype).sum(dim=0) / n_valid  # fraction routed (no gradient)
    p = p_sum / n_valid  # mean router probability (differentiable)
    return e * (f * p).sum()


def route(probs: torch.Tensor, top_k: int, capacity: int,
          token_mask: torch.Tensor | None = None) -> Routing:
    """The routing decision for router probabilities ``probs [N, E]``
    (fp32); ``token_mask [N]`` (nonzero = valid) keeps padding out of the
    capacity pool and the aux statistics."""
    n, e = probs.shape
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)  # [N, k]
    expert = gate_idx.T  # [k, N]
    oh = (expert[..., None] == torch.arange(e, device=expert.device)).to(torch.int32)  # [k, N, E]
    if token_mask is not None:
        token_mask = token_mask.reshape(n)
        oh = oh * (token_mask != 0).to(torch.int32)[None, :, None]
    pos = claim_positions(oh)
    at = expert[..., None]
    position = pos.gather(-1, at)[..., 0]
    kept = (oh.gather(-1, at)[..., 0] > 0) & (position < capacity)
    kept_gate = gate_vals.T * kept  # a dropped expert's weight goes to the kept ones
    gates = kept_gate / torch.clamp(kept_gate.sum(dim=0, keepdim=True), min=1e-9)
    return Routing(expert, position, kept, gates, _aux_loss(probs, oh[0], token_mask))


def _router_probs(xf: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    return torch.softmax(xf.float() @ router_w.float(), dim=-1)


def _experts(xin: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             w_gate: torch.Tensor | None) -> torch.Tensor:
    """``[E, C, D]`` → ``[E, C, D]``: each expert's FFN as one batched
    matmul over ``E`` (SwiGLU in the Mixtral layout, gate · up → down)."""
    up = torch.bmm(xin, w_up.to(xin.dtype))
    if w_gate is not None:
        h = F.silu(torch.bmm(xin, w_gate.to(xin.dtype))) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, w_down.to(xin.dtype))


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, *, top_k: int, capacity_factor: float,
            w_gate: torch.Tensor | None = None,
            token_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert MLP over ``x [..., D]`` (any leading dims; ``N`` is their
    product). ``router_w [D, E]``, ``w_up``/``w_gate [E, D, H]``, ``w_down
    [E, H, D]``. Returns ``(out [..., D] in x's dtype, aux)``.

    Each kept (slot, token) assignment owns one row ``expert·C + position``
    of an ``[E·C + 1, D]`` buffer (the last row takes the dropped ones and
    is never read); the gates are rounded to ``x``'s dtype, as the JAX
    package's combine tensor is, and each token's ``<= k`` terms are summed
    in fp32."""
    lead, d = x.shape[:-1], x.shape[-1]
    n = math.prod(lead)
    e = router_w.shape[-1]
    xf = x.reshape(n, d)
    cap = expert_capacity(n, e, top_k, capacity_factor)
    r = route(_router_probs(xf, router_w), top_k, cap, token_mask)
    row = torch.where(r.kept, r.expert * cap + r.position, e * cap).reshape(-1)  # [k·N]
    buf = xf.new_zeros((e * cap + 1, d)).index_copy(
        0, row, xf.expand(top_k, n, d).reshape(top_k * n, d))
    out_rows = _experts(buf[:-1].view(e, cap, d), w_up, w_down, w_gate).reshape(e * cap, d)
    out_rows = torch.cat([out_rows, out_rows.new_zeros((1, d))])
    picked = out_rows.index_select(0, row).view(top_k, n, d)
    g = r.gates.to(x.dtype).float()[..., None]
    out = (g * picked.float()).sum(dim=0).to(x.dtype)
    return out.reshape(*lead, d), r.aux


# ---------------------------------------------------------------------------
# the plain version: the JAX package's dense dispatch, line for line
# ---------------------------------------------------------------------------

def route_plain(probs: torch.Tensor, top_k: int, capacity: int,
                token_mask: torch.Tensor | None = None):
    """``photon_tpu.ops.moe.route``: ``(dispatch [N, E, C] {0, 1}, combine
    [N, E, C] gate weights, aux)`` from fp32 one-hots."""
    n, e = probs.shape
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    oh = F.one_hot(gate_idx.T, e).to(probs.dtype)  # [k, N, E]
    if token_mask is not None:
        token_mask = token_mask.reshape(n)
        oh = oh * token_mask.to(probs.dtype)[None, :, None]
    flat = oh.reshape(top_k * n, e)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(top_k, n, e).long()
    keep = oh * (pos < capacity)
    kept_gate = gate_vals * keep.sum(-1).T  # [N, k]
    gates = kept_gate / torch.clamp(kept_gate.sum(-1, keepdim=True), min=1e-9)
    # an out-of-range position one-hots to zeros, as jax.nn.one_hot does
    pos_oh = (pos[..., None] == torch.arange(capacity, device=pos.device)).to(probs.dtype)
    dispatch = torch.einsum("kne,knec->nec", keep, pos_oh)
    combine = torch.einsum("kn,kne,knec->nec", gates.T, keep, pos_oh)
    return dispatch, combine, _aux_loss(probs, oh[0], token_mask)


def moe_mlp_plain(x: torch.Tensor, router_w: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, *, top_k: int, capacity_factor: float,
                  w_gate: torch.Tensor | None = None,
                  token_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``photon_tpu.ops.moe.moe_mlp``: :func:`moe_mlp` through the dense
    dispatch and combine tensors (cast to ``x``'s dtype)."""
    lead, d = x.shape[:-1], x.shape[-1]
    n = math.prod(lead)
    e = router_w.shape[-1]
    xf = x.reshape(n, d)
    cap = expert_capacity(n, e, top_k, capacity_factor)
    dispatch, combine, aux = route_plain(_router_probs(xf, router_w), top_k, cap, token_mask)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xf)
    expert_out = _experts(expert_in, w_up, w_down, w_gate)
    out = torch.einsum("nec,ecd->nd", combine.to(x.dtype), expert_out)
    return out.reshape(*lead, d), aux
