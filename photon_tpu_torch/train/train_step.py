"""The training step: microbatch accumulation, global-norm metrics, the
optimizer, and the causal-LM loss.

The port of ``photon_tpu/train/train_step.py``. JAX traces one pure
function; here the step runs eagerly and updates the parameters and the
optimizer state in place (the JAX step returns new arrays). With one
microbatch the gradients keep their parameters' dtypes (bf16 for a bf16
leaf); with more they are summed in fp32 and divided by their count, as
the JAX scan does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from photon_tpu_torch.codec.params import flatten
from photon_tpu_torch.models.mpt import MPTModel
from photon_tpu_torch.optim.build import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    """Carried across steps (and, later, across federated rounds)."""

    step: int
    params: dict  # the nested parameter tree (requires_grad leaves)
    opt_state: dict  # flat, under optax's names


def _output_embedding(model: MPTModel, params: dict) -> torch.Tensor:
    """``[vocab, d_model]`` output projection (tied ``wte`` or ``lm_head``)."""
    if model.cfg.tie_embeddings:
        return params["wte"]["embedding"]
    return params["lm_head"]["kernel"].T


class _ChunkedCE(torch.autograd.Function):
    """Sum of next-token CE over ``x [N, d]`` against ``w [V, d]`` in
    chunks of ``chunk`` rows: each chunk's ``[chunk, V]`` fp32 logits are
    made, reduced to per-row CE and dropped, and the backward makes them
    again, so the whole ``[N, V]`` tensor never exists. Only the rows' LSE
    is kept. The last chunk is shorter (the JAX version pads it and masks
    the pad, which gives the same sum). Logits are the compute-dtype
    product widened to fp32; the gradient of ``w`` is summed in fp32, and
    not made at all when ``w`` needs none (a LoRA fit's frozen embedding)."""

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for s in range(0, x.shape[0], chunk):
            logits = (x[s:s + chunk] @ w.T).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, targets[s:s + chunk, None])[:, 0]
            total += (lse - gold).sum()
            lses.append(lse)
        ctx.save_for_backward(x, w, targets, torch.cat(lses))
        ctx.chunk = chunk
        return total

    @staticmethod
    def backward(ctx, grad):
        x, w, targets, lse = ctx.saved_tensors
        dx = torch.empty_like(x)
        want_dw = ctx.needs_input_grad[1]
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) if want_dw else None
        for s in range(0, x.shape[0], ctx.chunk):
            xc, tc = x[s:s + ctx.chunk], targets[s:s + ctx.chunk]
            p = torch.exp((xc @ w.T).float() - lse[s:s + ctx.chunk, None])
            p[torch.arange(len(tc), device=p.device), tc] -= 1.0
            dl = (p * grad).to(x.dtype)
            dx[s:s + ctx.chunk] = dl @ w
            if want_dw:
                dw += (dl.T @ xc).float()
        return dx, dw.to(w.dtype) if want_dw else None, None, None


def _chunked_ce_sum(model: MPTModel, params: dict, hidden: torch.Tensor,
                    targets: torch.Tensor, chunk: int) -> torch.Tensor:
    d = hidden.shape[-1]
    w = _output_embedding(model, params).to(hidden.dtype)
    return _ChunkedCE.apply(hidden.reshape(-1, d), w, targets.reshape(-1), chunk)


def make_loss_fn(model: MPTModel, loss_chunk_tokens: int = 2048) -> Callable:
    def loss_fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross entropy over ``[B, S]`` token ids, plus
        the weighted MoE load-balance loss (0 for a dense model)."""
        if loss_chunk_tokens:
            hidden, aux = model(params, tokens, return_hidden=True, return_aux=True)
            ce_sum = _chunked_ce_sum(model, params, hidden[:, :-1], tokens[:, 1:],
                                     loss_chunk_tokens)
            return ce_sum / (tokens.shape[0] * (tokens.shape[1] - 1)) + aux
        logits, aux = model(params, tokens, return_aux=True)
        logits = logits[:, :-1]
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1)) + aux

    return loss_fn


def make_train_step(model: MPTModel, tx: Optimizer, n_microbatches: int = 1,
                    loss_chunk_tokens: int = 2048) -> Callable:
    """``(state, tokens [global_batch, seq]) -> (state, metrics)``: the
    batch splits into ``n_microbatches`` equal chunks whose gradients are
    averaged; then ``grad_norm`` (over every gradient computed), the
    optimizer, and ``param_norm`` of the updated parameters. Gradients are
    computed for the leaves that require one (:func:`init_train_state`
    turns that off for the frozen base of a LoRA fit, whose gradients the
    optimizer would drop: the JAX step computes them and its ``grad_norm``
    counts them, so under LoRA the two ``grad_norm`` metrics differ).
    Metrics are device scalars."""
    loss_fn = make_loss_fn(model, loss_chunk_tokens)

    def train_step(state: TrainState, tokens: torch.Tensor):
        b = tokens.shape[0]
        if b % n_microbatches:
            raise ValueError(f"batch {b} not divisible by {n_microbatches} microbatches")
        flat = flatten(state.params)
        names = [n for n, p in flat.items() if p.requires_grad]
        leaves = [flat[n] for n in names]
        loss_sum, grad_sum = None, None
        for mb in tokens.reshape(n_microbatches, b // n_microbatches, tokens.shape[1]):
            loss = loss_fn(state.params, mb)
            grads = torch.autograd.grad(loss, leaves)
            if grad_sum is None:
                # one microbatch: the gradients in their parameters' dtypes; more are
                # summed in fp32 from zeros, as the JAX scan does
                loss_sum = loss.detach().float()
                grad_sum = list(grads) if n_microbatches == 1 else [g.float() for g in grads]
            else:
                loss_sum += loss.detach()
                for acc, g in zip(grad_sum, grads):
                    acc += g
            del grads
        if n_microbatches > 1:
            loss_sum /= n_microbatches
            for g in grad_sum:
                g /= n_microbatches
        grad_norm = global_norm(grad_sum)  # before the optimizer clips them in place
        state.opt_state = tx.apply(dict(zip(names, grad_sum)), state.opt_state, flat)
        del grad_sum
        state.step += 1
        return state, {"loss": loss_sum, "grad_norm": grad_norm,
                       "param_norm": global_norm(flat.values()).detach()}

    return train_step


def make_eval_step(model: MPTModel, loss_chunk_tokens: int = 2048) -> Callable:
    """``(params, tokens) -> (sum_ce, n_tokens)`` for loss aggregation over
    eval batches (no MoE aux term, as in JAX)."""

    @torch.no_grad()
    def eval_step(params: dict, tokens: torch.Tensor):
        n_tok = tokens.shape[0] * (tokens.shape[1] - 1)
        if loss_chunk_tokens:
            hidden = model(params, tokens, return_hidden=True)
            return _chunked_ce_sum(model, params, hidden[:, :-1], tokens[:, 1:],
                                   loss_chunk_tokens), n_tok
        logits = model(params, tokens)[:, :-1]
        ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                             tokens[:, 1:].reshape(-1), reduction="sum")
        return ce, n_tok

    return eval_step


def init_train_state(tx: Optimizer, params: dict, freeze_grads: bool = False) -> TrainState:
    """A step-0 state over ``params`` (made leaves that require grad).
    ``freeze_grads`` (a LoRA fit): the leaves the optimizer freezes require
    none, so their weight gradients are never computed."""
    for name, p in flatten(params).items():
        p.requires_grad_(not freeze_grads or tx.trainable(name))
    return TrainState(step=0, params=params, opt_state=tx.init(flatten(params)))
