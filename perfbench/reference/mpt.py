"""Plain MPT in float32: the reference that decides ``correct``.

Written from MPT's description (llm-foundry's ``MPTForCausalLM`` as Photon
configures it): learned positions added to the token embedding; pre-norm
blocks of scale-only LayerNorm (eps 1e-5), a fused q/k/v projection,
causal softmax attention scaled by ``1/sqrt(d_head)``, an output
projection, and an MLP of ``expansion_ratio · d`` with GELU; a final
LayerNorm and the head tied to the token embedding; no biases. One
departure from llm-foundry, which the configuration states: its GELU is
the exact one, this system's is the tanh form (``ffn_act: gelu_tanh``).

Matrix products run in float32 with TF32 off (:func:`strict_fp32`). With
``precision="fp8"`` every product's operands are rounded to float8 E4M3
with a per-tensor scale (gradients to E5M2 on the way back): the control
that a lower precision has to fail. Nothing here imports the port or JAX.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NORM_EPS = 1e-5
_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def strict_fp32():
    """Float32 products with TF32 off, restored afterwards."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def _round8(x: torch.Tensor, dtype: torch.dtype, fmax: float) -> torch.Tensor:
    scale = fmax / x.detach().abs().amax().float().clamp(min=1e-30)
    return (x.float() * scale).to(dtype).float() / scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, _E5M2_MAX)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    if precision == "fp8":
        a, b = _FP8.apply(a), _FP8.apply(b)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return a.float() @ b.float()


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), scale.float(), None, NORM_EPS)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def hidden_states(p: dict, tokens: torch.Tensor, m: dict, precision: str = "fp32") -> torch.Tensor:
    """``[B, S]`` token ids at positions ``0 .. S-1`` -> the final norm's
    output ``[B, S, d]`` in float32. ``p`` is the flat tree
    (``perfbench/weights.py``'s names); leaves of any float dtype are read
    as float32."""
    b, s = tokens.shape
    d, h = m["d_model"], m["n_heads"]
    dh = d // h
    blk = "blocks/block/"
    x = p["wte/embedding"].float()[tokens] + p["wpe"].float()[:s][None]
    mask = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    for li in range(m["n_layers"]):
        hn = _ln(x, p[blk + "ln_1/scale"][li])
        qkv = matmul(hn, p[blk + "wqkv/kernel"][li], precision)
        q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
        scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        o = matmul(probs, v, precision).transpose(1, 2).reshape(b, s, d)
        x = x + matmul(o, p[blk + "out_proj/kernel"][li], precision)
        hn = _ln(x, p[blk + "ln_2/scale"][li])
        up = _gelu(matmul(hn, p[blk + "up_proj/kernel"][li], precision))
        x = x + matmul(up, p[blk + "down_proj/kernel"][li], precision)
    return _ln(x, p["ln_f/scale"])


def logits(p: dict, hidden: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    return matmul(hidden, p["wte/embedding"].transpose(0, 1), precision)


def loss_sum(p: dict, tokens: torch.Tensor, m: dict, precision: str = "fp32") -> torch.Tensor:
    """Summed next-token cross entropy over ``[B, S]`` rows."""
    z = logits(p, hidden_states(p, tokens, m, precision)[:, :-1], precision)
    return F.cross_entropy(z.reshape(-1, z.shape[-1]), tokens[:, 1:].reshape(-1),
                           reduction="sum")


def schedule(count: int, sched: dict, base_lr: float) -> float:
    """Cosine with linear warmup: ``base_lr · count / t_warmup`` first, then
    cosine down to ``alpha_f · base_lr`` at ``t_max``."""
    warm, t_max = sched["t_warmup"], max(sched["t_max"], sched["t_warmup"] + 1)
    if count < warm:
        return base_lr * count / warm
    frac = min(max((count - warm) / (t_max - warm), 0.0), 1.0)
    return base_lr * (sched["alpha_f"] + (1 - sched["alpha_f"]) * 0.5 * (1 + math.cos(math.pi * frac)))


def adopt_step(p: dict, g: dict, state: dict, count: int, opt: dict, sched: dict) -> None:
    """One step of global-norm clipping then ADOPT (Taniguchi et al.,
    2024), in place: the first step only sets ``v = g²``; later ones take
    ``m = b1 m + (1 - b1) clip(g / max(sqrt(v), eps), ±count^¼)``, move the
    weights by ``-lr(count) · m`` and then update ``v``."""
    norm = torch.sqrt(sum((t.double() ** 2).sum() for t in g.values())).float()
    clip = opt["grad_clip_norm"]
    if norm > clip:
        g = {n: t * (clip / norm) for n, t in g.items()}
    b1, b2 = opt["betas"]
    if count == 0:
        for n, t in g.items():
            state["v"][n] = t * t
            state["m"][n] = torch.zeros_like(t)
        return
    c = max(count, 1) ** 0.25
    lr = schedule(count, sched, opt["lr"])
    with torch.no_grad():
        for n, t in g.items():
            normed = (t / torch.clamp(state["v"][n].sqrt(), min=opt["eps"])).clamp(-c, c)
            state["m"][n] = b1 * state["m"][n] + (1 - b1) * normed
            p[n] -= lr * state["m"][n]
            state["v"][n] = b2 * state["v"][n] + (1 - b2) * t * t


def train_steps(p: dict, batches: list, m: dict, opt: dict, sched: dict, rows_per_pass: int,
                precision: str = "fp32") -> dict:
    """Run the optimizer over ``batches`` (each ``[B, S]`` on the device)
    from a float32 copy of the weights ``p``. Returns each step's
    mean loss, the first step's clipped gradient (each leaf's norm, as the
    optimizer gets it) and the weights after the steps. Rows go through in passes of
    ``rows_per_pass``, gradients summed."""
    p = {n: t.detach().float().clone().requires_grad_(True) for n, t in p.items()}
    state: dict = {"m": {}, "v": {}}
    losses, first = [], None
    for step, tokens in enumerate(batches):
        n_tok = tokens.shape[0] * (tokens.shape[1] - 1)
        total = torch.zeros((), dtype=torch.float64, device=tokens.device)
        grads = {n: torch.zeros_like(t, dtype=torch.float32) for n, t in p.items()}
        for r in range(0, tokens.shape[0], rows_per_pass):
            loss = loss_sum(p, tokens[r:r + rows_per_pass], m, precision)
            gs = torch.autograd.grad(loss, list(p.values()))
            for (n, acc), gr in zip(grads.items(), gs):
                acc += gr
            total += loss.detach().double()
            del loss, gs
        grads = {n: acc / n_tok for n, acc in grads.items()}
        losses.append(float(total / n_tok))
        with torch.no_grad():
            adopt_step(p, grads, state, step, opt, sched)
        if step == 0:
            first = {n: float(state["v"][n].sum().sqrt()) for n in p}
    return {"losses": losses, "first_grad_norms": first,
            "params": {n: t.detach() for n, t in p.items()}}


@torch.no_grad()
def token_logits(p: dict, ids: torch.Tensor, at: torch.Tensor, m: dict,
                 precision: str = "fp32") -> torch.Tensor:
    """Logits ``[len(at), V]`` of one sequence ``ids [S]`` at positions
    ``at``: the distribution of the token that follows each."""
    h = hidden_states(p, ids[None], m, precision)[0]
    return logits(p, h[at], precision)
